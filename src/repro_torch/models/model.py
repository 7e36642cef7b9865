"""Model assembly for the serving slice — ports of
``src/repro/models/model.py``: full-sequence forward, paged prefill,
paged decode, page invalidation, and the paged pool allocation.

Layers run as a Python loop over ``ModelParams.layers`` (the reference
scans stacked groups).  Paged pools are a list with one
``{"k", "v", "pos"}`` dict per layer and are updated in place.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import blocks as B
from repro_torch.models import capabilities as caps
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    embed_apply,
    head_weight,
    logits_apply,
    rmsnorm,
)


def forward_hidden(params, cfg: ModelConfig, tokens: torch.Tensor, *,
                   lengths: Optional[torch.Tensor] = None,
                   collect_cache: bool = False):
    """tokens: (B, T) int at positions 0..T-1; ``lengths`` (B,) masks keys
    past each row's valid length.  Returns (hidden (B, T, D) after the
    final norm, per-layer [{"k", "v"}] caches or None)."""
    bsz, t = tokens.shape
    x = embed_apply(params.embed, tokens)
    positions = torch.arange(t, device=tokens.device)[None].expand(bsz, t)
    caches = []
    for p in params.layers:
        x, entry = B.block_apply(cfg, p, x, positions=positions,
                                 lengths=lengths, collect_cache=collect_cache)
        caches.append(entry)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return x, (caches if collect_cache else None)


@torch.no_grad()
def paged_prefill(params, cfg: ModelConfig, tokens: torch.Tensor, *,
                  prefill_len: Optional[torch.Tensor] = None):
    """Prompt prefill for the paged engine.  tokens: (B, T), right-padded
    past ``prefill_len`` (B,).  Returns (last_logits (B, V) f32, raw
    per-layer [{"k"/"v": (B, T, KV, Dh)}] roped projections) — the engine
    scatters the raw K/V into pool pages shared by a group's siblings."""
    caps.check_paged(cfg)
    bsz, t = tokens.shape
    if prefill_len is None:
        prefill_len = torch.full((bsz,), t, dtype=torch.int32,
                                 device=tokens.device)
    hidden, raw = forward_hidden(params, cfg, tokens, lengths=prefill_len,
                                 collect_cache=True)
    idx = (prefill_len.long() - 1).clamp(min=0)
    last_h = hidden[torch.arange(bsz, device=hidden.device), idx][:, None]
    return logits_apply(head_weight(params), last_h)[:, 0], raw


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, cache: list,
                pos: torch.Tensor, *, block_tables: torch.Tensor,
                write_page: torch.Tensor,
                write_off: torch.Tensor) -> torch.Tensor:
    """One decode step over the paged pools.  tokens: (S,) int; pos: (S,)
    absolute position of the NEW token; each layer writes it at its pool's
    ``[write_page, write_off]`` cell (``write_page == num_pages`` drops the
    write into the spare page) and attends through the shared block
    tables.  ``cache`` is updated in place.  Returns logits (S, V) f32."""
    x = embed_apply(params.embed, tokens[:, None])
    paged = {"block_tables": block_tables, "write_page": write_page,
             "write_off": write_off}
    for p, pool in zip(params.layers, cache):
        x = B.block_decode(cfg, p, x, pool, pos, paged=paged)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return logits_apply(head_weight(params), x)[:, 0]


def invalidate_pages(cache: list, page_mask: torch.Tensor) -> None:
    """Poison the masked pages of every pool in place: ``page_mask``
    (num_pages,) bool pages get ``pos = -1`` — invisible to every block
    table until rewritten.  The engine applies it to pages returned to the
    free list before they can be reallocated, so a recycled page never
    leaks its previous occupant's positions.  K/V bytes stay: an entry
    with ``pos = -1`` is unreachable."""
    n = page_mask.shape[0]
    for pool in cache:
        pool["pos"][:n].masked_fill_(page_mask[:, None], -1)


def paged_cache_init(cfg: ModelConfig, *, num_pages: int, page_len: int,
                     dtype: torch.dtype, device) -> list:
    """Zeroed paged pools, one per layer, every entry pos-poisoned (-1).
    Each pool holds ``num_pages`` pages that block tables may name plus
    one spare page that absorbs dropped writes (see ``attention.py``)."""
    caps.check_paged(cfg)
    shape = (num_pages + 1, page_len, cfg.n_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device),
             "pos": torch.full(shape[:2], -1, dtype=torch.int32,
                               device=device)}
            for kind in cfg.layer_kinds if caps.pool_resident(
                cfg.mixer_of(kind))]
