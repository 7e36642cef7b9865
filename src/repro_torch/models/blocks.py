"""Block-level glue for the ``attn`` mixer with a SwiGLU MLP — ports of
``block_apply`` / ``block_decode`` in ``src/repro/models/blocks.py``.

A block = pre-norm mixer + residual, then pre-norm MLP + residual."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mlp_apply, rmsnorm


def block_apply(cfg: ModelConfig, p, x: torch.Tensor, *,
                positions: torch.Tensor, lengths: Optional[torch.Tensor],
                collect_cache: bool):
    """Full-sequence application.  Returns (x, cache_entry_or_None) where a
    cache entry is this layer's roped {"k", "v"} (B, T, KV, Dh)."""
    h = rmsnorm(p.ln1, x, cfg.norm_eps)
    out, (k, v) = attn.self_attention(p.mixer, h, positions,
                                      rope_theta=cfg.rope_theta,
                                      lengths=lengths)
    x = x + out
    x = x + mlp_apply(p.mlp, rmsnorm(p.ln2, x, cfg.norm_eps))
    return x, ({"k": k, "v": v} if collect_cache else None)


def block_decode(cfg: ModelConfig, p, x: torch.Tensor, pool: dict,
                 pos: torch.Tensor, *, paged: dict) -> torch.Tensor:
    """One-token decode against this layer's paged pool (updated in place).
    x: (S, 1, D); ``paged`` holds ``block_tables`` (S, M) and
    ``write_page`` / ``write_off`` (S,).  Returns x."""
    h = rmsnorm(p.ln1, x, cfg.norm_eps)
    out = attn.paged_decode_attention(
        p.mixer, h, pool, pos, paged["block_tables"], paged["write_page"],
        paged["write_off"], rope_theta=cfg.rope_theta)
    x = x + out
    return x + mlp_apply(p.mlp, rmsnorm(p.ln2, x, cfg.norm_eps))
