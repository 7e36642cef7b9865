"""Global GQA self-attention for prefill, and decode against the paged KV
pool — ports of ``src/repro/models/attention.py``.

Prefill attention stays a plain einsum + softmax, as in the reference;
decode attention over the pool goes through the paged kernel's wrapper
(``kernels/paged_attn``), which launches the CUDA kernel for CUDA tensors.

Unlike the reference's pure functions, the pool is updated in place.
A pool holds one spare page past the ``P`` pages block tables may name:
the drop sentinel ``write_page == P`` of inactive slots writes there, so
dropping a write needs no boolean-mask scatter (which would synchronise
the host with the card once per layer and substep).  No block table ever
names the spare page, so what lands there is never read.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.paged_attn import paged_attention
from repro_torch.models.layers import apply_rope

F32 = torch.float32
NEG_INF = -2.0 ** 30  # large-but-finite; keeps softmax NaN-free on empty rows


def repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, KV, D) -> (B, S, KV*groups, D)."""
    if groups == 1:
        return k
    b, s, kv, d = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, groups, d).reshape(
        b, s, kv * groups, d)


def sdpa(q, k, v, mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """q: (B, T, H, D), k/v: (B, S, H, D), mask broadcastable to (B, H, T, S).
    Scores and softmax in f32; probabilities cast to v's dtype."""
    s = torch.einsum("bthd,bshd->bhts", q.to(F32), k.to(F32)) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bshd->bthd", p.to(v.dtype), v)


def causal_window_mask(t: int, s: int, device=None) -> torch.Tensor:
    """(T, S) causal mask: query i sees keys j <= i.  (The reference's
    sliding-window and offset arguments belong to mixers not ported yet.)"""
    qi = torch.arange(t, device=device)[:, None]
    kj = torch.arange(s, device=device)[None, :]
    return kj <= qi


def _project(p, x):
    """x (B, T, D) -> roped-later q (B, T, H, Dh), k/v (B, T, KV, Dh)."""
    d = x.shape[-1]
    h, dh = p.wq.shape[1], p.wq.shape[2]
    kv = p.wk.shape[1]
    lead = x.shape[:-1]
    q = (x @ p.wq.reshape(d, h * dh)).reshape(*lead, h, dh)
    k = (x @ p.wk.reshape(d, kv * dh)).reshape(*lead, kv, dh)
    v = (x @ p.wv.reshape(d, kv * dh)).reshape(*lead, kv, dh)
    return q, k, v


def _out(p, o):
    """o (B, T, H, Dh) -> (B, T, D) through wo."""
    h, dh, d = p.wo.shape
    return o.reshape(*o.shape[:-2], h * dh) @ p.wo.reshape(h * dh, d)


def self_attention(p, x, positions, *, rope_theta: float,
                   lengths: Optional[torch.Tensor] = None):
    """Full-sequence causal self-attention (prefill).  ``lengths`` (B,)
    masks keys past each sequence's valid length.  Returns
    (out (B, T, D), (k, v)) with k/v the roped projections (B, T, KV, Dh)."""
    t = x.shape[1]
    h, dh = p.wq.shape[1], p.wq.shape[2]
    kv = p.wk.shape[1]
    q, k, v = _project(p, x)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    mask = causal_window_mask(t, t, device=x.device)[None, None]
    if lengths is not None:
        mask = mask & (torch.arange(t, device=x.device)[None, None, None, :]
                       < lengths[:, None, None, None])
    o = sdpa(q, repeat_kv(k, h // kv), repeat_kv(v, h // kv), mask,
             1.0 / math.sqrt(dh))
    return _out(p, o), (k, v)


def paged_cache_update(pool: dict, k, v, pos, write_page, write_off) -> None:
    """Write one token's K/V per slot into its private decode page, in place.

    pool: {"k"/"v": (P + 1, page_len, KV, D), "pos": (P + 1, page_len)}.
    k/v: (S, 1, KV, D) roped projections; pos: (S, 1) absolute positions;
    write_page/write_off: (S,) int — ``write_page == P`` is the drop
    sentinel for inactive slots (it lands in the spare page).  Distinct
    live slots always name distinct pages (decode pages are slot-private,
    prompt pages are never written after prefill), so the scatter has no
    conflicts."""
    wp, wo = write_page.long(), write_off.long()
    pool["k"][wp, wo] = k[:, 0].to(pool["k"].dtype)
    pool["v"][wp, wo] = v[:, 0].to(pool["v"].dtype)
    pool["pos"][wp, wo] = pos[:, 0].to(torch.int32)


def gather_pages(pool: dict, block_tables: torch.Tensor):
    """Materialize each slot's logical KV sequence through its block table.

    block_tables: (S, M) page ids, ``-1`` = unallocated (gathered entries
    come back with ``pos = -1`` so they are invisible).  Returns
    (k (S, M*page_len, KV, D), v, pos (S, M*page_len))."""
    s, m = block_tables.shape
    bt = block_tables.clamp(min=0).long()
    kg = pool["k"][bt]
    vg = pool["v"][bt]
    posg = pool["pos"][bt]
    posg = torch.where(block_tables[..., None] >= 0, posg,
                       torch.full_like(posg, -1))
    pl_ = posg.shape[-1]
    return (kg.reshape(s, m * pl_, *kg.shape[3:]),
            vg.reshape(s, m * pl_, *vg.shape[3:]),
            posg.reshape(s, m * pl_))


def paged_decode_attention(p, x, pool: dict, pos, block_tables, write_page,
                           write_off, *, rope_theta: float) -> torch.Tensor:
    """One-token decode against the paged KV pool.  x: (S, 1, D); pos (S,)
    absolute position of the new token.  Writes the token's K/V into the
    pool (in place), then attends through the block tables with the paged
    kernel's wrapper.  Returns out (S, 1, D)."""
    b = x.shape[0]
    q, k, v = _project(p, x)
    posb = pos.reshape(b, 1).to(torch.int32)
    q = apply_rope(q, posb, rope_theta)
    k = apply_rope(k, posb, rope_theta)
    paged_cache_update(pool, k, v, posb, write_page, write_off)
    o = paged_attention(q[:, 0].contiguous(), pool["k"], pool["v"],
                        pool["pos"], block_tables, posb[:, 0].contiguous())
    return _out(p, o[:, None])
