"""Plain PyTorch version of paged decode attention — the CUDA kernel's
oracle, and what the wrapper runs for tensors on the CPU.

Semantics (``src/repro/kernels/paged_attn/ref.py::paged_attention_ref``):
  * a slot's logical KV sequence is the concatenation of the pages named
    by its ``block_tables`` row, in row order; ``-1`` entries are
    unallocated and every position of such a page is invisible,
  * key j is visible to the slot's query iff ``0 <= pos_j <= q_pos``,
  * slots with ``q_pos < 0`` are inactive and output exactly 0.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def paged_attention_ref(q, k_pages, v_pages, pos_pages, block_tables, q_pos):
    """q: (S, KV, G, D) — G query heads per kv head (GQA grouping);
    k_pages/v_pages: (P, page_len, KV, D); pos_pages: (P, page_len) int32;
    block_tables: (S, M) int32 page ids (-1 = unallocated); q_pos: (S,)
    int32 absolute query positions (-1 = inactive slot).

    Upcasts to f32 and decomposes like the kernel (masked max-subtract,
    explicit denominator).  Value rows that are not visible are zeroed
    before the value product, so NaN bytes in empty pool entries cannot
    leak into the output through ``0 * NaN``.  Returns out (S, KV, G, D)
    in q's dtype."""
    s, kv, g, d = q.shape
    pl = pos_pages.shape[1]
    m = block_tables.shape[1]
    named = block_tables >= 0
    bt = block_tables.clamp(min=0).long()
    kg = k_pages[bt].reshape(s, m * pl, kv, d).to(F32)
    vg = v_pages[bt].reshape(s, m * pl, kv, d).to(F32)
    posg = torch.where(named[..., None], pos_pages[bt],
                       torch.full_like(pos_pages[bt], -1)).reshape(s, m * pl)
    qp = q_pos[:, None]
    valid = (posg >= 0) & (posg <= qp) & (qp >= 0)            # (S, L)

    sc = torch.einsum("skgd,slkd->skgl", q.to(F32), kg) * (1.0 / math.sqrt(d))
    sc = sc.masked_fill(~valid[:, None, None, :], -math.inf)
    mx = sc.amax(dim=-1)
    mx_safe = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    pr = torch.exp(sc - mx_safe[..., None])
    pr = pr.masked_fill(~valid[:, None, None, :], 0.0)
    l = pr.sum(dim=-1)
    vg = vg.masked_fill(~valid[:, :, None, None], 0.0)
    o = torch.einsum("skgl,slkd->skgd", pr, vg)
    o = o / l.clamp(min=1e-30)[..., None]
    o = torch.where((l > 0)[..., None], o, torch.zeros_like(o))
    return o.to(q.dtype)
