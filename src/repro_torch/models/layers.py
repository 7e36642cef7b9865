"""Shared primitive layers: RMSNorm, RoPE, the SwiGLU MLP, embeddings and
the f32 logits head — ports of ``src/repro/models/layers.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32 with the ``(1 + scale)`` convention (zero-init scale
    keeps init statistics), cast back to x's dtype."""
    xf = x.to(F32)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(F32))).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    d2 = head_dim // 2
    exps = torch.arange(d2, dtype=F32, device=device) / d2
    return 1.0 / torch.pow(torch.tensor(theta, dtype=F32, device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Split-half (not interleaved) rotary embedding.  x: (..., T, H, D) with
    D even; positions broadcastable to (..., T)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (D/2,)
    ang = positions[..., None].to(F32) * freqs                # (..., T, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.to(F32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_apply(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (silu(x W_gate) * x W_up) W_down."""
    h = F.silu(x @ p.w_gate) * (x @ p.w_up)
    return h @ p.w_down


def embed_apply(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, T) -> (B, T, D)."""
    return table[tokens.long()]


def head_weight(params) -> torch.Tensor:
    """(D, V) output projection: the head matrix, or the transposed
    embedding table when embeddings are tied."""
    return params.embed.t() if params.head is None else params.head


def logits_apply(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x (B, T, D) -> (B, T, V) f32 logits.  The product is never rounded
    to a narrower type, as with the reference's ``preferred_element_type=
    f32`` einsum: bf16 operands on the card take cuBLAS's f32-output GEMM
    (no f32 copy of the (D, V) head); elsewhere the operands are upcast."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda and x.dtype == w.dtype == torch.bfloat16:
        out = torch.mm(x2, w, out_dtype=F32)
    else:
        out = x2.to(F32) @ w.to(F32)
    return out.reshape(*lead, w.shape[-1])
