"""Paged decode attention over a block-table KV pool: the CUDA kernel that
replaces ``src/repro/kernels/paged_attn/kernel.py::paged_decode_pallas``,
its wrapper, and its plain PyTorch version."""
from repro_torch.kernels.paged_attn.ops import paged_attention
from repro_torch.kernels.paged_attn.ref import paged_attention_ref

__all__ = ["paged_attention", "paged_attention_ref"]
