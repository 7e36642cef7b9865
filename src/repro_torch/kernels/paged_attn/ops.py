"""Wrapper for the paged decode kernel.

``paged_attention(q, k_pages, v_pages, pos_pages, block_tables, q_pos)``
takes q in the model's flat-head decode layout ``(S, H, D)`` and does the
GQA regrouping around the kernel's ``(S, KV, G, D)`` layout: query head
``h`` reads kv head ``h // (H // KV)`` — the mapping ``repeat_kv``
realizes on the dense path, without repeating KV in memory.

For CUDA tensors it launches the CUDA kernel (``csrc/paged_decode.cu``)
on PyTorch's current stream and counts the launch in
``paged_attention.launches``; for CPU tensors it runs the plain version
(``ref.py``).  Tensors on mixed devices, or of a type or shape the kernel
does not take, raise.  Decode is never differentiated: no backward.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attn.ref import paged_attention_ref

SOURCE = "paged_attn/csrc/paged_decode.cu"   # relative to kernels/
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 232_448          # bytes of shared memory one Hopper block can use


def _lib():
    lib = _build.load(SOURCE)
    if lib.paged_decode.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_decode.argtypes = [p] * 7 + [i] * 7 + [ctypes.c_float, p]
        lib.paged_decode.restype = i
        lib.paged_decode_smem_bytes.argtypes = [i, i, i]
        lib.paged_decode_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check(q, k_pages, v_pages, pos_pages, block_tables, q_pos):
    s, h, d = q.shape
    p, pl, kvh, dk = k_pages.shape
    if v_pages.shape != k_pages.shape or dk != d:
        raise ValueError(f"k/v pages {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)} do not match q {tuple(q.shape)}")
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")
    if pos_pages.shape != (p, pl):
        raise ValueError(f"pos_pages {tuple(pos_pages.shape)} != {(p, pl)}")
    if block_tables.ndim != 2 or block_tables.shape[0] != s:
        raise ValueError(f"block_tables {tuple(block_tables.shape)} for {s} slots")
    if q_pos.shape != (s,):
        raise ValueError(f"q_pos {tuple(q_pos.shape)} for {s} slots")
    for name, t in (("pos_pages", pos_pages), ("block_tables", block_tables),
                    ("q_pos", q_pos)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if not q.dtype == k_pages.dtype == v_pages.dtype:
        raise TypeError(f"q, k_pages and v_pages must share a dtype, got "
                        f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}")


def paged_attention(q, k_pages, v_pages, pos_pages, block_tables, q_pos):
    """q: (S, H, D) flat query heads; k_pages/v_pages: (P, page_len, KV, D);
    pos_pages: (P, page_len) int32; block_tables: (S, M) int32; q_pos: (S,)
    int32.  q and the pages share one dtype.  Returns out (S, H, D) in
    that dtype."""
    _check(q, k_pages, v_pages, pos_pages, block_tables, q_pos)
    s, h, d = q.shape
    kvh = k_pages.shape[2]
    g = h // kvh
    args = (q, k_pages, v_pages, pos_pages, block_tables, q_pos)
    devices = {t.device for t in args}
    if len(devices) != 1:
        raise ValueError(f"paged_attention: tensors on several devices "
                         f"{sorted(map(str, devices))}")
    dev = q.device
    if dev.type == "cpu":
        return paged_attention_ref(q.reshape(s, kvh, g, d), k_pages, v_pages,
                                   pos_pages, block_tables,
                                   q_pos).reshape(s, h, d)
    if dev.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not {dev}")
    for name, t in zip(("q", "k_pages", "v_pages", "pos_pages",
                        "block_tables", "q_pos"), args):
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    if s > 65535:
        raise ValueError(f"{s} slots exceed the kernel's grid (65535)")
    lib = _lib()
    pl_ = k_pages.shape[1]
    if lib.paged_decode_smem_bytes(g, d, pl_) > _MAX_SMEM:
        raise ValueError(f"G={g}, D={d}, page_len={pl_} need more shared "
                         "memory than one block has")
    out = torch.empty_like(q)
    err = lib.paged_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        pos_pages.data_ptr(), block_tables.data_ptr(), q_pos.data_ptr(),
        out.data_ptr(), s, kvh, g, d, pl_, block_tables.shape[1],
        _DTYPE_CODE[q.dtype], 1.0 / math.sqrt(d), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode launch failed: cudaError {err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
