"""Parameters of a dense GQA + SwiGLU model as ``nn.Module`` containers.

Each tensor keeps the reference's einsum layout (``src/repro/models/``:
``wq (D, H, Dh)``, ``wo (H, Dh, D)``, ``w_gate (D, F)``, ...), so a
converted JAX tree is a plain copy and the forward functions in
``layers.py`` / ``attention.py`` read like their JAX counterparts.  The
reference stacks layers under ``group{gi}/l{j}`` with a leading repeat axis
(``models/model.py::model_decl``); here every layer is its own
``BlockParams`` in execution order.

Parameters never require grad: the serving slice does not train.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.models import capabilities as caps
from repro_torch.models.config import ModelConfig

_NORMS = ("ln1", "ln2", "final_norm")


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class AttnParams(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = _param((d, h, dh), dtype, device)
        self.wk = _param((d, kv, dh), dtype, device)
        self.wv = _param((d, kv, dh), dtype, device)
        self.wo = _param((h, dh, d), dtype, device)


class MlpParams(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w_gate = _param((d, f), dtype, device)
        self.w_up = _param((d, f), dtype, device)
        self.w_down = _param((f, d), dtype, device)


class BlockParams(nn.Module):
    """Pre-norm attention block: ``ln1`` -> mixer -> residual, ``ln2`` ->
    SwiGLU MLP -> residual (``src/repro/models/blocks.py::block_decl``)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = _param((cfg.d_model,), dtype, device)
        self.mixer = AttnParams(cfg, dtype, device)
        self.ln2 = _param((cfg.d_model,), dtype, device)
        self.mlp = MlpParams(cfg, dtype, device)


class ModelParams(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        caps.check_paged(cfg)
        device = resolve_device(device)
        self.embed = _param((cfg.vocab_size, cfg.d_model), dtype, device)
        self.final_norm = _param((cfg.d_model,), dtype, device)
        self.head: Optional[nn.Parameter] = (
            None if cfg.tie_embeddings
            else _param((cfg.d_model, cfg.vocab_size), dtype, device))
        self.layers = nn.ModuleList(
            BlockParams(cfg, dtype, device) for _ in range(cfg.n_layers))

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _init_std(name: str, shape) -> Optional[float]:
    """The reference's init rule (``models/params.py::_init_one``): norm
    scales start at zero (the norm applies ``1 + scale``), the embedding
    table is N(0, 1), every other matrix is N(0, 1/fan_in) with fan_in the
    product of all dims but the last (the einsum input dims)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in _NORMS:
        return None
    if leaf == "embed":
        return 1.0
    return 1.0 / math.sqrt(max(math.prod(shape[:-1]), 1))


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", dtype=torch.bfloat16) -> ModelParams:
    """Random parameters drawn from ``generator`` (which must live on
    ``device``) by the reference's init rule.  Tensors are drawn one at a
    time in f32 and cast, so a full-width init holds one f32 temporary of
    one matrix, never a stacked (layers, ...) one."""
    params = ModelParams(cfg, dtype=dtype, device=device)
    for name, p in params.named_parameters():
        std = _init_std(name, p.shape)
        if std is None:
            p.zero_()
        else:
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device, dtype=torch.float32) * std)
    return params


def _to_torch(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        # torch.from_numpy rejects ml_dtypes' bfloat16; f32 holds every
        # bf16 value exactly, so the detour is lossless
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


@torch.no_grad()
def params_from_jax(np_tree: dict, cfg: ModelConfig,
                    device="cuda") -> ModelParams:
    """Convert the reference's parameter tree (numpy or JAX leaves) into
    ``ModelParams``.  Stacked ``group{gi}/l{j}`` leaves with a leading
    repeat axis are unstacked in execution order: group by group, repeat
    by repeat, pattern position by pattern position."""
    device = resolve_device(device)
    dtype = _to_torch(np_tree["embed"]["table"], "cpu").dtype
    params = ModelParams(cfg, dtype=dtype, device=device)
    params.embed.copy_(_to_torch(np_tree["embed"]["table"], device))
    params.final_norm.copy_(_to_torch(np_tree["final_norm"]["scale"], device))
    if params.head is not None:
        params.head.copy_(_to_torch(np_tree["head"]["w"], device))
    li = 0
    for gi, (pattern, repeat) in enumerate(cfg.blocks):
        grp = np_tree[f"group{gi}"]
        for r in range(repeat):
            for j in range(len(pattern)):
                src = grp[f"l{j}"]
                blk = params.layers[li]
                blk.ln1.copy_(_to_torch(np.asarray(src["ln1"]["scale"])[r],
                                        device))
                blk.ln2.copy_(_to_torch(np.asarray(src["ln2"]["scale"])[r],
                                        device))
                for key in ("wq", "wk", "wv", "wo"):
                    getattr(blk.mixer, key).copy_(_to_torch(
                        np.asarray(src["mixer"][key])[r], device))
                for key in ("w_gate", "w_up", "w_down"):
                    getattr(blk.mlp, key).copy_(_to_torch(
                        np.asarray(src["mlp"][key])[r], device))
                li += 1
    return params
