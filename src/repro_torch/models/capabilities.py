"""Capability table, reduced to the serving slice.

The reference (``src/repro/models/capabilities.py``) keeps one row per
mixer kind saying which layouts and engines it supports.  The port has
ported the global-attention mixer (``attn``) with the SwiGLU MLP only;
every other mixer raises ``CapabilityError`` naming the ROADMAP item that
will bring it, instead of failing deep inside a forward pass."""
from __future__ import annotations

from repro_torch.models.config import ModelConfig

# mixers of the reference not ported yet -> the ROADMAP item that ports them
_NOT_PORTED = {
    kind: "ROADMAP.md queue 1 item 4 (MLA and the other mixers)"
    for kind in ("local", "xattn", "mla", "ssm", "rec")
}


class CapabilityError(ValueError):
    """A config asked for something the port cannot run (yet)."""


def _check_mixer(kind: str) -> None:
    if kind == "attn":
        return
    if kind in _NOT_PORTED:
        raise CapabilityError(
            f"mixer {kind!r} is not ported to PyTorch yet; "
            f"{_NOT_PORTED[kind]} brings it")
    raise CapabilityError(f"unknown mixer kind {kind!r}")


def check_paged(cfg: ModelConfig) -> None:
    """Config-time gate for the paged engine and the model's paged paths:
    every block must be the global-attention mixer with a SwiGLU MLP."""
    for kind in cfg.layer_kinds:
        _check_mixer(cfg.mixer_of(kind))
        if ":" in kind:
            raise CapabilityError(
                f"block kind {kind!r}: per-block MLP overrides (MoE) are not "
                f"ported yet; {_NOT_PORTED['mla']} brings them")
    if cfg.mlp_kind != "swiglu":
        raise CapabilityError(
            f"mlp_kind {cfg.mlp_kind!r} is not ported yet; "
            f"{_NOT_PORTED['mla']} brings it")


def pool_resident(kind: str) -> bool:
    """True when this mixer's per-token state lives in the shared page pool
    (group prompt pages can be refcount-shared and parked siblings can
    resume on freed slots)."""
    _check_mixer(kind)
    return True


def pure_pool_prefix(cfg: ModelConfig) -> bool:
    """All mixers pool-resident -> groups need not be placed atomically."""
    return all(pool_resident(cfg.mixer_of(k)) for k in cfg.layer_kinds)
