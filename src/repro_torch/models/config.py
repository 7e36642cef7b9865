"""ModelConfig, reduced to the fields the serving slice reads.

The reference's config (``src/repro/models/config.py``) describes ten
architecture families; the port grows it family by family.  Block groups
keep the reference's shape — ``((pattern, repeat), ...)`` of block-kind
strings — so layer order matches the reference's stacked parameters."""
from __future__ import annotations

import dataclasses
from typing import Tuple

BlockGroups = Tuple[Tuple[Tuple[str, ...], int], ...]  # ((pattern, repeat), ...)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    blocks: BlockGroups
    mlp_kind: str = "swiglu"
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    @property
    def n_layers(self) -> int:
        return sum(len(p) * r for p, r in self.blocks)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Block kinds in execution order (each group's pattern, repeated)."""
        return tuple(k for p, r in self.blocks for _ in range(r) for k in p)

    def mixer_of(self, kind: str) -> str:
        return kind.split(":")[0]


def dense_blocks(n_layers: int, mixer: str = "attn") -> BlockGroups:
    return (((mixer,), n_layers),)
