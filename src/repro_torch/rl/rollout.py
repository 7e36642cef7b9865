"""Rollout configuration (``src/repro/rl/rollout.py::RolloutConfig``), with
the special token ids of the reference's tokenizer (``rl/env.py``)."""
from __future__ import annotations

import dataclasses

PAD, BOS, EOS = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class RolloutConfig:
    max_new_tokens: int = 64
    temperature: float = 1.0
    eos_id: int = EOS
    pad_id: int = PAD
