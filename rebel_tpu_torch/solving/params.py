"""Solver hyper-parameters (the port's copy of
``rebel_tpu/solving/params.py``)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SubgameSolvingParams:
    # Common FP/CFR params.
    num_iters: int = 10
    max_depth: int = 2
    linear_update: bool = False
    use_cfr: bool = False  # False => fictitious play.

    # FP-only.
    optimistic: bool = False

    # CFR-only (discounted CFR).
    dcfr: bool = False
    dcfr_alpha: float = 0.0
    dcfr_beta: float = 0.0
    dcfr_gamma: float = 0.0

    def __post_init__(self):
        if self.use_cfr and self.linear_update and self.dcfr:
            raise ValueError("linear_update and dcfr are mutually exclusive")

    def replace(self, **kw) -> "SubgameSolvingParams":
        return dataclasses.replace(self, **kw)
