"""Architecture configs: a copy of ``repro/configs/base.py`` (the parts the
port uses), kept here so the port imports nothing of the JAX package.

The ``reduced()`` method yields the CPU smoke-test variant (same family and
wiring, tiny dims) and must stay identical to the reference's, because the
tests build the same reduced model on both sides.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff_expert: int
    norm_topk: bool = True


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe (the families ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    rope_theta: float = 1e6
    moe: Optional[MoESpec] = None
    window: Optional[int] = None     # sliding-window attention
    global_layers: Tuple[int, ...] = ()
    source: str = ""

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family & wiring, tiny dims."""
        return dataclasses.replace(
            self,
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=2,
            head_dim=16,
            d_ff=128,
            vocab=256,
            window=min(self.window, 16) if self.window else None,
            global_layers=tuple(g for g in self.global_layers if g < 2)
            or ((0,) if self.global_layers else ()),
            moe=dataclasses.replace(self.moe, n_experts=8,
                                    top_k=min(self.moe.top_k, 2),
                                    d_ff_expert=32) if self.moe else None,
        )
