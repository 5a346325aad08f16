"""FUSCO public API: the MoE shuffle plus expert compute (port of
``repro/core/fusco.py``, the ``fused_flat`` engine).

A model layer calls :func:`moe_shuffle_ffn` on this rank's (T, d) tokens and
its lane's expert weights, with the EP process group, and gets back the
combined expert outputs in token order.  :func:`dense_moe_reference` is the
per-token dense oracle the tests hold every engine to.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import dcomm
from repro_torch.core.dcomm import DcommConfig, DispatchResult
from repro_torch.core.routing import ExpertPlacement, router_logits, top_k_routing
from repro_torch.kernels import ops as kops

_LATER = {
    "fused_pipe": "ROADMAP queue 1 item 4 (fused_pipe)",
    "fused_hier": "ROADMAP queue 1 item 4 (fused_hier)",
    "disagg": "ROADMAP queue 1 item 4 (disagg)",
    "ragged": "ROADMAP queue 1 item 4 (ragged)",
}


def _check_engine(cfg: DcommConfig) -> None:
    if cfg.engine in _LATER:
        raise NotImplementedError(
            f"engine {cfg.engine!r} is not ported yet: {_LATER[cfg.engine]}")
    if cfg.engine != "fused_flat":
        raise ValueError(f"unknown engine {cfg.engine!r}")
    if cfg.dedup:
        raise NotImplementedError(
            "fused_flat with dedup is not ported yet: ROADMAP queue 1 item 4 "
            "(dedup)")


def swiglu_experts(rows: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                   w2: torch.Tensor,
                   counts: torch.Tensor | None = None) -> torch.Tensor:
    """Grouped SwiGLU FFN consuming the landed buffer in place.
    rows: (S, E_local, C, d); w1/w3: (E_local, d, f); w2: (E_local, f, d);
    counts: (S, E_local) landed occupancy, or None for all rows live."""
    return kops.fused_swiglu(rows, w1, w3, w2, counts)


def dispatch(x, A, gates, placement: ExpertPlacement, cfg: DcommConfig,
             group: dist.ProcessGroup | None = None) -> DispatchResult:
    _check_engine(cfg)
    return dcomm.flat_dispatch(x, A, gates, placement, cfg, group)


def combine(expert_out, res: DispatchResult, placement: ExpertPlacement,
            cfg: DcommConfig,
            group: dist.ProcessGroup | None = None) -> torch.Tensor:
    _check_engine(cfg)
    return dcomm.flat_combine(expert_out, res, placement, cfg, group)


def shuffle_ffn(x: torch.Tensor, A: torch.Tensor, gates: torch.Tensor,
                w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor,
                placement: ExpertPlacement, cfg: DcommConfig,
                group: dist.ProcessGroup | None = None) -> torch.Tensor:
    """Shuffle + grouped FFN + combine for pre-computed routing."""
    res = dispatch(x, A, gates, placement, cfg, group)
    out = swiglu_experts(res.expert_rows, w1, w3, w2, res.counts)
    return combine(out, res, placement, cfg, group)


def moe_shuffle_ffn(x: torch.Tensor, w_router: torch.Tensor, w1: torch.Tensor,
                    w3: torch.Tensor, w2: torch.Tensor,
                    placement: ExpertPlacement, cfg: DcommConfig, top_k: int,
                    norm_topk: bool = True,
                    group: dist.ProcessGroup | None = None) -> torch.Tensor:
    """Full fused MoE block: route -> dispatch -> grouped FFN -> combine.

    ``x`` is this rank's (T_local, d) tokens; the weights are this lane's
    experts (E_local, d, f)/(E_local, f, d); the router is replicated;
    ``group`` is the EP process group (None: one lane)."""
    logits = router_logits(x, w_router)
    A, gates = top_k_routing(logits, top_k, normalize=norm_topk)
    return shuffle_ffn(x, A, gates.to(x.dtype), w1, w3, w2, placement, cfg,
                       group)


def dense_moe_reference(x: torch.Tensor, w_router: torch.Tensor,
                        w1_all: torch.Tensor, w3_all: torch.Tensor,
                        w2_all: torch.Tensor, top_k: int,
                        norm_topk: bool = True) -> torch.Tensor:
    """Oracle: per-token dense evaluation of the selected experts.
    ``w*_all`` hold ALL experts (E, d, f)/(E, f, d).  O(T*K*d*f): small
    configs only."""
    logits = router_logits(x, w_router)
    A, gates = top_k_routing(logits, top_k, normalize=norm_topk)
    e = A.long()
    xk = x[:, None, None, :]                                   # (T, 1, 1, d)
    h = (xk @ w1_all[e]).squeeze(2)                            # (T, K, f)
    u = (xk @ w3_all[e]).squeeze(2)
    y = ((torch.nn.functional.silu(h) * u)[:, :, None, :] @ w2_all[e]).squeeze(2)
    return (y * gates.to(x.dtype)[..., None]).sum(dim=1)
