"""dComm, the data-fused communication engine (port of
``repro/core/dcomm.py``, the ``fused_flat`` engine).

``fused_flat``: ONE descriptor-driven gather stages tokens straight into
(destination lane x local expert x capacity) sub-slots; the tiled all-to-all
lands every token already expert-grouped, the FFN consumes it in place, and
the combine scatter-adds straight home.  The reference's shard_map axis
becomes an optional ``torch.distributed`` process group (the EP group): this
rank's lane is its rank in the group, and with no group (or a group of one)
the exchange is the identity.

Other engines (fused_pipe, fused_hier, disagg, ragged), the dedup wire and
the two-level multi-pod exchange are later slices of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core import planner as planner_lib
from repro_torch.core.routing import ExpertPlacement
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class DcommConfig:
    """Static configuration of the shuffle engine."""
    engine: str = "fused_flat"
    ep_axis: Any = "model"       # a (pod, model) pair asks for the multi-pod exchange
    capacity_factor: float = 2.0
    dedup: bool = False

    @property
    def pod_axis(self) -> str | None:
        return self.ep_axis[0] if isinstance(self.ep_axis, (tuple, list)) else None


def _cap(n_expected: float, factor: float, align: int = 8) -> int:
    c = max(align, int(-(-n_expected * factor // align)) * align)
    return c


def lane_index(group: dist.ProcessGroup | None) -> int:
    """This rank's lane on the EP axis: its rank in ``group`` (0 alone)."""
    return 0 if group is None else dist.get_rank(group)


def group_size(group: dist.ProcessGroup | None) -> int:
    return 1 if group is None else dist.get_world_size(group)


class DispatchResult(NamedTuple):
    """What the expert FFN consumes: a landed buffer already grouped by local
    expert, plus what combine() needs to route outputs home."""
    expert_rows: torch.Tensor     # (S, E_local, C, d) rows for this lane's experts
    state: Any                    # engine-private
    dropped: torch.Tensor | None = None   # this shard's capacity overflow
    counts: torch.Tensor | None = None    # (S, E_local) landed occupancy


def _flat_exchange(buf: torch.Tensor, cfg: DcommConfig, ep: int,
                   group: dist.ProcessGroup | None = None,
                   reverse: bool = False) -> torch.Tensor:
    """Tiled exchange of a lane-major (EP, rows, ...) buffer over the EP
    group: block i goes to lane i, and the block from lane j lands at j.
    The leading axis is the destination lane on dispatch and the origin lane
    on combine (single-level, so ``reverse`` is the same exchange)."""
    del reverse
    if cfg.pod_axis is not None:
        raise NotImplementedError(
            "two-level multi-pod exchange (dcomm.py:188-196): ROADMAP queue 1, "
            "multipod _flat_exchange")
    if group_size(group) == 1:
        return buf
    if buf.shape[0] != ep or group_size(group) != ep:
        raise ValueError(f"exchange of {buf.shape[0]} lanes over a group of "
                         f"{group_size(group)}, placement ep={ep}")
    buf = buf.contiguous()
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=group)
    return out


def flat_dispatch(x: torch.Tensor, A: torch.Tensor, gates: torch.Tensor,
                  placement: ExpertPlacement, cfg: DcommConfig,
                  group: dist.ProcessGroup | None = None) -> DispatchResult:
    t, d = x.shape
    k = A.shape[1]
    e_local = placement.experts_per_lane
    cap = _cap(t * k / (placement.ep * e_local), cfg.capacity_factor)
    plan = planner_lib.build_flat_plan(A, gates, placement, cap)

    # ONE fused gather: token layout -> comm buffer (EP * E_local * C, d)
    buf = kops.segment_gather(x, plan.src_of_slot)
    buf = _flat_exchange(buf.reshape(placement.ep, e_local * cap, d), cfg,
                         placement.ep, group)
    # landed layout: (source lane, E_local, C, d), expert-grouped already.
    # The occupancy of each landed group rides a tiny exchange of its own so
    # the FFN kernel can skip empty row tiles (the reference passes none).
    sent = plan.slots.counts.clamp(max=cap).to(torch.int32)
    counts = _flat_exchange(sent.reshape(placement.ep, e_local), cfg,
                            placement.ep, group)
    expert_rows = buf.reshape(placement.ep, e_local, cap, d)
    return DispatchResult(expert_rows, (plan, t, d, cap), plan.dropped, counts)


def flat_combine(expert_out: torch.Tensor, res: DispatchResult,
                 placement: ExpertPlacement, cfg: DcommConfig,
                 group: dist.ProcessGroup | None = None) -> torch.Tensor:
    plan, t, d, cap = res.state
    e_local = placement.experts_per_lane
    buf = _flat_exchange(expert_out.reshape(placement.ep, e_local * cap, d),
                         cfg, placement.ep, group, reverse=True)
    buf = buf.reshape(placement.ep * e_local * cap, d)
    # fused gated scatter-add straight into the original token layout
    return kops.segment_scatter_add(buf, plan.src_of_slot, plan.gate_of_slot, t)
