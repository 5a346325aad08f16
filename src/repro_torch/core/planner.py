"""Communication planner: router output -> flat descriptor plan (port of
``repro/core/planner.py``, the single-level flat plan only).

One slot per (token, k) assignment, addressed directly to its (lane,
local expert, capacity) sub-slot, so the tiled all-to-all lands every token
already grouped by expert on the receiver.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.descriptors import SlotTable, build_slot_table, drop_neg
from repro_torch.core.routing import ExpertPlacement, balanced_replica_choice

I32 = torch.int32


class FlatPlan(NamedTuple):
    """Single-level fused dispatch plan (per shard)."""
    slots: SlotTable             # (T, K) -> row in (EP * E_local * C) buffer
    src_of_slot: torch.Tensor    # (R,) source token row per buffer row, -1 empty
    gate_of_slot: torch.Tensor   # (R,) combine weight per buffer row
    lane: torch.Tensor           # (T, K) destination lane
    dropped: torch.Tensor        # () assignments lost to capacity overflow


def _inverse_slot(slots: SlotTable, values: torch.Tensor) -> torch.Tensor:
    """Scatter ``values`` (shaped like slots.slot) into buffer rows; rows no
    assignment fills hold -1."""
    n = slots.total_rows
    flat_slot = drop_neg(slots.slot.reshape(-1), n).long()
    out = torch.full((n + 1,), -1, dtype=values.dtype, device=values.device)
    out[flat_slot] = values.reshape(-1)     # dropped assignments hit row n
    return out[:n]


def build_flat_plan(A: torch.Tensor, gates: torch.Tensor,
                    placement: ExpertPlacement, capacity: int) -> FlatPlan:
    """Descriptor construction for the single-level fused engine."""
    t = A.shape[0]
    replica = balanced_replica_choice(A, placement)
    lane = placement.lane_of_expert(A, replica)                  # (T, K)
    e_local = placement.local_expert_index(A, replica)           # (T, K)
    key = lane * placement.experts_per_lane + e_local
    slots = build_slot_table(key, placement.ep * placement.experts_per_lane,
                             capacity)
    token_ids = torch.arange(t, dtype=I32, device=A.device)[:, None].expand(A.shape)
    src_of_slot = _inverse_slot(slots, token_ids)
    gate_of_slot = _inverse_slot(slots, gates)
    gate_of_slot = torch.where(src_of_slot >= 0, gate_of_slot, 0).to(gates.dtype)
    return FlatPlan(slots, src_of_slot, gate_of_slot, lane, slots.dropped())
