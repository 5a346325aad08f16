"""Communication planner: router output -> flat descriptor plan (port of
``repro/core/planner.py``, the single-level flat plan and its capacity-axis
slicing for the pipelined engine).

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


class SlicedFlatPlan(NamedTuple):
    """A flat plan re-indexed for the pipelined engine: the (lane x
    local-expert x capacity) descriptor table split into ``n_slices`` equal
    chunks along the *capacity* axis, slice-major so the engine can stream
    slice ``s`` while slice ``s-1`` is still in flight (paper Fig. 5)."""
    src: torch.Tensor            # (S, EP, E_local, C/S) source token per slot
    gate: torch.Tensor           # (S, EP, E_local, C/S) combine weight per slot
    n_slices: int


def slice_flat_plan(plan: FlatPlan, placement: ExpertPlacement, capacity: int,
                    n_slices: int) -> SlicedFlatPlan:
    """Capacity-axis slicing of a flat plan's descriptors.

    Slot ``(lane, e, c)`` lands in slice ``c // (capacity / n_slices)``;
    within a slice the layout stays (lane-major, expert-major,
    arrival-order), so concatenating the slices back along the capacity
    axis reproduces the monolithic plan exactly.  ``capacity`` must be a
    multiple of ``n_slices`` (the engine rounds it up when picking the
    slice count).  Each slice's descriptors are contiguous."""
    if capacity % n_slices != 0:
        raise ValueError(f"capacity={capacity} not divisible by n_slices={n_slices}")
    ep, e_local = placement.ep, placement.experts_per_lane
    cs = capacity // n_slices
    src = plan.src_of_slot.reshape(ep, e_local, n_slices, cs)
    gate = plan.gate_of_slot.reshape(ep, e_local, n_slices, cs)
    return SlicedFlatPlan(src.permute(2, 0, 1, 3).contiguous(),
                          gate.permute(2, 0, 1, 3).contiguous(), n_slices)


def slice_owner_table(slot: torch.Tensor, capacity: int,
                      n_slices: int) -> torch.Tensor:
    """Each slice's owner table for the combine's owner-reduce, from the
    flat plan's (T, K) slot table by one elementwise map: buffer row r lies
    in slice ``(r mod C) // Cs`` at row ``(r // C) * Cs + r mod Cs`` of that
    slice's (EP * E_local * Cs) rows; every other slice gets -1.  Returns
    (S, T, K) int32, slice s the exact inverse of ``SlicedFlatPlan.src[s]``
    (the port's addition: the reference's combine takes no owner lists)."""
    cs = capacity // n_slices
    c = slot.remainder(capacity)
    row = (slot // capacity) * cs + c.remainder(cs)
    s = torch.arange(n_slices, dtype=slot.dtype, device=slot.device)
    live = (slot >= 0) & (c // cs == s[:, None, None])
    return torch.where(live, row, -1).to(I32)
