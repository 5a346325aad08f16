"""Communication planner: router output -> descriptor plans (port of
``repro/core/planner.py``).

- flat plan: one slot per (token, k) assignment, addressed directly to its
  (lane, local expert, capacity) sub-slot, so the tiled all-to-all lands
  every token already grouped by expert on the receiver; and its
  capacity-axis slicing for the pipelined engine.
- hierarchical plan: one stage-1 row per (token, destination node), sent
  to the forwarder lane the Online Load Balancer picks, with the token's
  (node-local expert, gate) pairs for that node piggybacked; the forwarder
  expands them with the stage-2 plan (the paper's expert-level
  descriptors).
- condensed plan: the same one level down, one wire row per (token,
  destination lane), expanded on the landing lane by the stage-2 plan at
  node size 1 (``fused_flat`` with ``dedup``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import balancer as balancer_lib
from repro_torch.core.descriptors import (SlotTable, build_slot_table,
                                          drop_neg, group_counts)
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


class HierPlan(NamedTuple):
    """Node-level forwarding plan (per shard, sender side)."""
    slots: SlotTable             # (T, n_nodes) -> row in (EP * C1) buffer; -1 if
                                 # the token has no expert on that node (dedup)
    src_of_slot: torch.Tensor    # (R1,) source token row per stage-1 row, -1 empty
    meta_expert: torch.Tensor    # (R1, K) lane_in_node * E_local + e_local, -1 pad
    meta_gate: torch.Tensor      # (R1, K) gates aligned with meta_expert
    dst_rank_load: torch.Tensor  # (EP,) rows sent to each rank (balancer input)
    dropped: torch.Tensor        # () stage-1 rows lost to capacity overflow


def _meta(slots: SlotTable, enc: torch.Tensor, gates: torch.Tensor, k: int):
    """The piggybacked (expert, gate) rows of a (T, G, K) encoding: row
    ``slots.slot[t, g]`` of (R, K) tables gets ``enc[t, g]`` (-1 pad) and
    its gates (0 pad); dropped rows land on a dump row cut off."""
    r = slots.total_rows
    flat_slot = drop_neg(slots.slot.reshape(-1), r).long()
    meta_expert = torch.full((r + 1, k), -1, dtype=I32, device=enc.device)
    meta_expert[flat_slot] = enc.reshape(-1, k).to(I32)
    meta_gate = torch.zeros((r + 1, k), dtype=gates.dtype, device=gates.device)
    meta_gate = meta_gate.index_put((flat_slot,), gates.reshape(-1, k))
    return meta_expert[:r], meta_gate[:r]


def build_hier_plan(A: torch.Tensor, gates: torch.Tensor,
                    placement: ExpertPlacement, capacity1: int, my_lane: int,
                    assignment: torch.Tensor | None = None) -> HierPlan:
    """Node-level forwarding descriptors with dedup (paper §3.3, first
    level).  ``assignment`` is the balancer's (n_nodes, node_size) group
    table; None takes the static balancer-off grouping (§5.4).  ``my_lane``
    is this shard's lane on the EP axis."""
    t, k = A.shape
    n_nodes, ns = placement.n_nodes, placement.node_size
    dev = A.device
    replica = balanced_replica_choice(A, placement)
    lane = placement.lane_of_expert(A, replica)                  # (T, K)
    e_local = placement.local_expert_index(A, replica)
    node = placement.node_of_lane(lane)                          # (T, K): B

    # dedup: does token t use node n?  (T, n_nodes); elementwise, as a
    # scatter of a Python scalar would copy it to the card and wait there
    dst_nodes = torch.arange(n_nodes, dtype=I32, device=dev)
    uses_node = (node[:, :, None] == dst_nodes).any(dim=1)

    # the forwarder of each destination node (Online Load Balancer)
    if assignment is None:
        assignment = balancer_lib.static_assignment(n_nodes, ns, dev)
    fwd = balancer_lib.forwarder_lane(assignment.to(dev), my_lane // ns,
                                      my_lane % ns, dst_nodes)
    dst_rank = dst_nodes * ns + fwd                              # (n_nodes,)

    # stage-1 slot table: one row per (token, node)
    key1 = torch.where(uses_node, dst_rank[None, :], -1)         # (T, n_nodes)
    slots = build_slot_table(key1, placement.ep, capacity1)
    token_ids = torch.arange(t, dtype=I32, device=dev)[:, None].expand(key1.shape)
    src_of_slot = _inverse_slot(slots, token_ids)                # (R1,)

    # piggybacked metadata: per (t, node), the assignments on that node as
    # lane_in_node * E_local + e_local, -1 elsewhere
    enc = (lane % ns) * placement.experts_per_lane + e_local     # (T, K)
    on_node = node[:, None, :] == dst_nodes[None, :, None]       # (T, n, K)
    enc_tn = torch.where(on_node, enc[:, None, :], -1)
    gate_tn = torch.where(enc_tn >= 0, gates[:, None, :], 0).to(gates.dtype)
    meta_expert, meta_gate = _meta(slots, enc_tn, gate_tn, k)
    load = group_counts(key1.reshape(-1), placement.ep)
    return HierPlan(slots, src_of_slot, meta_expert, meta_gate, load,
                    slots.dropped())


class CondensedPlan(NamedTuple):
    """Lane-level condensed dispatch plan (per shard, sender side): one wire
    row per distinct (token, destination lane) pair instead of one per
    (token, k) assignment, the assignments on that lane piggybacked as
    (local expert, gate) metadata and expanded on the landing lane, with no
    second exchange."""
    slots: SlotTable             # (T, EP) -> row in (EP * C) wire buffer; -1 if
                                 # the token has no assignment on that lane
    src_of_slot: torch.Tensor    # (R,) source token row per wire row, -1 empty
    meta_expert: torch.Tensor    # (R, K) local expert on the dest lane, -1 pad
    meta_gate: torch.Tensor      # (R, K) gates aligned with meta_expert
    dropped: torch.Tensor        # () condensed rows lost to capacity overflow


def build_condensed_plan(A: torch.Tensor, gates: torch.Tensor,
                         placement: ExpertPlacement,
                         capacity: int) -> CondensedPlan:
    """Dedup/condense descriptors: one wire row per (token, dest lane); the
    landing side expands it per local expert (``build_stage2_plan`` with
    ``node_size=1``), re-applying every (expert, gate) pair the flat plan
    would have shipped apart."""
    t, k = A.shape
    ep = placement.ep
    dev = A.device
    replica = balanced_replica_choice(A, placement)
    lane = placement.lane_of_expert(A, replica)                  # (T, K)
    e_local = placement.local_expert_index(A, replica)

    lanes = torch.arange(ep, dtype=I32, device=dev)
    uses_lane = (lane[:, :, None] == lanes).any(dim=1)          # (T, EP)
    key = torch.where(uses_lane, lanes[None, :], -1)
    slots = build_slot_table(key, ep, capacity)
    token_ids = torch.arange(t, dtype=I32, device=dev)[:, None].expand(key.shape)
    src_of_slot = _inverse_slot(slots, token_ids)                # (R,)

    enc_tl = torch.where(lane[:, None, :] == lanes[None, :, None],
                         e_local[:, None, :], -1)                # (T, EP, K)
    gate_tl = torch.where(enc_tl >= 0, gates[:, None, :], 0).to(gates.dtype)
    meta_expert, meta_gate = _meta(slots, enc_tl, gate_tl, k)
    return CondensedPlan(slots, src_of_slot, meta_expert, meta_gate,
                         slots.dropped())


class Stage2Plan(NamedTuple):
    """Expert-level distribution descriptors, built on the forwarder."""
    slots: SlotTable             # (R1, K) -> row in (node_size * E_local * C2)
    src_of_slot: torch.Tensor    # (R2,) stage-1 row feeding each stage-2 row
    gate_of_slot: torch.Tensor   # (R2,)


def build_stage2_plan(meta_expert: torch.Tensor, meta_gate: torch.Tensor,
                      node_size: int, experts_per_lane: int,
                      capacity2: int) -> Stage2Plan:
    """Expert-level descriptors from the piggybacked metadata (paper §3.3,
    second level), on the forwarder; a row used by several local experts
    takes several stage-2 slots (the intra-node redistribution).  The slot
    table is the exact inverse of ``src_of_slot``: the owner table of the
    expansion gather's backward and of the pre-combine."""
    r1, k = meta_expert.shape
    slots = build_slot_table(meta_expert, node_size * experts_per_lane,
                             capacity2)
    row_ids = torch.arange(r1, dtype=I32,
                           device=meta_expert.device)[:, None].expand(r1, k)
    src_of_slot = _inverse_slot(slots, row_ids)
    gate_of_slot = _inverse_slot(slots, meta_gate)
    gate_of_slot = torch.where(src_of_slot >= 0, gate_of_slot,
                               0).to(meta_gate.dtype)
    return Stage2Plan(slots, src_of_slot, gate_of_slot)
