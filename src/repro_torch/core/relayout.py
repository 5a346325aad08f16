"""Load-adaptive expert re-layout (port of ``repro/core/relayout.py``):
table-driven placement, the greedy solver and the weight migration.

FUSCO's Online Load Balancer (Algorithm 1, ``core/balancer.py``) balances
the *forwarders*; which lane hosts which expert is the placement.  The
arithmetic ``routing.ExpertPlacement`` is one fixed map.  A
:class:`TablePlacement` is any expert -> (lane, slot) table with per-expert
replica counts, and :func:`solve_placement` packs measured expert loads
(``core/traffic.py``'s EMA) onto lanes: hot experts get extra replicas,
spread across nodes first, and the per-lane load is equalised by a
longest-processing-time deal plus a swap pass.  The solver is host-side
numpy, copied from the reference and pinned equal to it by
``tests/test_torch_relayout.py``.

Every engine reads only the placement interface (``ep`` / ``node_size`` /
``n_nodes`` / ``experts_per_lane`` / ``max_replicas`` / ``lane_of_expert``
/ ``local_expert_index`` / ``node_of_lane`` / ``replica_count``), so each
runs unchanged under a table.  The table's maps are torch ops on the
``expert_ids``' device, reading index tensors built once per device (a
copy of a numpy table to the card on every call would make the host wait
inside every MoE layer).

A placement swap between training steps migrates the lane-major expert
blocks (:func:`migrate_lane_major`): each destination slot takes the
replica MEAN of its expert's old copies, accumulated in float32
(replicas see disjoint token shares and drift apart during training).
:func:`migration_stats` prices a swap in blocks and bytes moved across
lanes.  The migration over ranks that each hold a lane lives in
``launch/train.py`` (``apply_relayout``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

I32 = torch.int32


@dataclasses.dataclass(frozen=True, eq=False)
class TablePlacement:
    """Arbitrary expert -> lane placement with per-expert replication.

    ``lane_expert[lane, slot]`` is the expert id hosted at local slot
    ``slot`` of ``lane``.  Every lane hosts exactly ``slots_per_lane``
    expert slots (static weight shapes); an expert may appear on several
    lanes (replicas, always on *distinct* lanes) but at most once per lane.

    Drop-in for ``routing.ExpertPlacement`` wherever the planner and the
    engines look.  ``local_expert_index`` depends on the replica choice (each
    copy lives at its own slot), so callers pass the same ``replica_choice``
    to both maps, as the planner does.  ``eq=False``: the class hashes by
    identity, so caches keyed on a placement (``dcomm.pipe_geometry``) see a
    new table as a new key.
    """

    lane_expert: np.ndarray          # (ep, slots_per_lane) int32
    node_size: int
    n_experts: int

    def __post_init__(self):
        tbl = np.asarray(self.lane_expert, np.int32)
        object.__setattr__(self, "lane_expert", tbl)
        ep, spl = tbl.shape
        if ep % self.node_size != 0:
            raise ValueError(f"ep={ep} not divisible by node_size={self.node_size}")
        if tbl.min() < 0 or tbl.max() >= self.n_experts:
            raise ValueError("lane_expert entries must be in [0, n_experts)")
        hosted = np.unique(tbl)
        if len(hosted) != self.n_experts:
            missing = sorted(set(range(self.n_experts)) - set(hosted.tolist()))
            raise ValueError(f"experts not hosted by any lane: {missing}")
        for lane in range(ep):
            if len(set(tbl[lane].tolist())) != spl:
                raise ValueError(
                    f"lane {lane} hosts a duplicate expert (replica lanes "
                    "must be distinct)")
        # replica tables: lanes/slots hosting each expert, padded by
        # repeating replica 0 (safe: choices are taken mod n_replicas)
        n_rep = np.zeros(self.n_experts, np.int32)
        lanes_of = [[] for _ in range(self.n_experts)]
        slots_of = [[] for _ in range(self.n_experts)]
        for lane in range(ep):
            for slot in range(spl):
                e = int(tbl[lane, slot])
                lanes_of[e].append(lane)
                slots_of[e].append(slot)
                n_rep[e] += 1
        mr = int(n_rep.max())
        rl = np.zeros((self.n_experts, mr), np.int32)
        rs = np.zeros((self.n_experts, mr), np.int32)
        for e in range(self.n_experts):
            for r in range(mr):
                rl[e, r] = lanes_of[e][r % n_rep[e]]
                rs[e, r] = slots_of[e][r % n_rep[e]]
        object.__setattr__(self, "n_replicas", n_rep)
        object.__setattr__(self, "replica_lanes", rl)
        object.__setattr__(self, "replica_slots", rs)
        object.__setattr__(self, "_on", {})

    # -- static ints (interface parity with ExpertPlacement) -----------------

    @property
    def ep(self) -> int:
        return self.lane_expert.shape[0]

    @property
    def n_nodes(self) -> int:
        return self.ep // self.node_size

    @property
    def experts_per_lane(self) -> int:
        return self.lane_expert.shape[1]

    @property
    def max_replicas(self) -> int:
        return self.replica_lanes.shape[1]

    # -- maps: torch ops on the ids' device ----------------------------------

    def _tables(self, device: torch.device):
        """(n_replicas, replica_lanes, replica_slots) on ``device``, built
        once: to the card through pinned memory without a host wait."""
        key = str(device)
        if key not in self._on:
            host = [torch.from_numpy(a) for a in
                    (self.n_replicas, self.replica_lanes, self.replica_slots)]
            if device.type == "cuda":
                host = [t.pin_memory().to(device, non_blocking=True)
                        for t in host]
            self._on[key] = tuple(host)
        return self._on[key]

    def _choice(self, expert_ids: torch.Tensor, replica_choice) -> torch.Tensor:
        e = expert_ids.long()
        if replica_choice is None:
            return torch.zeros_like(e)
        nr = self._tables(expert_ids.device)[0][e]
        return (replica_choice.long() % nr).long()

    def lane_of_expert(self, expert_ids: torch.Tensor,
                       replica_choice: torch.Tensor | None = None) -> torch.Tensor:
        r = self._choice(expert_ids, replica_choice)
        return self._tables(expert_ids.device)[1][expert_ids.long(), r]

    def local_expert_index(self, expert_ids: torch.Tensor,
                           replica_choice: torch.Tensor | None = None
                           ) -> torch.Tensor:
        r = self._choice(expert_ids, replica_choice)
        return self._tables(expert_ids.device)[2][expert_ids.long(), r]

    def node_of_lane(self, lane: torch.Tensor) -> torch.Tensor:
        return lane // self.node_size

    def replica_count(self, expert_ids: torch.Tensor) -> torch.Tensor:
        return self._tables(expert_ids.device)[0][expert_ids.long()]


# ---------------------------------------------------------------------------
# Generic placement views (both placement classes)
# ---------------------------------------------------------------------------

def placement_table(placement) -> np.ndarray:
    """(ep, experts_per_lane) expert-id table view of any placement."""
    if isinstance(placement, TablePlacement):
        return np.asarray(placement.lane_expert)
    ep, spl, e = placement.ep, placement.experts_per_lane, placement.n_experts
    tbl = np.zeros((ep, spl), np.int32)
    for lane in range(ep):
        for slot in range(spl):
            tbl[lane, slot] = (lane * spl + slot) if e >= ep else lane % e
    return tbl


def replica_counts(placement) -> np.ndarray:
    """(n_experts,) number of lanes hosting each expert."""
    tbl = placement_table(placement)
    return np.bincount(tbl.reshape(-1), minlength=placement.n_experts).astype(
        np.int64)


def lane_loads(expert_loads, placement) -> np.ndarray:
    """Per-lane token load under a placement, assuming each expert's traffic
    splits evenly across its replicas (what ``balanced_replica_choice``
    enforces round-robin): the metric the re-layout minimises the max of,
    fed from ``traffic.TrafficState`` counts."""
    loads = np.asarray(expert_loads, np.float64)
    tbl = placement_table(placement)
    per_rep = loads / np.maximum(replica_counts(placement), 1)
    return per_rep[tbl].sum(axis=1)


# ---------------------------------------------------------------------------
# Greedy load-adaptive solver (host numpy, the reference's, copied)
# ---------------------------------------------------------------------------

def solve_placement(expert_loads, *, ep: int, node_size: int,
                    slots_per_lane: int | None = None,
                    swap_iters: int = 200) -> TablePlacement:
    """Pack measured expert loads onto lanes.

    1. Replica allocation: every expert gets one slot; the remaining
       ``ep * slots_per_lane - n_experts`` slots go greedily to the expert
       with the highest per-replica load (at most one replica per lane).
    2. Node-interleaved LPT deal: (expert, replica) items sorted by
       per-replica load descending, each expert's replicas consecutive,
       dealt round-robin over a node-interleaved lane order, so replicas
       land on distinct lanes and distinct nodes first.
    3. Swap improvement: swaps between the heaviest and the lightest lane
       that lower the max lane load and keep replica lanes distinct.

    Runs on the host between steps, at the relayout cadence."""
    loads = np.maximum(np.asarray(expert_loads, np.float64), 1e-9)
    n_experts = loads.shape[0]
    if slots_per_lane is None:
        slots_per_lane = -(-n_experts // ep)
    if slots_per_lane > n_experts:
        raise ValueError(
            f"slots_per_lane={slots_per_lane} > n_experts={n_experts}: some "
            "lane would host the same expert twice")
    total = ep * slots_per_lane
    if total < n_experts:
        raise ValueError(
            f"{total} slots cannot host {n_experts} experts")

    # 1. replica allocation
    reps = np.ones(n_experts, np.int64)
    for _ in range(total - n_experts):
        per = np.where(reps < ep, loads / reps, -np.inf)
        reps[int(np.argmax(per))] += 1

    # 2. node-interleaved LPT deal
    order = np.argsort(-(loads / reps), kind="stable")
    items = [e for e in order for _ in range(reps[e])]      # replicas adjacent
    n_nodes = ep // node_size
    lane_order = [(i % n_nodes) * node_size + i // n_nodes for i in range(ep)]
    hosted: list[list[int]] = [[] for _ in range(ep)]
    for j, e in enumerate(items):
        hosted[lane_order[j % ep]].append(int(e))

    # 3. swap improvement (max-lane-load descent)
    per_rep = loads / reps
    weight = [sum(per_rep[e] for e in h) for h in hosted]
    for _ in range(swap_iters):
        hi = int(np.argmax(weight))
        lo = int(np.argmin(weight))
        best, gain = None, 1e-12
        for si, a in enumerate(hosted[hi]):
            for sj, b in enumerate(hosted[lo]):
                if a == b or a in hosted[lo] or b in hosted[hi]:
                    continue                     # would duplicate on a lane
                d = per_rep[a] - per_rep[b]
                # swap reduces the pair's max iff 0 < d and hi stays heavier
                if 0 < d < (weight[hi] - weight[lo]) and d > gain:
                    best, gain = (si, sj, a, b), d
        if best is None:
            break
        si, sj, a, b = best
        hosted[hi][si], hosted[lo][sj] = b, a
        weight[hi] -= gain
        weight[lo] += gain

    return TablePlacement(lane_expert=np.array(hosted, np.int32),
                          node_size=node_size, n_experts=n_experts)


# ---------------------------------------------------------------------------
# Weight migration between placements
# ---------------------------------------------------------------------------

def _expert_home_flat(placement) -> np.ndarray:
    """(n_experts,) flat (lane * experts_per_lane + slot) of replica 0."""
    tbl = placement_table(placement)
    spl = tbl.shape[1]
    home = np.full(placement.n_experts, -1, np.int64)
    for lane in range(tbl.shape[0]):
        for slot in range(spl):
            e = int(tbl[lane, slot])
            if home[e] < 0:
                home[e] = lane * spl + slot
    return home


def migration_gather_index(old_placement, new_placement,
                           device="cpu") -> torch.Tensor:
    """Flat source row (old layout) per destination slot (new layout):
    ``new.reshape(ep*spl_new, ...)[i] = old.reshape(ep*spl_old, ...)[idx[i]]``
    with replicas sourced from the old replica 0: the locality view
    :func:`migration_stats` prices bytes with, and the whole migration when
    the old placement has no replicas (then each expert's mean is its one
    copy)."""
    home = _expert_home_flat(old_placement)
    new_tbl = placement_table(new_placement)
    return torch.as_tensor(home[new_tbl.reshape(-1)], dtype=I32, device=device)


def slot_table(placement, device="cpu") -> torch.Tensor:
    """(ep * experts_per_lane,) int64: the expert id of each flat slot."""
    return torch.as_tensor(placement_table(placement).reshape(-1),
                           dtype=torch.long, device=device)


def replica_mean_canonical(flat: torch.Tensor, placement) -> torch.Tensor:
    """Flat lane-major expert blocks ``(ep*spl, ...)`` -> canonical
    per-expert blocks ``(n_experts, ...)``, the MEAN over each expert's
    replica slots.  Accumulates in float32, returns ``flat``'s dtype."""
    tbl = slot_table(placement, flat.device)
    counts = torch.as_tensor(replica_counts(placement), dtype=torch.float32,
                             device=flat.device)
    canon = torch.zeros((placement.n_experts,) + flat.shape[1:],
                        dtype=torch.float32, device=flat.device)
    canon.index_add_(0, tbl, flat.float())
    canon = canon / counts.reshape((-1,) + (1,) * (flat.ndim - 1))
    return canon.to(flat.dtype)


def migrate_lane_major(w: torch.Tensor, old_placement, new_placement,
                       lane_axis: int = 0) -> torch.Tensor:
    """Re-layout lane-major expert weights ``(..., ep, e_local, ...)`` (every
    lane, one tensor) from ``old_placement`` to ``new_placement``;
    ``lane_axis`` locates the ``ep`` dim (``e_local`` follows it).  Every
    destination slot takes the replica mean of its expert's old copies
    (:func:`replica_mean_canonical`); when the copies agree the mean is
    each copy.  Returns a new tensor."""
    ep_new = new_placement.ep
    spl_new = new_placement.experts_per_lane
    w = torch.movedim(torch.movedim(w, lane_axis, 0), lane_axis + 1, 1)
    flat = w.reshape((w.shape[0] * w.shape[1],) + w.shape[2:])
    canon = replica_mean_canonical(flat, old_placement)
    out = canon.index_select(0, slot_table(new_placement, w.device)).reshape(
        (ep_new, spl_new) + flat.shape[1:])
    return torch.movedim(torch.movedim(out, 1, lane_axis + 1), 0, lane_axis)


def migration_stats(old_placement, new_placement, *, row_bytes: int) -> dict:
    """How expensive is this relayout?  ``row_bytes`` is the byte size of one
    expert's weight block (all migrated tensors combined, e.g.
    ``w1+w3+w2``).  A destination slot costs nothing when its source already
    lives on the same lane (local copy); cross-lane rows are the wire
    traffic."""
    home = _expert_home_flat(old_placement)
    spl_old = old_placement.experts_per_lane
    new_tbl = placement_table(new_placement)
    src_lane = home[new_tbl] // spl_old                      # (ep, spl_new)
    dst_lane = np.arange(new_tbl.shape[0])[:, None]
    moved = int((src_lane != dst_lane).sum())
    return {"slots": int(new_tbl.size), "rows_moved": moved,
            "bytes_moved": moved * row_bytes}
