"""Comm-path planning: traffic-aware selection of HOW tokens ship (the
port's copy of ``repro/core/commplan.py``).

The engines (``core/dcomm.py``) fuse transformation with communication, but
*which path* a shuffle takes is one ``--engine`` flag for the whole run.
This module closes the loop from the online traffic statistics
(``core/traffic.py`` EMA state) to three per-run decisions:

  * **flat <-> hier selection** (:func:`plan_paths`): per layer, an analytic
    link-cost model (:class:`LinkCosts`) prices the single-level flat
    exchange against the two-level hierarchical one from the measured
    lane -> node send matrix and picks the cheaper path;
  * **dispatch dedup/condense accounting** (:func:`dedup_savings`): how many
    wire rows the condensed flat engine (``DcommConfig.dedup``) saves over
    the dense plan, straight from the EMA row counts;
  * **sequence migration** (:func:`plan_sequence_migration`): a data-rank
    rebalancing step that moves whole sequences, with the relayout
    migration accounting (``{"slots", "rows_moved", "bytes_moved"}``).

Everything here is host-side numpy: it runs in the serving engines'
``stats()``, never inside a step, and takes numpy leaves (a
``TrafficState`` of torch tensors is read to the host first).  The cost
model is structural: it ranks paths by the bytes each puts on each tier.
Every function is the reference's, line for line
(``tests/test_torch_traffic.py`` pins them equal); only the defaults of
:class:`LinkCosts` differ: the port's ``DcommConfig`` spec point for the
NVIDIA H100 80GB HBM3 (``from_dcomm`` of a default config).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class LinkCosts:
    """Per-tier link-cost point for the path policy (pipesim-style).

    Defaults match the port's ``DcommConfig`` pipelining point: the fast
    tier is the staging bandwidth (the card's memory), the slow tier the
    cross-node wire, and ``hop_overhead_s`` the fixed per-exchange latency
    each extra hop pays.
    """
    intra_bw: float = 3.35e12        # bytes/s, fast tier (intra-node)
    inter_bw: float = 450e9          # bytes/s, slow tier (cross-node wire)
    hop_overhead_s: float = 2e-6     # fixed cost per exchange hop

    @classmethod
    def from_dcomm(cls, cfg) -> "LinkCosts":
        return cls(intra_bw=cfg.pipe_stage_bw, inter_bw=cfg.pipe_wire_bw,
                   hop_overhead_s=cfg.pipe_overhead_s)


class PathDecision(NamedTuple):
    """One layer's comm-path choice with the costs that produced it."""
    engine: str                 # "fused_flat" | "fused_hier" (or the default)
    flat_s: float               # modeled seconds, flat path (nan when cold)
    hier_s: float               # modeled seconds, hier path (nan when cold)
    cold: bool                  # no traffic observed yet -> default engine
    dense_rows: float           # assignment-level wire rows (per step)
    cond_rows: float            # lane-condensed wire rows (per step)
    cross_rows: float           # node-dedup'd cross-node rows (per step)


def _layer_signals(state, placement):
    """Per-lane row counts of one layer's TrafficState slice (numpy).

    Returns (inter, intra, cond, send1): assignment-level inter/intra-node
    rows, lane-condensed rows, and node-dedup'd cross-node rows, each (EP,).
    """
    n_nodes, ns = placement.n_nodes, placement.node_size
    m = np.asarray(state.lane_node_ema, np.float64)[:, :n_nodes]   # (EP, N)
    own = m[np.arange(placement.ep), np.arange(placement.ep) // ns]
    total = m.sum(axis=1)
    return (total - own, own, np.asarray(state.lane_cond_ema, np.float64),
            np.asarray(state.lane_send_ema, np.float64))


def estimate_path_costs(state, placement, *, row_bytes: int,
                        costs: LinkCosts | None = None,
                        dedup: bool = False,
                        default: str = "fused_hier") -> PathDecision:
    """Price the flat and hier paths for ONE layer's traffic slice.

    The model charges each path the bytes it puts on each tier at that tier's
    bandwidth, maxed over lanes (the exchange finishes when the busiest link
    does), twice (dispatch + combine), plus the fixed per-hop overhead:

      * **flat**: one exchange; cross-node rows ride the slow tier, same-node
        rows the fast tier (own-lane rows are counted with the fast tier — a
        deliberate upper bound).  With ``dedup`` the rows shrink by the
        measured condensation ratio (lane-condensed / dense rows).
      * **hier**: the slow tier carries only node-deduplicated rows
        (``lane_send_ema`` — exactly stage-1's wire volume), but the full
        assignment volume is redistributed on the fast tier and the extra
        hop doubles the fixed overhead.

    Cold state (no observation, or zero rows) yields the ``default`` engine
    with nan costs.
    """
    costs = costs or LinkCosts()
    inter, intra, cond, send1 = _layer_signals(state, placement)
    steps = int(np.asarray(state.steps))
    if steps <= 0 or (inter.sum() + intra.sum()) <= _EPS:
        return PathDecision(default, float("nan"), float("nan"), True,
                            0.0, 0.0, 0.0)
    rb = float(row_bytes)
    rho = min(1.0, cond.sum() / max(inter.sum() + intra.sum(), _EPS))
    scale = rho if dedup else 1.0
    flat_s = (2 * (inter.max() * scale * rb / costs.inter_bw
                   + intra.max() * scale * rb / costs.intra_bw)
              + 2 * costs.hop_overhead_s)
    hier_s = (2 * (send1.max() * rb / costs.inter_bw
                   + (inter + intra).max() * rb / costs.intra_bw)
              + 4 * costs.hop_overhead_s)
    engine = "fused_flat" if flat_s <= hier_s else "fused_hier"
    return PathDecision(engine, float(flat_s), float(hier_s), False,
                        float(inter.sum() + intra.sum()), float(cond.sum()),
                        float(send1.sum()))


def plan_paths(traffic, placement, *, row_bytes: int,
               costs: LinkCosts | None = None, dedup: bool = False,
               default: str = "fused_hier") -> list[PathDecision]:
    """Per-layer path decisions from a (possibly layer-stacked) TrafficState.

    ``traffic`` with leading ``(L,)`` leaves (the layer-scan stacking of
    ``init_traffic_state(..., n_layers=L)``) yields one decision per layer;
    an unstacked state yields a single-element list.
    """
    ema = np.asarray(traffic.expert_ema)
    if ema.ndim == 1:
        return [estimate_path_costs(traffic, placement, row_bytes=row_bytes,
                                    costs=costs, dedup=dedup, default=default)]
    n_layers = ema.shape[0]
    out = []
    for layer in range(n_layers):
        sl = type(traffic)(*[np.asarray(leaf)[layer] for leaf in traffic])
        out.append(estimate_path_costs(sl, placement, row_bytes=row_bytes,
                                       costs=costs, dedup=dedup,
                                       default=default))
    return out


def summarize_decisions(decisions: list[PathDecision]) -> dict:
    """Compact report of a decision list (train logs / serving stats)."""
    engines = [d.engine for d in decisions]
    return {
        "per_layer": engines,
        "n_flat": sum(e == "fused_flat" for e in engines),
        "n_hier": sum(e == "fused_hier" for e in engines),
        "n_cold": sum(d.cold for d in decisions),
        "dedup_rows_saved": float(sum(max(0.0, d.dense_rows - d.cond_rows)
                                      for d in decisions)),
    }


def dedup_savings(traffic, placement) -> dict:
    """Wire rows the dedup/condense engine saves vs the dense flat plan.

    Summed over layers when the state is layer-stacked.  ``dense_rows`` is
    the assignment-level row count (one wire row per (token, k) pair),
    ``cond_rows`` the lane-condensed count (one per distinct (token, dest
    lane) pair — a fortiori one per (source node, remote expert) duplicate
    group); both are EMA units, so only their ratio is calibration-free.
    """
    dense = float(np.asarray(traffic.lane_node_ema)
                  [..., :placement.n_nodes].sum())
    cond = float(np.asarray(traffic.lane_cond_ema).sum())
    saved = max(0.0, dense - cond)
    return {"dense_rows": dense, "cond_rows": cond, "rows_saved": saved,
            "frac_saved": saved / max(dense, _EPS)}


# ---------------------------------------------------------------------------
# Sequence migration (data-rank rebalancing)
# ---------------------------------------------------------------------------

def plan_sequence_migration(seq_loads, n_ranks: int, *, row_bytes: int = 0,
                            threshold: float = 1.05):
    """Rebalance whole sequences across data ranks (LPT with per-rank quota).

    ``seq_loads`` is a (B,) per-sequence load vector in batch-row order; rank
    ``r`` currently holds rows ``[r*q, (r+1)*q)`` with ``q = B / n_ranks``
    (the data loader's contiguous sharding).  The plan keeps exactly ``q``
    sequences per rank (static batch shapes) and deals sequences
    longest-processing-time-first onto the least-loaded open rank, preferring
    a sequence's home rank on ties so balanced batches do not churn.

    Returns ``(perm, stats)``: ``perm`` is a (B,) row permutation — new batch
    row ``j`` holds old row ``perm[j]`` — and ``stats`` reuses the relayout
    migration accounting (``slots`` / ``rows_moved`` / ``bytes_moved``, one
    slot per sequence) plus the max-rank load before/after.  When the current
    max-rank load is within ``threshold`` of the mean, the identity
    permutation is returned: migration only pays when imbalance does.
    """
    loads = np.asarray(seq_loads, np.float64).reshape(-1)
    b = loads.shape[0]
    if n_ranks <= 0 or b % n_ranks != 0:
        raise ValueError(f"batch of {b} sequences not divisible by "
                         f"n_ranks={n_ranks}")
    q = b // n_ranks
    home = np.arange(b) // q
    rank_before = np.add.reduceat(loads, np.arange(0, b, q))
    mean = loads.sum() / n_ranks

    def _stats(assign, after):
        moved = int((assign != home).sum())
        return {"slots": b, "rows_moved": moved,
                "bytes_moved": moved * row_bytes,
                "max_load_before": float(rank_before.max()),
                "max_load_after": float(after)}

    if rank_before.max() <= threshold * max(mean, _EPS):
        return np.arange(b), _stats(home, rank_before.max())

    order = np.argsort(-loads, kind="stable")
    rank_load = np.zeros(n_ranks)
    rank_n = np.zeros(n_ranks, np.int64)
    assign = np.empty(b, np.int64)
    for s in order:
        open_ranks = np.where(rank_n < q)[0]
        best = open_ranks[int(np.argmin(rank_load[open_ranks]))]
        h = home[s]
        if rank_n[h] < q and rank_load[h] <= rank_load[best] + _EPS:
            best = h
        assign[s] = best
        rank_load[best] += loads[s]
        rank_n[best] += 1
    if rank_load.max() >= rank_before.max() - _EPS:
        # quota-constrained LPT found nothing better: don't move bytes for
        # zero balance gain
        return np.arange(b), _stats(home, rank_before.max())
    perm = np.concatenate([np.where(assign == r)[0] for r in range(n_ranks)])
    return perm, _stats(assign, rank_load.max())
