"""Placement views of the load-adaptive re-layout (the part of
``repro/core/relayout.py`` the serving engines read: ``placement_table``,
``replica_counts`` and ``lane_loads``, host-side numpy).

The rest of the reference module, the ``TablePlacement`` of an arbitrary
expert -> (lane, slot) table, the greedy solver that packs measured expert
loads onto lanes and the lane-major weight migration between training
steps, is not ported yet: ROADMAP queue 1 item 6.  So the port's only
placement is the arithmetic ``routing.ExpertPlacement``, which these views
take.
"""

from __future__ import annotations

import numpy as np


def placement_table(placement) -> np.ndarray:
    """(ep, experts_per_lane) expert-id table view of a placement."""
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
    enforces round-robin); fed from ``traffic.TrafficState`` counts."""
    loads = np.asarray(expert_loads, np.float64)
    tbl = placement_table(placement)
    per_rep = loads / np.maximum(replica_counts(placement), 1)
    return per_rep[tbl].sum(axis=1)
