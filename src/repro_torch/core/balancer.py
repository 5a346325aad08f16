"""Online Load Balancer: the paper's Algorithm 1 (port of
``repro/core/balancer.py``).

Given per-lane cross-node send loads L (n_nodes, m_per_node), partition the
lanes into ``m_per_node`` *communication groups*, each holding exactly one
lane of every node, so as to minimise the largest group load.

Algorithm 1 (greedy, node-local):
  1. per node: sort the local lanes by load, descending -> permutation P_n
  2. rotate P_n circularly by n positions -> S_n
  3. group g_i = { S_n[i] : for every node n }

Each node's sorted permutation is shifted by its own offset, so the busiest
lane of each node lands in a different group.  The group a lane joins
decides which lane of every other node forwards its cross-node traffic
(``fused_hier``'s stage 1).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

I32 = torch.int32


def algorithm1_groups(loads: torch.Tensor) -> torch.Tensor:
    """Greedy group assignment.  ``loads``: (n_nodes, m) per-lane cross-node
    send volume.  Returns (n_nodes, m) int32: ``assignment[n, j]`` is the
    group of lane j of node n; each row is a permutation of [0, m)."""
    n_nodes, m = loads.shape
    # 1. sort descending: perm[n, i] = the lane with the i-th largest load
    perm = torch.argsort(-loads, dim=1, stable=True)
    # 2. circular shift by the node's index: S_n[i] = P_n[(i - n) mod m]
    ranks = torch.arange(m, device=loads.device)[None, :]
    node_ids = torch.arange(n_nodes, device=loads.device)[:, None]
    s = torch.gather(perm, 1, (ranks - node_ids) % m)          # group -> lane
    # 3. invert: assignment[n, lane] = group
    assignment = torch.empty((n_nodes, m), dtype=I32, device=loads.device)
    assignment.scatter_(1, s, ranks.expand(n_nodes, m).to(I32))
    return assignment


def group_loads(loads: torch.Tensor, assignment: torch.Tensor) -> torch.Tensor:
    """Total load of each group under an assignment."""
    m = loads.shape[1]
    out = torch.zeros((m,), dtype=loads.dtype, device=loads.device)
    return out.index_add(0, assignment.reshape(-1).long(), loads.reshape(-1))


def max_group_load(loads: torch.Tensor, assignment: torch.Tensor) -> torch.Tensor:
    return group_loads(loads, assignment).max()


def static_assignment(n_nodes: int, m: int, device=None) -> torch.Tensor:
    """The balancer-off baseline of §5.4: lanes grouped by equal local index."""
    return torch.arange(m, dtype=I32, device=device)[None, :].repeat(n_nodes, 1)


def brute_force_assignment(loads: np.ndarray) -> tuple[np.ndarray, float]:
    """Exact optimum by exhaustive search: a test oracle (tiny sizes only)."""
    n_nodes, m = loads.shape
    best, best_load = None, float("inf")
    for perms in itertools.product(itertools.permutations(range(m)),
                                   repeat=n_nodes - 1):
        assignment = np.zeros((n_nodes, m), np.int32)
        assignment[0] = np.arange(m)
        for n, p in enumerate(perms, start=1):
            assignment[n, list(p)] = np.arange(m)
        g = np.zeros(m)
        for n in range(n_nodes):
            for j in range(m):
                g[assignment[n, j]] += loads[n, j]
        if g.max() < best_load:
            best, best_load = assignment, float(g.max())
    return best, best_load


def forwarder_lane(assignment: torch.Tensor, my_node: int, my_lane: int,
                   dst_node: torch.Tensor) -> torch.Tensor:
    """Which lane of ``dst_node`` forwards the traffic of (my_node, my_lane):
    the member of my communication group in that node."""
    # (1,), not 0-d: indexing by a 0-d tensor reads it to the host
    group = assignment[my_node, my_lane].reshape(1)
    inv = torch.argsort(assignment, dim=1)          # (n, m): group -> lane
    return inv[dst_node.long(), group.long()].to(I32)
