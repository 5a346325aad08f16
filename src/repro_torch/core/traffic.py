"""Online traffic statistics, the measurement half of adaptive placement
(port of ``repro/core/traffic.py``).

Two signals the load-balancing machinery needs, collected where each MoE
layer routes its tokens:

  * per-expert token counts: how hot each expert is (what the serving
    engines report per admission, and what a re-layout solver would act on);
  * per-lane cross-node send rows (node-deduplicated, as ``fused_hier``'s
    stage 1 sends them): the per-lane load Algorithm 1
    (``core/balancer.py``) partitions into communication groups.

The state is an explicit EMA accumulator (:class:`TrafficState`) threaded
through ``layers/moe.moe_block`` and the moe_tx stream like RNG state:
:func:`observe` is statically shaped, reads nothing to the host and
returns a new state.  It sums the step's counts with one ``all_reduce``
over the group it is given: the EP group, or on a (data, model) training
grid the whole grid, as the reference psums over the island's data and EP
axes.  Each rank folds its own tokens into its lane's rows, so the rows of
a lane sum over the data ranks holding it, and every rank carries the same
statistics.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.dcomm import group_size, process_group
from repro_torch.core.descriptors import group_counts
from repro_torch.core.routing import balanced_replica_choice

F32 = torch.float32


class TrafficState(NamedTuple):
    """EMA traffic accumulators (the same on every rank whose counts they
    sum).

    Leaves gain a leading ``(n_layers,)`` dim when stacked per layer
    (:func:`init_traffic_state` with ``n_layers``); each MoE layer threads
    its own slice, as it does its stacked parameters.
    """
    expert_ema: torch.Tensor       # (E,) EMA of per-step per-expert token counts
    lane_send_ema: torch.Tensor    # (EP,) EMA of per-lane cross-node send rows
    last_expert_count: torch.Tensor  # (E,) raw counts of the latest observation
    steps: torch.Tensor            # () int32 observations so far
    # Comm-path planning signals (``core/commplan.py``): ``lane_node_ema``
    # counts EVERY (token, k) assignment into its destination node (dense
    # flat wire rows, own-node column included), ``lane_cond_ema`` one row
    # per distinct (token, destination lane).  The node axis is padded to
    # EP so the shape never depends on the placement; columns at index >=
    # n_nodes stay zero.
    lane_node_ema: torch.Tensor    # (EP, EP) EMA assignment-level lane -> node rows
    lane_cond_ema: torch.Tensor    # (EP,) EMA condensed (token, dest-lane) rows


def init_traffic_state(n_experts: int, ep: int, n_layers: int | None = None,
                       device=None) -> TrafficState:
    lead = () if n_layers is None else (n_layers,)
    z = lambda *shape: torch.zeros(lead + shape, dtype=F32, device=device)
    return TrafficState(z(n_experts), z(ep), z(n_experts),
                        torch.zeros(lead, dtype=torch.int32, device=device),
                        z(ep, ep), z(ep))


def layers(state: TrafficState, i) -> TrafficState:
    """Layer ``i`` (an index or a slice) of a layer-stacked state."""
    return TrafficState(*(leaf[i] for leaf in state))


def stack(states) -> TrafficState:
    """The per-layer states of ``states`` stacked on a leading axis."""
    return TrafficState(*(torch.stack(leaves) for leaves in zip(*states)))


def concat(states) -> TrafficState:
    """Layer-stacked blocks of states joined along the layer axis."""
    return TrafficState(*(torch.cat(leaves) for leaves in zip(*states)))


def _ema_weights(decay: float) -> tuple[float, float]:
    """(d, 1 - d) as the reference computes them, in float32."""
    d = np.float32(decay)
    return float(d), float(np.float32(1) - d)


def observe(state: TrafficState, A: torch.Tensor, placement, src_lane: int,
            decay: float = 0.99, group=None,
            valid: torch.Tensor | None = None) -> TrafficState:
    """Fold one routing matrix into the EMA accumulators.

    ``A``: (T, K) token-expert matrix of this rank's tokens; ``src_lane``:
    this rank's lane on the EP axis; ``group``: the group the step's counts
    are summed over (the EP group or its ``dcomm.EPGroups``, or a grid's
    whole group), None for one rank; ``valid``: optional (T,) bool, rows with False (a serving
    prefill's left-pad positions) are routed like any other but counted in
    no accumulator.  Counts are integers derived from ``A``; nothing is
    read to the host.
    """
    t = A.shape[0]
    dev = A.device
    n_nodes, ep = placement.n_nodes, placement.ep
    a_rows = (A if valid is None else torch.where(valid[:, None], A, -1))
    e_cnt = group_counts(a_rows.reshape(-1), placement.n_experts).to(F32)

    replica = balanced_replica_choice(A, placement)
    lane = placement.lane_of_expert(A, replica).long()           # (T, K)
    node = placement.node_of_lane(lane)                           # (T, K)
    my_node = src_lane // placement.node_size
    # node-deduplicated (hier stage-1 rows): one per (token, remote node)
    nodes = torch.arange(n_nodes, device=dev)
    uses = (node[:, :, None] == nodes).any(dim=1)                 # (T, n_nodes)
    cross = (uses & (nodes != my_node)).sum(dim=1).to(F32)        # (T,)
    # lane-deduplicated (condensed-flat rows): one per (token, lane)
    cond = (lane[:, :, None] == torch.arange(ep, device=dev)).any(
        dim=1).sum(dim=1).to(F32)                                 # (T,)
    w_tk = torch.ones(node.shape, dtype=F32, device=dev)
    if valid is not None:
        valid_f = valid.to(F32)
        cross, cond = cross * valid_f, cond * valid_f
        w_tk = w_tk * valid_f[:, None]
    # this rank's tokens all come from src_lane: its row of each lane count
    lane_cnt = torch.zeros(ep, dtype=F32, device=dev)
    lane_cnt[src_lane] = cross.sum()
    cond_cnt = torch.zeros(ep, dtype=F32, device=dev)
    cond_cnt[src_lane] = cond.sum()
    node_cnt = torch.zeros(ep, ep, dtype=F32, device=dev)
    node_cnt[src_lane] = torch.zeros(ep, dtype=F32, device=dev).index_add_(
        0, node.reshape(-1), w_tk.reshape(-1))

    if group_size(group) > 1:
        n_e = e_cnt.shape[0]
        flat = torch.cat([e_cnt, lane_cnt, cond_cnt, node_cnt.reshape(-1)])
        dist.all_reduce(flat, group=process_group(group))
        e_cnt, lane_cnt, cond_cnt, node_cnt = (
            flat[:n_e], flat[n_e:n_e + ep], flat[n_e + ep:n_e + 2 * ep],
            flat[n_e + 2 * ep:].reshape(ep, ep))

    d, om = _ema_weights(decay)
    return TrafficState(
        expert_ema=state.expert_ema * d + e_cnt * om,
        lane_send_ema=state.lane_send_ema * d + lane_cnt * om,
        last_expert_count=e_cnt,
        steps=state.steps + 1,
        lane_node_ema=state.lane_node_ema * d + node_cnt * om,
        lane_cond_ema=state.lane_cond_ema * d + cond_cnt * om)


def has_stats(state: TrafficState) -> torch.Tensor:
    """Whether any observation has been folded in (gating for consumers)."""
    return state.steps > 0


def expert_loads(state: TrafficState, decay: float = 0.99) -> torch.Tensor:
    """Bias-corrected per-expert load estimate (EMA warm-up debiasing)."""
    d, _ = _ema_weights(decay)
    corr = 1.0 - torch.pow(d, state.steps.to(F32).clamp_min(1.0))
    return state.expert_ema / corr


def balancer_loads(state: TrafficState, placement) -> torch.Tensor:
    """Algorithm 1's input: (n_nodes, node_size) per-lane cross-node send
    load from the lane-send EMA.  On the all-zero cold state Algorithm 1
    still gives a valid grouping (stable argsort ties, then the per-node
    rotation), which is not ``static_assignment``'s table."""
    return state.lane_send_ema.reshape(placement.n_nodes, placement.node_size)
