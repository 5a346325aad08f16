"""Top-k MoE routing and the paper's routing matrices (port of
``repro/core/routing.py``).

The planner consumes ``A``, the (T, K) token-expert matrix, and the
token-node matrix ``B`` derived from it under a fixed expert placement.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ExpertPlacement:
    """Static placement of ``n_experts`` experts on ``ep`` expert-parallel
    lanes.  When ``n_experts >= ep`` each lane holds ``n_experts // ep``
    consecutive experts; when ``n_experts < ep`` each expert is replicated
    ``ep // n_experts`` times.  Lanes group into ``ep // node_size`` nodes."""

    n_experts: int
    ep: int
    node_size: int

    def __post_init__(self):
        if self.ep % self.node_size != 0:
            raise ValueError(f"ep={self.ep} not divisible by node_size={self.node_size}")
        if self.n_experts >= self.ep:
            if self.n_experts % self.ep != 0:
                raise ValueError(
                    f"n_experts={self.n_experts} not divisible by ep={self.ep}")
        elif self.ep % self.n_experts != 0:
            raise ValueError(
                f"ep={self.ep} not divisible by n_experts={self.n_experts} "
                "(replication requires an integer factor)")

    @property
    def n_nodes(self) -> int:
        return self.ep // self.node_size

    @property
    def experts_per_lane(self) -> int:
        return max(1, self.n_experts // self.ep)

    @property
    def replicas(self) -> int:
        """Number of lanes holding a copy of each expert (>= 1)."""
        return max(1, self.ep // self.n_experts)

    @property
    def max_replicas(self) -> int:
        """Largest per-expert replica count (uniform here; the table-driven
        ``relayout.TablePlacement`` has per-expert counts)."""
        return self.replicas

    def replica_count(self, expert_ids: torch.Tensor) -> torch.Tensor:
        """Per-assignment replica count (uniform for the arithmetic map)."""
        return torch.full_like(expert_ids, self.replicas)

    def lane_of_expert(self, expert_ids: torch.Tensor,
                       replica_choice: torch.Tensor | None = None) -> torch.Tensor:
        """Lane hosting ``expert_ids``; with replication ``replica_choice``
        in [0, replicas) picks the copy (replica r of expert e lives on lane
        e + r * n_experts)."""
        if self.n_experts >= self.ep:
            return expert_ids // self.experts_per_lane
        r = torch.zeros_like(expert_ids) if replica_choice is None else replica_choice
        return expert_ids + r * self.n_experts

    def node_of_lane(self, lane: torch.Tensor) -> torch.Tensor:
        return lane // self.node_size

    def local_expert_index(self, expert_ids: torch.Tensor,
                           replica_choice: torch.Tensor | None = None) -> torch.Tensor:
        """Index of the expert in its lane's local table (replica-invariant
        for this arithmetic placement)."""
        del replica_choice
        if self.n_experts >= self.ep:
            return expert_ids % self.experts_per_lane
        return torch.zeros_like(expert_ids)


def router_logits(x: torch.Tensor, w_router: torch.Tensor) -> torch.Tensor:
    """(T, d) x (d, E) -> (T, E) in float32."""
    return x.float() @ w_router.float()


def top_k_routing(logits: torch.Tensor, top_k: int, normalize: bool = True):
    """Softmax, then top-k, then (optionally) renormalise the k gates.
    Returns ``(A, gates)``: (T, K) int32 expert ids (descending probability)
    and (T, K) gates in the logits' dtype."""
    probs = torch.softmax(logits, dim=-1)
    gate, experts = torch.topk(probs, top_k, dim=-1)
    if normalize:
        gate = gate / gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return experts.to(torch.int32), gate.to(logits.dtype)


def token_node_matrix(A: torch.Tensor, placement,
                      replica_choice: torch.Tensor | None = None) -> torch.Tensor:
    """The paper's ``B`` matrix: destination node per (token, k) slot."""
    return placement.node_of_lane(placement.lane_of_expert(A, replica_choice))


def balanced_replica_choice(A: torch.Tensor, placement) -> torch.Tensor:
    """For replicated experts, round-robin each expert's assignments over its
    replicas in flattened (token, k) order.  Works for any placement exposing
    ``max_replicas`` / ``replica_count``: the arithmetic
    :class:`ExpertPlacement` (uniform replicas) and the table-driven
    ``relayout.TablePlacement`` (per-expert replica counts)."""
    if placement.max_replicas == 1:
        return torch.zeros_like(A)
    flat = A.reshape(-1).long()
    one_hot = torch.nn.functional.one_hot(flat, placement.n_experts)
    occ = one_hot.cumsum(0) - one_hot          # occurrences before this slot
    occ_of_slot = occ.gather(1, flat[:, None])[:, 0]
    return (occ_of_slot % placement.replica_count(flat).long()).reshape(
        A.shape).to(torch.int32)
