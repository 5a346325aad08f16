"""MoE layer: the FUSCO-integrated expert-parallel feed-forward (port of
``repro/layers/moe.py``: ``moe_block`` and ``moe_decode_block``, without
traffic statistics, FSDP or pods).

The reference runs each layer in a shard_map island over the EP axis; here
each rank of the EP process group calls these functions on its own tokens.
Expert weights keep the reference's lane-major layout (EP, E_local, d, f) /
(EP, E_local, f, d): this rank uses lane ``rank in group`` of it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import fusco
from repro_torch.core.dcomm import DcommConfig, group_size, lane_index
from repro_torch.core.routing import (ExpertPlacement, balanced_replica_choice,
                                      router_logits, top_k_routing)
from repro_torch.kernels import ops as kops


def _lane_weights(moe_params, placement: ExpertPlacement,
                  group: dist.ProcessGroup | None):
    w1, w3, w2 = moe_params["w1"], moe_params["w3"], moe_params["w2"]
    if w1.shape[0] != placement.ep:
        raise ValueError(f"expert weights hold {w1.shape[0]} lanes, placement "
                         f"ep={placement.ep}")
    lane = lane_index(group)
    return w1[lane], w3[lane], w2[lane]


def moe_block(x: torch.Tensor, moe_params, *, placement: ExpertPlacement,
              dcfg: DcommConfig, top_k: int, norm_topk: bool = True,
              group: dist.ProcessGroup | None = None) -> torch.Tensor:
    """One MoE layer through the FUSCO shuffle.  x: (B, S, d), this rank's
    token shard; ``moe_params``: router (d, E) and lane-major w1/w3/w2."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    logits = router_logits(xt, moe_params["router"])
    A, gates = top_k_routing(logits, top_k, normalize=norm_topk)
    w1, w3, w2 = _lane_weights(moe_params, placement, group)
    y = fusco.shuffle_ffn(xt, A, gates.to(xt.dtype), w1, w3, w2, placement,
                          dcfg, group)
    return y.reshape(b, s, d)


def moe_decode_block(x: torch.Tensor, moe_params, *,
                     placement: ExpertPlacement, dcfg: DcommConfig,
                     top_k: int, norm_topk: bool = True,
                     group: dist.ProcessGroup | None = None) -> torch.Tensor:
    """Decode-side MoE, the replicated-token form: every rank routes all
    tokens, sends every token through every local expert (the fused SwiGLU
    kernel's (S=1, E_local, C=T, d) layout, all rows live), keeps the shares
    of the (token, k) assignments its lane hosts, and sums over the EP group.
    A one-token-per-lane all-to-all would be degenerate; the FUSCO engines
    serve the prefill."""
    del dcfg
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    logits = router_logits(xt, moe_params["router"])
    A, gates = top_k_routing(logits, top_k, norm_topk)
    replica = balanced_replica_choice(A, placement)
    lane = placement.lane_of_expert(A, replica)
    eloc = placement.local_expert_index(A, replica)
    w1, w3, w2 = _lane_weights(moe_params, placement, group)
    e_local = w1.shape[0]
    rows = xt[None, None].expand(1, e_local, *xt.shape)
    out_e = kops.fused_swiglu(rows, w1, w3, w2)[0].transpose(0, 1)  # (T, E_local, d)
    mask = (lane == lane_index(group))[..., None] & (
        eloc[..., None] == torch.arange(e_local, device=x.device))  # (T, K, E_local)
    w = (mask * gates[..., None]).sum(dim=1).to(out_e.dtype)      # (T, E_local)
    y = torch.einsum("ted,te->td", out_e, w)
    if group_size(group) > 1:
        dist.all_reduce(y, group=group)
    return y.reshape(b, s, d)
