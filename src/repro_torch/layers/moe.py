"""MoE layer: the FUSCO-integrated expert-parallel feed-forward (port of
``repro/layers/moe.py``: ``moe_block``, ``stream_moe_layers``,
``stream_tx_layers`` and ``moe_decode_block``, with the online traffic
statistics and the reference's FSDP of the expert weights).

The reference runs each layer in a shard_map island over the EP axis, with
the batch's sequence sharded over it; here each rank of the EP process group
calls these functions on its own stripe of the sequence.  ``group`` is that
group, or the ``dcomm.EPGroups`` of it that ``fused_hier``'s nodes and a
(pod, model) axis need.
Expert weights keep the reference's lane-major layout (lanes, E_local, d, f)
/ (lanes, E_local, f, d), holding this rank's lane alone (lanes = 1: what
``models/lm.init_params`` and ``lm.shard_params`` give a rank of an EP
group, and the one lane of EP 1).

``fsdp``: the data group the expert leaves' f dim is split over (the
reference's ``fsdp_experts``, ZeRO-3 of the experts; None: held whole).
Each leaf is all-gathered over it once a layer (or a stream block), just
before the shuffle, and its gradient comes back reduce-scattered (summed)
into the rank's slice (``dcomm.gather_dim``).  What the forward saves for
the backward of a gathered weight is kept as the slice and gathered again
when the backward reads it (:func:`_fsdp_gathered`), so no layer's gathered
weights outlive its forward, as the reference's remat re-gathers them.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from repro_torch.core import balancer as balancer_lib
from repro_torch.core import dcomm, fusco
from repro_torch.core import traffic as traffic_lib
from repro_torch.core.dcomm import (DcommConfig, _lane_index, group_size,
                                    lane_index, process_group)
from repro_torch.core.routing import (ExpertPlacement, balanced_replica_choice,
                                      router_logits, top_k_routing)
from repro_torch.kernels import ops as kops
from repro_torch.parallel.sharding import FSDP_DIM

EXPERTS = ("w1", "w3", "w2")


def _own_lane(lanes: int) -> None:
    """Refuses expert weights of other than one lane, this rank's own."""
    if lanes != 1:
        raise ValueError(
            f"expert weights hold {lanes} lanes; a rank holds its own lane "
            "alone (cut a whole tree with models.lm.shard_params)")


def _lane_weights(moe_params):
    w1, w3, w2 = (moe_params[w] for w in EXPERTS)
    _own_lane(w1.shape[0])
    return w1[0], w3[0], w2[0]


def _fsdp_key(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


@contextlib.contextmanager
def _fsdp_gathered(moe_params, fsdp):
    """``moe_params`` with its expert leaves gathered over the data group
    ``fsdp`` (``dcomm.gather_dim`` on each leaf's f dim; as they are for
    None or a group of one rank: no gather, no copy).  While open, a tensor
    that autograd saves and that views a gathered leaf is packed as
    (leaf, view) and unpacked by gathering the leaf's slice again, once for
    all the views the backward reads of it, so the gathered weights are
    freed with the forward."""
    if fsdp is None or dist.get_world_size(fsdp) == 1:
        yield moe_params
        return
    full = {w: dcomm.gather_dim(moe_params[w], FSDP_DIM[f"layers/moe/{w}"],
                                fsdp) for w in EXPERTS}
    owner = {_fsdp_key(t): w for w, t in full.items()}
    packed, again = {}, {}

    def pack(t):
        w = owner.get(_fsdp_key(t))
        if w is None:
            return t
        packed[w] = packed.get(w, 0) + 1
        return w, t.size(), t.stride(), t.storage_offset()

    def unpack(p):
        if isinstance(p, torch.Tensor):
            return p
        w, size, stride, offset = p
        if w not in again:
            with torch.no_grad():
                again[w] = dcomm.all_gather_dim(
                    moe_params[w].detach(), FSDP_DIM[f"layers/moe/{w}"], fsdp)
        t = again[w]
        packed[w] -= 1
        if packed[w] == 0:
            del again[w]
        return t.as_strided(size, stride, offset)

    with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
        yield {**moe_params, **full}


def moe_block(x: torch.Tensor, moe_params, *, placement: ExpertPlacement,
              dcfg: DcommConfig, top_k: int, norm_topk: bool = True,
              group=None, traffic: traffic_lib.TrafficState | None = None,
              traffic_decay: float = 0.99,
              traffic_mask: torch.Tensor | None = None, stats_group=None,
              fsdp=None):
    """One MoE layer through the FUSCO shuffle.  x: (B, S, d), this rank's
    token shard; ``moe_params``: router (d, E) and lane-major w1/w3/w2,
    their f dim split over the data group ``fsdp`` (None: whole).

    ``traffic`` threads this layer's traffic statistics through the layer
    (state in, new state out): the routing matrix is folded into the EMA
    over ``stats_group`` (None: the EP group; a (data, model) grid's
    whole group, as the reference psums over both axes), and with
    ``fused_hier`` and ``use_balancer`` Algorithm 1 takes the EMA lane-send
    loads in place of the static grouping (``repro/layers/moe.py:90-98``).
    ``traffic_mask``: (B, S) bool, this rank's stripe like ``x``; masked
    positions are routed but not counted.  Returns ``(y, new_traffic)`` when ``traffic`` is given,
    ``y`` otherwise."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    logits = router_logits(xt, moe_params["router"])
    A, gates = top_k_routing(logits, top_k, normalize=norm_topk)
    assignment = None
    if traffic is not None:
        traffic = traffic_lib.observe(
            traffic, A, placement, _lane_index(dcfg, group),
            decay=traffic_decay,
            group=group if stats_group is None else stats_group,
            valid=None if traffic_mask is None else traffic_mask.reshape(b * s))
        if dcfg.engine == "fused_hier" and dcfg.use_balancer:
            assignment = balancer_lib.algorithm1_groups(
                traffic_lib.balancer_loads(traffic, placement))
    with _fsdp_gathered(moe_params, fsdp) as mp:
        w1, w3, w2 = _lane_weights(mp)
        y = fusco.shuffle_ffn(xt, A, gates.to(xt.dtype), w1, w3, w2,
                              placement, dcfg, assignment=assignment,
                              group=group)
    y = y.reshape(b, s, d)
    return y if traffic is None else (y, traffic)


def _stream_lane(moe_params) -> dict:
    """This lane's stacked (N, E_local, ...) experts of a block's lane-major
    (N, 1, E_local, ...) leaves: a view whose backward is the gradient
    itself (indexing would zero-fill a stack-sized gradient)."""
    _own_lane(moe_params["w1"].shape[1])
    return {w: moe_params[w].squeeze(1) for w in EXPERTS}


def _stream_observe(x: torch.Tensor, placement: ExpertPlacement,
                    dcfg: DcommConfig, traffic_decay: float, traffic_mask,
                    group, stats_group):
    """The closure that folds one layer's routing of this rank's stripe
    ``x`` (B, S/ep, ...) into its traffic slice, summed over
    ``stats_group`` (None: the EP group); masked positions not counted."""
    b, s = x.shape[:2]
    valid = None if traffic_mask is None else traffic_mask.reshape(b * s)
    my_lane = _lane_index(dcfg, group)
    counted = group if stats_group is None else stats_group
    return lambda st, A: traffic_lib.observe(
        st, A, placement, my_lane, decay=traffic_decay, group=counted,
        valid=valid)


def _check_lanes(interleave: int, b: int) -> None:
    """The micro-batch lanes are batch chunks: ``interleave`` must divide
    this rank's batch ``b`` (the reference's moe.py:176-180)."""
    if interleave > 1 and b % interleave:
        raise ValueError(
            f"moe stream interleave={interleave} must divide the rank's "
            f"batch {b} (micro-batch lanes are batch chunks)")


def stream_moe_layers(x: torch.Tensor, moe_params, ln: torch.Tensor | None,
                      *, placement: ExpertPlacement, dcfg: DcommConfig,
                      top_k: int, norm_topk: bool = True, fsdp=None,
                      interleave: int = 1,
                      traffic: traffic_lib.TrafficState | None = None,
                      traffic_decay: float = 0.99,
                      traffic_mask: torch.Tensor | None = None, group=None,
                      stats_group=None):
    """A block of N consecutive MoE layers (the ``moe_ffn`` island, the
    reference's moe.py:115-216), ``h <- h + moe_l(rms_norm_l(h))`` each,
    evaluated by ``fusco.layer_stream``: one streamed schedule when the
    engine is ``fused_pipe`` (``interleave`` micro-batch lanes of B/K rows
    round-robin through it), else per-layer barriers.
    ``x``: (B, S/ep, d), this rank's stripe of the sequence, flattened
    b-major into the stream's tokens, so the stream's contiguous token
    lanes are the batch chunks and the flattened ``traffic_mask`` lines up
    with the lanes' concatenated routing at any K; ``moe_params``: stacked router (N, d,
    E) and lane-major w1/w3/w2 (N, lanes, E_local, ...), this rank's lane
    alone (lanes = 1), their f dim split over the data group ``fsdp``
    (None: whole); ``ln``: the (N, d) pre-norm scales or
    None.  ``traffic``: the block's layer-stacked (N, ...)
    ``TrafficState``; ``traffic_mask`` (B, S/ep) and ``stats_group`` as in
    :func:`moe_block`.  Returns ``y`` (B, S/ep, d), with ``traffic`` then
    the new state."""
    b, s, d = x.shape
    _check_lanes(interleave, b)
    observe = None if traffic is None else _stream_observe(
        x, placement, dcfg, traffic_decay, traffic_mask, group, stats_group)
    with _fsdp_gathered(moe_params, fsdp) as mp:
        w = _stream_lane(mp)
        y = fusco.layer_stream(
            x.reshape(b * s, d), moe_params["router"], w["w1"], w["w3"],
            w["w2"], placement, dcfg, top_k, ln=ln, norm_topk=norm_topk,
            interleave=interleave, traffic=traffic, observe=observe,
            group=group)
    if traffic is None:
        return y.reshape(b, s, d)
    return y[0].reshape(b, s, d), y[1]


def stream_tx_layers(x: torch.Tensor, moe_params, attn_params,
                     ln1: torch.Tensor, ln2: torch.Tensor, *,
                     placement: ExpertPlacement, dcfg: DcommConfig,
                     top_k: int, positions: torch.Tensor, n_heads: int,
                     n_kv: int, head_dim: int, rope_theta: float = 1e6,
                     norm_topk: bool = True, fsdp=None,
                     interleave: int = 1,
                     traffic: traffic_lib.TrafficState | None = None,
                     traffic_decay: float = 0.99,
                     traffic_mask: torch.Tensor | None = None,
                     return_kv: bool = False, kv_out=None, group=None,
                     stats_group=None):
    """A block of N attention+MoE layers (the ``moe_tx`` island), evaluated
    by ``fusco.tx_layer_stream``: one streamed schedule when the engine is
    ``fused_pipe`` (``interleave`` micro-batch lanes of B/K rows round-robin
    through it), else per-layer barriers.  ``x``: (B, S/ep,
    d), this rank's stripe of the sequence; ``positions``: the full (S,) positions; ``moe_params``:
    stacked router (N, d, E) and lane-major w1/w3/w2 (N, EP, E_local, ...);
    ``attn_params`` {wq, wk, wv, wo} stacked and replicated; ``ln1``/``ln2``
    (N, d).  ``traffic``: the block's layer-stacked (N, ...)
    ``TrafficState``, each layer's routing folded into its slice;
    ``traffic_mask`` (B, S/ep) and ``stats_group`` as in
    :func:`moe_block`.  The expert leaves hold this rank's lane alone (N,
    1, E_local, ...), their f dim split over the data group ``fsdp`` (None:
    whole).
    Returns ``y``, then the new traffic when given, then with ``return_kv``
    the per-layer gathered (k, v) stacks (N, B, S, n_kv, hd), written into
    ``kv_out`` when given."""
    _check_lanes(interleave, x.shape[0])
    observe = None if traffic is None else _stream_observe(
        x, placement, dcfg, traffic_decay, traffic_mask, group, stats_group)
    with _fsdp_gathered(moe_params, fsdp) as mp:
        params = {"ln1": ln1, "ln2": ln2, **attn_params,
                  "router": moe_params["router"], **_stream_lane(mp)}
        return fusco.tx_layer_stream(
            x, positions, params, placement, dcfg, top_k, n_heads=n_heads,
            n_kv=n_kv, head_dim=head_dim, rope_theta=rope_theta,
            norm_topk=norm_topk, interleave=interleave,
            traffic=traffic, observe=observe, return_kv=return_kv,
            kv_out=kv_out, group=group)


def moe_decode_block(x: torch.Tensor, moe_params, *,
                     placement: ExpertPlacement, dcfg: DcommConfig,
                     top_k: int, norm_topk: bool = True,
                     group=None, fsdp=None) -> torch.Tensor:
    """Decode-side MoE, the replicated-token form: every rank routes all
    tokens, sends every token through every local expert (the fused SwiGLU
    kernel's (S=1, E_local, C=T, d) layout, all rows live), keeps the shares
    of the (token, k) assignments its lane hosts, and sums over the EP group.
    A one-token-per-lane all-to-all would be degenerate; the FUSCO engines
    serve the prefill.  ``fsdp``: as in :func:`moe_block`."""
    del dcfg
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    logits = router_logits(xt, moe_params["router"])
    A, gates = top_k_routing(logits, top_k, norm_topk)
    replica = balanced_replica_choice(A, placement)
    lane = placement.lane_of_expert(A, replica)
    eloc = placement.local_expert_index(A, replica)
    with _fsdp_gathered(moe_params, fsdp) as mp:
        w1, w3, w2 = _lane_weights(mp)
        e_local = w1.shape[0]
        rows = xt[None, None].expand(1, e_local, *xt.shape)
        out_e = kops.fused_swiglu(rows, w1, w3, w2)[0].transpose(0, 1)  # (T, E_local, d)
    mask = (lane == lane_index(group))[..., None] & (
        eloc[..., None] == torch.arange(e_local, device=x.device))  # (T, K, E_local)
    w = (mask * gates[..., None]).sum(dim=1).to(out_e.dtype)      # (T, E_local)
    y = torch.einsum("ted,te->td", out_e, w)
    if group_size(group) > 1:
        dist.all_reduce(y, group=process_group(group))
    return y.reshape(b, s, d)
