"""FUSCO public API: the MoE shuffle plus expert compute (port of
``repro/core/fusco.py``: every engine, ``fused_flat`` with ``dedup``, the
cross-layer stream of consecutive MoE layers and the attention-separated
``moe_tx`` stream, each with per-layer barriers or streamed, with K token
micro-batch lanes interleaved through one schedule).

A model layer calls :func:`moe_shuffle_ffn` on this rank's (T, d) tokens and
its lane's expert weights, with the EP process group, and gets back the
combined expert outputs in token order.  :func:`layer_stream` chains N
consecutive MoE layers (:func:`pipe_layer_stream`: the combine of layer i in
flight into layer i+1's prologue; :func:`interleaved_layer_stream`: K lanes
round-robin, each lane's tail in flight while the next lanes compute);
:func:`tx_layer_stream` chains parallel attention+MoE blocks over this
rank's sequence stripe, its lanes batch chunks.
:func:`dense_moe_reference`, :func:`stream_dense_reference` and
:func:`tx_dense_reference` are the oracles the tests hold them to.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.core import dcomm
from repro_torch.core import traffic as traffic_lib
from repro_torch.core.dcomm import DcommConfig, DispatchResult
from repro_torch.core.routing import ExpertPlacement, router_logits, top_k_routing
from repro_torch.kernels import ops as kops
from repro_torch.layers.attention import gqa_project
from repro_torch.layers.common import apply_rope, rms_norm

_ENGINES = ("fused_flat", "fused_pipe", "fused_hier", "disagg", "ragged")


def _check_engine(cfg: DcommConfig) -> None:
    if cfg.engine not in _ENGINES:
        raise ValueError(f"unknown engine {cfg.engine!r}")


def swiglu_experts(rows: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                   w2: torch.Tensor,
                   counts: torch.Tensor | None = None) -> torch.Tensor:
    """Grouped SwiGLU FFN consuming the landed buffer in place.
    rows: (S, E_local, C, d); w1/w3: (E_local, d, f); w2: (E_local, f, d);
    counts: (S, E_local) landed occupancy, or None for all rows live."""
    return kops.fused_swiglu(rows, w1, w3, w2, counts)


def dispatch(x, A, gates, placement: ExpertPlacement, cfg: DcommConfig,
             assignment: torch.Tensor | None = None,
             group=None) -> DispatchResult:
    """``assignment``: the balancer's (n_nodes, node_size) group table for
    ``fused_hier``, ignored without ``use_balancer`` and by the other
    engines.  ``group``: the EP process group, or the :class:`dcomm.EPGroups`
    that ``fused_hier``'s nodes and a (pod, model) axis need (None: one
    lane)."""
    _check_engine(cfg)
    if cfg.engine == "fused_flat":
        if cfg.dedup:
            return dcomm.dedup_dispatch(x, A, gates, placement, cfg, group)
        return dcomm.flat_dispatch(x, A, gates, placement, cfg, group)
    if cfg.engine == "fused_pipe":
        return dcomm.pipe_dispatch(x, A, gates, placement, cfg, group)
    if cfg.engine == "fused_hier":
        return dcomm.hier_dispatch(x, A, gates, placement, cfg,
                                   assignment if cfg.use_balancer else None,
                                   group)
    if cfg.engine == "disagg":
        return dcomm.disagg_dispatch(x, A, gates, placement, cfg, group)
    return dcomm.ragged_dispatch(x, A, gates, placement, cfg, group)


def combine(expert_out, res: DispatchResult, placement: ExpertPlacement,
            cfg: DcommConfig, gates: torch.Tensor | None = None,
            group=None) -> torch.Tensor:
    """``gates`` are the routing's (T, K) gates, which ``disagg`` combines
    with; the other engines carry theirs in the plan."""
    _check_engine(cfg)
    if cfg.engine == "fused_flat":
        if cfg.dedup:
            return dcomm.dedup_combine(expert_out, res, placement, cfg, group)
        return dcomm.flat_combine(expert_out, res, placement, cfg, group)
    if cfg.engine == "fused_pipe":
        return dcomm.pipe_combine(expert_out, res, placement, cfg, group)
    if cfg.engine == "fused_hier":
        return dcomm.hier_combine(expert_out, res, placement, cfg, group)
    if cfg.engine == "disagg":
        return dcomm.disagg_combine(expert_out, res, placement, cfg, gates,
                                    group)
    return dcomm.ragged_combine(expert_out, res, placement, cfg, group)


def shuffle_ffn(x: torch.Tensor, A: torch.Tensor, gates: torch.Tensor,
                w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor,
                placement: ExpertPlacement, cfg: DcommConfig,
                assignment: torch.Tensor | None = None,
                group=None) -> torch.Tensor:
    """Shuffle + grouped FFN + combine for pre-computed routing.  For
    ``fused_pipe`` this is the sliced pipeline, the grouped FFN run per
    capacity slice inside the communication loop; the split
    dispatch()/combine() path stays for communication alone."""
    if cfg.engine == "fused_pipe":
        return dcomm.pipe_shuffle_ffn(
            x, A, gates, lambda rows, counts: swiglu_experts(rows, w1, w3, w2,
                                                             counts),
            placement, cfg, group)
    res = dispatch(x, A, gates, placement, cfg, assignment, group)
    out = swiglu_experts(res.expert_rows, w1, w3, w2, res.counts)
    return combine(out, res, placement, cfg, gates, group)


def moe_shuffle_ffn(x: torch.Tensor, w_router: torch.Tensor, w1: torch.Tensor,
                    w3: torch.Tensor, w2: torch.Tensor,
                    placement: ExpertPlacement, cfg: DcommConfig, top_k: int,
                    assignment: torch.Tensor | None = None,
                    norm_topk: bool = True, group=None) -> torch.Tensor:
    """Full fused MoE block: route -> dispatch -> grouped FFN -> combine.

    ``x`` is this rank's (T_local, d) tokens; the weights are this lane's
    experts (E_local, d, f)/(E_local, f, d); the router is replicated;
    ``assignment`` the balancer's group table (``fused_hier``); ``group``
    the EP process group or :class:`dcomm.EPGroups` (None: one lane)."""
    logits = router_logits(x, w_router)
    A, gates = top_k_routing(logits, top_k, normalize=norm_topk)
    return shuffle_ffn(x, A, gates.to(x.dtype), w1, w3, w2, placement, cfg,
                       assignment, group)


def dense_moe_reference(x: torch.Tensor, w_router: torch.Tensor,
                        w1_all: torch.Tensor, w3_all: torch.Tensor,
                        w2_all: torch.Tensor, top_k: int,
                        norm_topk: bool = True) -> torch.Tensor:
    """Oracle: per-token dense evaluation of the selected experts.
    ``w*_all`` hold ALL experts (E, d, f)/(E, f, d).  O(T*K*d*f): small
    configs only."""
    logits = router_logits(x, w_router)
    A, gates = top_k_routing(logits, top_k, normalize=norm_topk)
    e = A.long()
    xk = x[:, None, None, :]                                   # (T, 1, 1, d)
    h = (xk @ w1_all[e]).squeeze(2)                            # (T, K, f)
    u = (xk @ w3_all[e]).squeeze(2)
    y = ((torch.nn.functional.silu(h) * u)[:, :, None, :] @ w2_all[e]).squeeze(2)
    return (y * gates.to(x.dtype)[..., None]).sum(dim=1)


# ---------------------------------------------------------------------------
# Cross-layer stream (moe_ffn): per-layer barriers, or streamed
# ---------------------------------------------------------------------------

def _stream_layer_io(h: torch.Tensor, lp, top_k: int, norm_topk: bool):
    """The pre-shuffle work of one stream layer: the pre-norm (when ``lp``
    holds ``ln``) and the routing.  Returns (u, A, gates in h's dtype)."""
    u = rms_norm(h, lp["ln"]) if lp.get("ln") is not None else h
    A, gates = top_k_routing(router_logits(u, lp["router"]), top_k,
                             normalize=norm_topk)
    return u, A, gates.to(h.dtype)


def _stream_params(w_router, w1, w3, w2, ln) -> dict:
    """The stacked per-layer dict of a stream, ``ln`` folded in when given."""
    lp = {"router": w_router, "w1": w1, "w3": w3, "w2": w2}
    if ln is not None:
        lp["ln"] = ln
    return lp


def _lanes(x: torch.Tensor, k: int, why: str) -> list[torch.Tensor]:
    """``x`` split into ``k`` contiguous micro-batch lanes along dim 0;
    ``ValueError`` (the reference's message, ``why`` its reason) when ``k``
    does not divide it."""
    if x.shape[0] % k:
        raise ValueError(f"interleave={k} must divide this rank's "
                         f"{x.shape[0]} {why}")
    return list(torch.chunk(x, k)) if k > 1 else [x]


def _cat(parts: list[torch.Tensor]) -> torch.Tensor:
    """The lanes' parts joined in lane order (one lane: itself)."""
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def interleaved_layer_stream(x: torch.Tensor, w_router: torch.Tensor,
                             w1: torch.Tensor, w3: torch.Tensor,
                             w2: torch.Tensor, placement: ExpertPlacement,
                             cfg: DcommConfig, top_k: int,
                             ln: torch.Tensor | None = None,
                             norm_topk: bool = True, interleave: int = 2,
                             traffic=None, observe=None,
                             group: dist.ProcessGroup | None = None):
    """K token micro-batch lanes round-robin through ONE cross-layer
    schedule (the reference's fusco.py:231-316).  ``x`` (T, d) splits into
    K contiguous lanes of T/K tokens; at each layer, for lane j in turn,
    lane j's deferred tail (:class:`dcomm.PipeTail`) lands in its prologue,
    then its router and its sliced shuffle, which ends with its own tail
    slice's combine exchange in flight.  While lane j's tail is on the wire,
    lanes j+1..K-1 run their router and expert FFN; it lands only in lane
    j's prologue at the next layer, and every lane's last tail in an
    epilogue.  The lanes are concatenated in lane order, so the token order
    is ``x``'s.

    Capacity and the slice count are planned per lane (T/K tokens) with
    pipesim's interleaved knee (``dcomm.pipe_geometry(..., n_layers=N,
    interleave=K)``), one geometry frozen for every lane and layer.  Lanes
    never interact, so the result equals :func:`pipe_layer_stream`'s up to
    the order of the sums, and the oracle is :func:`stream_dense_reference`.
    Each lane holds its own tail, so over an EP group with autograd off
    each lane waits on its own exchange handle; under autograd a tail's
    scatter-add, taken in the lane's next prologue, carries its cotangent
    back to its own layer's expert weights and input.

    ``traffic``/``observe`` as in :func:`pipe_layer_stream`: each layer
    folds ONE observation, of the K lanes' routing concatenated.  Raises
    ``ValueError`` when K does not divide T."""
    if cfg.engine != "fused_pipe":
        raise ValueError(f"the interleaved stream requires "
                         f"engine='fused_pipe', got {cfg.engine!r}")
    kk = max(1, int(interleave))
    t, d = x.shape
    hs = _lanes(x, kk, "tokens (micro-batch lanes need identical static "
                "shapes)")
    tc = t // kk
    n_layers = w_router.shape[0]
    cap, ns = dcomm.pipe_geometry(tc, top_k, d, x.element_size(), placement,
                                  cfg, n_layers=n_layers, interleave=kk)
    cfg = dataclasses.replace(cfg, pipe_slices=ns)      # freeze the joint plan
    tails = dcomm.pipe_empty_tails(placement, cap // ns, d, tc, top_k,
                                   x.dtype, x.dtype, x.device, kk)
    trs = []
    for i, lp in enumerate(_unstack(_stream_params(w_router, w1, w3, w2, ln))):
        ffn = lambda rows, counts, lp=lp: swiglu_experts(
            rows, lp["w1"], lp["w3"], lp["w2"], counts)
        As = []
        for j in range(kk):               # round-robin over the lanes
            h = dcomm.pipe_tail_consume(hs[j], tails[j], tc)   # its prologue
            u, A, gates = _stream_layer_io(h, lp, top_k, norm_topk)
            hs[j], tails[j] = dcomm.pipe_shuffle_ffn_stream(
                u, A, gates, ffn, placement, cfg, y0=h, group=group)
            As.append(A)
        if traffic is not None:
            trs.append(observe(traffic_lib.layers(traffic, i), _cat(As)))
    # epilogue: every lane's last tail
    h = _cat([dcomm.pipe_tail_consume(h, tail, tc)
              for h, tail in zip(hs, tails)])
    return h if traffic is None else (h, traffic_lib.stack(trs))


def pipe_layer_stream(x: torch.Tensor, w_router: torch.Tensor,
                      w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor,
                      placement: ExpertPlacement, cfg: DcommConfig,
                      top_k: int, ln: torch.Tensor | None = None,
                      norm_topk: bool = True, traffic=None, observe=None,
                      group: dist.ProcessGroup | None = None):
    """Chain N consecutive MoE layers, ``h <- h + moe_l(rms_norm_l(h))``,
    through one pipelined schedule (the reference's fusco.py:150-228): the
    interleaved stream at K = 1.  ``x`` is this rank's (T, d) tokens;
    ``w_router`` (N, d, E) replicated; ``w1``/``w3`` (N, E_local, d, f) and
    ``w2`` (N, E_local, f, d) this lane's experts; ``ln`` the (N, d)
    pre-norm scales or None.

    Each layer's shuffle ends with its tail slice's combine exchange in
    flight (:class:`dcomm.PipeTail`); the tail's scatter-add lands in the
    next layer's prologue, before its router, and the last one in an
    epilogue; the stream starts from an empty tail.  The residual seeds
    each layer's accumulator (``y0``).  One slice count serves the chain,
    pipesim's joint knee for N layers (``dcomm.pipe_geometry(...,
    n_layers=N)``), frozen into the config.  Under autograd a deferred
    tail's scatter-add, taken in the next layer's prologue, carries its
    cotangent back to its own layer's expert weights and input.

    ``traffic``: a layer-stacked (N, ...) ``traffic.TrafficState``;
    ``observe(state, A)`` folds each layer's routing into its slice; then
    returns ``(h, new_traffic)``."""
    return interleaved_layer_stream(x, w_router, w1, w3, w2, placement, cfg,
                                    top_k, ln=ln, norm_topk=norm_topk,
                                    interleave=1, traffic=traffic,
                                    observe=observe, group=group)


def layer_stream(x: torch.Tensor, w_router: torch.Tensor, w1: torch.Tensor,
                 w3: torch.Tensor, w2: torch.Tensor,
                 placement: ExpertPlacement, cfg: DcommConfig, top_k: int,
                 ln: torch.Tensor | None = None, norm_topk: bool = True,
                 interleave: int = 1, traffic=None, observe=None,
                 group: dist.ProcessGroup | None = None):
    """The stream's dispatch table (the reference's fusco.py:544-578): with
    the ``fused_pipe`` engine the cross-layer schedule, its ``interleave``
    micro-batch lanes round-robin (:func:`interleaved_layer_stream`; K = 1
    is :func:`pipe_layer_stream`), else per-layer barriers, each layer a
    full :func:`shuffle_ffn` through any engine, which ignore
    ``interleave`` (the lanes are a property of the pipelined schedule).
    Same arguments and result as :func:`pipe_layer_stream`."""
    if cfg.engine == "fused_pipe":
        return interleaved_layer_stream(
            x, w_router, w1, w3, w2, placement, cfg, top_k, ln=ln,
            norm_topk=norm_topk, interleave=interleave, traffic=traffic,
            observe=observe, group=group)
    h, trs = x, []
    for i, lp in enumerate(_unstack(_stream_params(w_router, w1, w3, w2, ln))):
        u, A, gates = _stream_layer_io(h, lp, top_k, norm_topk)
        if traffic is not None:
            trs.append(observe(traffic_lib.layers(traffic, i), A))
        h = h + shuffle_ffn(u, A, gates, lp["w1"], lp["w3"], lp["w2"],
                            placement, cfg, group=group)
    return h if traffic is None else (h, traffic_lib.stack(trs))


def stream_dense_reference(x: torch.Tensor, w_router: torch.Tensor,
                           w1_all: torch.Tensor, w3_all: torch.Tensor,
                           w2_all: torch.Tensor, top_k: int,
                           ln: torch.Tensor | None = None,
                           norm_topk: bool = True) -> torch.Tensor:
    """Oracle for the layer stream: the same residual chain through the
    per-token dense reference; ``w*_all`` hold ALL experts, (N, E, d, f) /
    (N, E, f, d)."""
    h = x
    for lp in _unstack(_stream_params(w_router, w1_all, w3_all, w2_all, ln)):
        u = rms_norm(h, lp["ln"]) if ln is not None else h
        h = h + dense_moe_reference(u, lp["router"], lp["w1"], lp["w3"],
                                    lp["w2"], top_k, norm_topk=norm_topk)
    return h


# ---------------------------------------------------------------------------
# Attention-separated stream (moe_tx): per-layer barriers, or streamed
# ---------------------------------------------------------------------------

def tx_attention(h: torch.Tensor, lp, pos_q: torch.Tensor,
                 pos_k: torch.Tensor, *, n_heads: int, n_kv: int,
                 head_dim: int, rope_theta: float = 1e6,
                 group: dist.ProcessGroup | None = None,
                 return_kv: bool = False):
    """Attention sub-layer of a ``moe_tx`` parallel block.

    ``h`` is (b, s_local, d), this rank's stripe of the sequence.  q/k/v are
    projected from the local rows and RoPE'd at their absolute positions
    ``pos_q``; k and v are all-gathered along the sequence over the EP
    ``group`` (the identity, with no collective, for one lane); the flash
    attention masks the shifted stripe from the actual positions.
    ``return_kv`` also returns the gathered, RoPE'd (k, v), the same on every
    rank."""
    u = rms_norm(h, lp["ln1"])
    q, k, v = gqa_project(u, lp["wq"], lp["wk"], lp["wv"], n_heads, n_kv,
                          head_dim)
    q = apply_rope(q, pos_q, rope_theta)
    k = dcomm.all_gather_seq(apply_rope(k, pos_q, rope_theta), group)
    v = dcomm.all_gather_seq(v, group)
    a = kops.flash_attention(q, k, v, pos_q, pos_k, causal=True)
    b, s = h.shape[0], h.shape[1]
    out = a.reshape(b, s, n_heads * head_dim) @ lp["wo"]
    if return_kv:
        return out, (k, v)
    return out


def _tx_attn_cost_s(tc: int, s_l: int, bc: int, s_glob: int, n_heads: int,
                    head_dim: int, itemsize: int, cfg: DcommConfig) -> float:
    """Planning proxy for the attention window filler: the byte volume the
    attention block moves through the staging tier (q/k/v/o activations +
    f32 score/prob tiles), converted to seconds at the config's staging
    bandwidth.  Deliberately coarse: it only has to place the pipesim knee,
    not predict wall clock."""
    attn_bytes = (4.0 * tc * n_heads * head_dim * itemsize
                  + 2.0 * 4.0 * bc * n_heads * s_l * s_glob)
    return attn_bytes / cfg.pipe_stage_bw


def _unstack(params) -> list[dict]:
    """The per-layer dicts of a stacked (N, ...) parameter dict, each leaf
    split with one ``torch.unbind``: its backward stacks the N layers'
    gradients once, where indexing each layer would zero-fill a gradient of
    the whole stack per layer and add the N of them."""
    keys = list(params)
    return [dict(zip(keys, ws))
            for ws in zip(*(torch.unbind(params[k]) for k in keys))]


def tx_layer_stream(x: torch.Tensor, positions: torch.Tensor, params,
                    placement: ExpertPlacement, cfg: DcommConfig, top_k: int,
                    *, n_heads: int, n_kv: int, head_dim: int,
                    rope_theta: float = 1e6, norm_topk: bool = True,
                    interleave: int = 1, traffic=None, observe=None,
                    return_kv: bool = False, kv_out=None,
                    group: dist.ProcessGroup | None = None):
    """Chain N parallel attention+MoE blocks,
    ``h <- h + attn(rms_norm(h, ln1)) + moe(rms_norm(h, ln2))``.

    With the ``fused_pipe`` engine, the blocks run through one schedule
    (the reference's fusco.py:453-519): the batch splits into ``interleave``
    micro-batch lanes of b/K rows, and at each layer, for lane j in turn,
    lane j's tail lands in its prologue, its MoE shuffle is issued FIRST and
    ends with its tail slice's combine exchange in flight
    (:class:`dcomm.PipeTail`), then its attention, which reads the block
    input and not the tail, runs while it is on the wire (and lanes
    j+1..K-1's whole blocks after it); the tail lands in lane j's next
    prologue, and every lane's last one in an epilogue.  One slice count
    serves every lane and layer, from :func:`pipesim.plan_tx_stream` with
    the attention cost proxy :func:`_tx_attn_cost_s` of one lane.  With
    any other engine every layer ends in a full barrier (the reference's
    fusco.py:426-451), which ignores ``interleave``.  Both differentiate:
    under autograd each slice's exchange is the synchronous one
    (``dcomm._pipe_exchange``), and a deferred tail's scatter-add, taken in
    the lane's next prologue, carries its cotangent back to its own layer's
    expert weights and input.

    ``x`` is (b, s_local, d), this rank's stripe of the sequence (lane
    ``rank in group``); ``positions`` the full (S,) absolute positions;
    ``params`` the stacked per-layer dict ``{ln1, wq, wk, wv, wo, ln2,
    router, w1, w3, w2}`` (attention weights replicated, expert weights this
    lane's (N, E_local, ...)).  ``traffic``: a layer-stacked (N, ...)
    ``traffic.TrafficState``; ``observe(state, A)`` folds each layer's
    routing into its slice, after the router in the barrier branch and at
    the end of the layer, over the K lanes' routing concatenated, in the
    streamed one, as the reference.  Returns ``h``, then with ``traffic``
    the new state, then with ``return_kv`` the per-layer gathered RoPE'd
    (k, v) stacks (N, b, S, n_kv, hd), lane j's rows ``[j b/K, (j+1)
    b/K)``: fresh ones, or ``kv_out``, a pair of such stacks written in
    place.  Raises ``ValueError`` when K does not divide b on the
    streamed path."""
    b, s_l, d = x.shape
    chunk = dcomm.lane_index(group)
    pos_q = positions[chunk * s_l:(chunk + 1) * s_l]
    attn_kw = dict(n_heads=n_heads, n_kv=n_kv, head_dim=head_dim,
                   rope_theta=rope_theta, group=group, return_kv=return_kv)
    ks, vs, trs = [], [], []

    def keep_kv(i, row0, kv):
        k, v = kv
        if kv_out is None:
            ks[i].append(k)
            vs[i].append(v)
        else:
            kv_out[0][i][row0:row0 + k.shape[0]].copy_(k)
            kv_out[1][i][row0:row0 + k.shape[0]].copy_(v)

    def finish(h):
        out = (h,)
        if traffic is not None:
            out += (traffic_lib.stack(trs),)
        if return_kv:
            out += (kv_out if kv_out is not None else
                    (torch.stack([_cat(k) for k in ks]),
                     torch.stack([_cat(v) for v in vs])),)
        return out[0] if len(out) == 1 else out

    if cfg.engine != "fused_pipe":        # per-layer barriers, any engine
        h = x
        for i, lp in enumerate(_unstack(params)):
            ks.append([])
            vs.append([])
            u2 = rms_norm(h, lp["ln2"]).reshape(b * s_l, d)
            A, gates = top_k_routing(router_logits(u2, lp["router"]), top_k,
                                     normalize=norm_topk)
            if traffic is not None:
                trs.append(observe(traffic_lib.layers(traffic, i), A))
            y = shuffle_ffn(u2, A, gates.to(h.dtype), lp["w1"], lp["w3"],
                            lp["w2"], placement, cfg, group=group)
            a = tx_attention(h, lp, pos_q, positions, **attn_kw)
            if return_kv:
                a, kv = a
                keep_kv(i, 0, kv)
            h = h + a + y.reshape(b, s_l, d)
        return finish(h)

    kk = max(1, int(interleave))
    hs = _lanes(x, kk, "batch rows (micro-batch lanes are batch chunks)")
    bc = b // kk
    tc = bc * s_l
    n_layers = params["router"].shape[0]
    attn_s = _tx_attn_cost_s(tc, s_l, bc, positions.shape[0], n_heads,
                             head_dim, x.element_size(), cfg)
    cap, ns = dcomm.pipe_geometry(tc, top_k, d, x.element_size(), placement,
                                  cfg, n_layers=n_layers, interleave=kk,
                                  attn_s=attn_s)
    cfg = dataclasses.replace(cfg, pipe_slices=ns)       # freeze the joint plan
    tails = dcomm.pipe_empty_tails(placement, cap // ns, d, tc, top_k,
                                   x.dtype, x.dtype, x.device, kk)
    for i, lp in enumerate(_unstack(params)):
        ks.append([])
        vs.append([])
        ffn = lambda rows, counts, lp=lp: swiglu_experts(
            rows, lp["w1"], lp["w3"], lp["w2"], counts)
        As = []
        for j in range(kk):               # round-robin over the lanes
            # prologue: lane j's previous tail lands, then its router
            ht = dcomm.pipe_tail_consume(hs[j].reshape(tc, d), tails[j], tc)
            h = ht.reshape(bc, s_l, d)
            u2 = rms_norm(h, lp["ln2"]).reshape(tc, d)
            A, gates = top_k_routing(router_logits(u2, lp["router"]), top_k,
                                     normalize=norm_topk)
            # the MoE issued first; its tail rides across the attention
            y, tails[j] = dcomm.pipe_shuffle_ffn_stream(
                u2, A, gates.to(h.dtype), ffn, placement, cfg, y0=ht,
                group=group)
            a = tx_attention(h, lp, pos_q, positions, **attn_kw)
            if return_kv:
                a, kv = a
                keep_kv(i, j * bc, kv)
            hs[j] = y.reshape(bc, s_l, d) + a
            As.append(A)
        if traffic is not None:
            trs.append(observe(traffic_lib.layers(traffic, i), _cat(As)))
    # epilogue: every lane's last tail
    hs = [dcomm.pipe_tail_consume(h.reshape(tc, d), tail, tc).reshape(
        bc, s_l, d) for h, tail in zip(hs, tails)]
    return finish(_cat(hs))


def tx_dense_reference(x: torch.Tensor, positions: torch.Tensor, params,
                       top_k: int, *, n_heads: int, n_kv: int, head_dim: int,
                       rope_theta: float = 1e6,
                       norm_topk: bool = True) -> torch.Tensor:
    """Oracle for the attention-separated stream: the same parallel chain
    with full-sequence attention and the per-token dense MoE.  ``params``
    holds ALL experts per layer (w1/w3 (N, E, d, f), w2 (N, E, f, d));
    ``x`` is the full (b, S, d) batch."""
    b, s, d = x.shape
    h = x
    for lp in _unstack(params):
        a = tx_attention(h, lp, positions, positions, n_heads=n_heads,
                         n_kv=n_kv, head_dim=head_dim, rope_theta=rope_theta)
        u2 = rms_norm(h, lp["ln2"]).reshape(b * s, d)
        m = dense_moe_reference(u2, lp["router"], lp["w1"], lp["w3"],
                                lp["w2"], top_k, norm_topk=norm_topk)
        h = h + a + m.reshape(b, s, d)
    return h
