"""dComm, the data-fused communication engine (port of
``repro/core/dcomm.py``: all five engines and the condensed wire).

- ``fused_flat``: ONE descriptor-driven gather stages tokens straight into
  (destination lane x local expert x capacity) sub-slots; the tiled
  all-to-all lands every token already expert-grouped, the FFN consumes it
  in place, and the combine scatter-adds straight home.  With ``dedup`` the
  wire carries one row per (token, destination lane) instead, expanded on
  the landing lane from piggybacked (expert, gate) metadata
  (:func:`dedup_dispatch`).
- ``fused_pipe``: the same flat plan, its staging buffer split into S slices
  along the capacity axis and streamed: slice i's grouped FFN and combine
  run while slice i+1's gather and exchange are in flight (the paper's
  producer/consumer ring, Fig. 5).  S comes from ``pipesim.plan_slices`` at
  the config's hardware point, or the ``pipe_slices`` knob.  The slice
  primitives are split into issue and consume halves, so a shuffle can end
  with its tail slice's combine exchange still in flight (:class:`PipeTail`),
  which ``fusco.tx_layer_stream`` carries across an attention block and
  the interleaved streams hold one per micro-batch lane
  (:func:`pipe_empty_tails`).
- ``fused_hier``: node-level forwarding with dedup (one row per token per
  destination node, to the forwarder lane the Online Load Balancer picks),
  then the expert-level expansion on the forwarder and a second exchange
  within the node; the combine pre-reduces each node's partials on the
  forwarder, so the slow tier carries deduplicated rows both ways.
- ``disagg``: the paper's disaggregated baseline (§2.3): a materialised
  sort by destination lane, the exchange, a second sort by expert, the FFN,
  and the inverse passes, each a plain torch permutation.
- ``ragged``: no capacity padding on the wire: the compact rows go out
  through ``all_to_all_single`` with per-peer split sizes, which needs the
  sizes on the host, one device-to-host read per shuffle (the combine
  reuses them, swapped); with one lane there is no exchange and no read.
  The landing lane unpacks the compact rows into the expert-grouped buffer
  and the combine packs them back, so the FFN computes ``fused_flat``'s
  function (the reference hands its FFN the compact slab, which applies
  every local expert to every row; ROADMAP queue 3).

The reference's shard_map axis becomes an optional ``torch.distributed``
process group (the EP group): this rank's lane is its rank in the group,
and with no group (or a group of one) every exchange is the identity.
``fused_hier`` with nodes smaller than the EP group, and the two-level
(pod, model) axis, need more groups: the caller passes an :class:`EPGroups`
where the group goes, built once on every rank by :func:`ep_groups`
(``models/lm.make_context`` does).  On ranks ``r = p * M + m`` the model
group of rank r is ``{p * M + m'}`` and its pod group ``{p' * M + m}``; a
two-level exchange is two all-to-alls, one in each, and autograd composes
their transposes in the reverse order.

Every collective that moves rows is differentiable (a
``torch.autograd.Function`` that transposes as the reference's shard_map
collective does); the counts and metadata exchanges carry none.  Beside
the sequence gathers and scatters of Megatron-SP sit the vocab-parallel
ops of a vocab split over the model group (:func:`vocab_embed`,
:func:`copy_to_group`, :func:`vocab_parallel_ce`).  With
autograd off, ``fused_pipe`` issues each single-level slice exchange with
``async_op=True`` and waits for it just before the slice is consumed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core import pipesim
from repro_torch.core import planner as planner_lib
from repro_torch.core.descriptors import build_slot_table, drop_neg, gather_rows
from repro_torch.core.routing import ExpertPlacement, balanced_replica_choice
from repro_torch.kernels import ops as kops

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class DcommConfig:
    """Static configuration of the shuffle engine."""
    engine: str = "fused_hier"   # fused_flat | fused_pipe | fused_hier | disagg | ragged
    ep_axis: Any = "model"       # a (pod, model) pair asks for the multi-pod exchange
    node_size: int = 4           # lanes per (virtual) node; multi-pod: the model size
    capacity_factor: float = 2.0
    use_balancer: bool = True    # Online Load Balancer on/off (§5.4)
    # the condensed wire: one row per distinct (token, dest lane), expanded
    # on the landing lane; honoured by fused_flat, ignored by the others
    dedup: bool = False
    # fused_pipe slice knobs: 0 slices = auto via pipesim.plan_slices at the
    # hardware point below: spec-sheet values for the NVIDIA H100 80GB HBM3
    # (HBM3 staging, NVLink 4 wire per direction) until core.calibrate
    # measures the running card
    pipe_slices: int = 0
    pipe_stage_bw: float = 3.35e12
    pipe_wire_bw: float = 450e9
    pipe_overhead_s: float = 2e-6

    @property
    def pod_axis(self) -> str | None:
        return self.ep_axis[0] if isinstance(self.ep_axis, (tuple, list)) else None


def _cap(n_expected: float, factor: float, align: int = 8) -> int:
    c = max(align, int(-(-n_expected * factor // align)) * align)
    return c


@dataclasses.dataclass(frozen=True, eq=False)
class EPGroups:
    """The process groups of one EP domain (:func:`ep_groups`): ``ep`` holds
    every lane in lane order; ``node`` is this lane's node of ``node_size``
    lanes, where ``fused_hier``'s stage 2 runs (``ep`` itself for one node;
    None for nodes of one lane); ``model`` and ``pod`` are this lane's
    groups of a (pod, model) axis (``node`` is then ``model``)."""
    ep: dist.ProcessGroup
    node_size: int
    node: dist.ProcessGroup | None
    model: dist.ProcessGroup | None = None
    pod: dist.ProcessGroup | None = None


def ep_groups(group: dist.ProcessGroup, node_size: int, n_pods: int = 1,
              domains: list[list[int]] | None = None) -> EPGroups:
    """The groups of the EP domain ``group`` for nodes of ``node_size``
    lanes, and with ``n_pods > 1`` for the (pod, model) axis whose pods are
    the nodes (lane l = p * node_size + m).  ``domains``: the global ranks
    of every EP domain of the job, ``group``'s among them, in one order on
    every rank (a ``launch.mesh.HostMesh``'s ``ep_domains()``; None: this
    domain alone).  Collective: every rank of the job calls it once, with
    the same arguments, in the same order, and each ``dist.new_group`` of
    every domain is created on every rank."""
    ranks = dist.get_process_group_ranks(group)
    ep, lane = len(ranks), dist.get_rank(group)
    domains = [ranks] if domains is None else [list(d) for d in domains]
    if ranks not in domains:
        raise ValueError(f"EP group {ranks} is not one of the domains "
                         f"{domains}")
    mine = domains.index(ranks)
    if ep % node_size:
        raise ValueError(f"ep={ep} not divisible by node_size={node_size}")
    if n_pods > 1:
        if ep != n_pods * node_size:
            raise ValueError(f"a (pod, model) axis of {n_pods} pods needs "
                             f"node_size = ep / pods, got {node_size} of {ep}")
        models, pods = [], []
        for dom in domains:
            models.append([dist.new_group([dom[p * node_size + m]
                                           for m in range(node_size)])
                           for p in range(n_pods)])
            pods.append([dist.new_group([dom[p * node_size + m]
                                         for p in range(n_pods)])
                         for m in range(node_size)])
        model = models[mine][lane // node_size]
        return EPGroups(group, node_size, model, model,
                        pods[mine][lane % node_size])
    if node_size == ep:
        return EPGroups(group, node_size, group)
    if node_size == 1:
        return EPGroups(group, node_size, None)
    nodes = [[dist.new_group([dom[i] for i in lanes])
              for lanes in _node_groups(ep, node_size)] for dom in domains]
    return EPGroups(group, node_size, nodes[mine][lane // node_size])


def process_group(group) -> dist.ProcessGroup | None:
    """The process group holding every lane of ``group`` (a group, an
    :class:`EPGroups` or None)."""
    return group.ep if isinstance(group, EPGroups) else group


def lane_index(group) -> int:
    """This rank's lane on the EP axis: its rank in ``group`` (0 alone)."""
    return 0 if group is None else dist.get_rank(process_group(group))


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(process_group(group))


# the collectives of ``torch.distributed`` (:func:`collective_calls`)
COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "all_to_all_single",
               "all_gather", "all_gather_object", "broadcast",
               "reduce_scatter_tensor", "barrier")


@contextlib.contextmanager
def collective_calls():
    """Counts the calls of ``torch.distributed``'s collectives while open:
    yields the list of their names, one entry a call (each function
    wrapped in the module, through which the port calls them)."""
    calls = []
    saved = {n: getattr(dist, n) for n in COLLECTIVES}
    for n, fn in saved.items():
        setattr(dist, n, lambda *a, _n=n, _f=fn, **k: (calls.append(_n),
                                                       _f(*a, **k))[1])
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)


def _lane_index(cfg: DcommConfig, group) -> int:
    """This rank's lane, from the pod and model groups on a (pod, model)
    axis: p * M + m (the reference's ``_lane_index``)."""
    if cfg.pod_axis is None or group_size(group) == 1:
        return lane_index(group)
    g = _pod_groups(group)
    return (dist.get_rank(g.pod) * dist.get_world_size(g.model)
            + dist.get_rank(g.model))


def _pod_groups(group) -> EPGroups:
    if not (isinstance(group, EPGroups) and group.pod is not None):
        raise ValueError("a (pod, model) EP axis over more than one lane "
                         "needs the pod and model groups: pass "
                         "dcomm.ep_groups(group, node_size, n_pods)")
    return group


def _node_groups(ep: int, node_size: int) -> list[list[int]]:
    """The lanes of each node (the reference's ``axis_index_groups``)."""
    return [list(range(n * node_size, (n + 1) * node_size))
            for n in range(ep // node_size)]


def seq_stripe(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's stripe of the sequence (dim 1) of a (B, S, ...) tensor:
    the reference islands' ``x_spec`` shards the sequence over the EP axes
    (``repro/layers/moe.py:70``).  Raises if the group does not divide S."""
    ep, s = group_size(group), x.shape[1]
    if s % ep:
        raise ValueError(f"sequence of {s} does not split over {ep} EP lanes")
    r = lane_index(group)
    return x[:, r * (s // ep):(r + 1) * (s // ep)]


class _GatherSeq(torch.autograd.Function):
    """Tiled all-gather along the sequence.  Its transpose keeps this rank's
    stripe of the cotangent summed over the group (the reference's
    ``psum_scatter``, :func:`reduce_scatter_dim`: one reduce-scatter on
    NCCL, all_reduce + stripe on gloo): the loss the ranks differentiate
    is the sum of their own losses."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ep = group_size(group)
        b, s = x.shape[:2]
        buf = torch.empty((ep * b, *x.shape[1:]), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(buf, x.contiguous(),
                                    group=process_group(group))
        return buf.reshape(ep, b, *x.shape[1:]).movedim(0, 1).reshape(
            b, ep * s, *x.shape[2:])

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, 1, process_group(ctx.group)), None


class _ScatterSeq(torch.autograd.Function):
    """Sum over the group, each rank keeping its stripe of the sequence
    (the reference's tiled ``psum_scatter`` on dim 1); its transpose is the
    tiled all-gather of the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce_scatter_dim(x, 1, process_group(group))

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, 1, process_group(ctx.group)), None


def reduce_scatter_seq(x: torch.Tensor,
                       group: dist.ProcessGroup | None) -> torch.Tensor:
    """(B, S, ...) partial sums of every rank summed, this rank's stripe
    (B, S / n, ...) returned, in lane order: the converse of
    :func:`all_gather_seq`, and the row-parallel products' exit of
    Megatron-SP (``parallel/tp_blocks.py``).  One ``reduce_scatter_tensor``
    on NCCL; an ``all_reduce`` and the stripe on gloo, which runs no
    reduce-scatter.  The identity for one lane, with no collective.
    Differentiable (:class:`_ScatterSeq`)."""
    if group_size(group) == 1:
        return x
    if x.shape[1] % group_size(group):
        raise ValueError(f"sequence of {x.shape[1]} does not split over "
                         f"{group_size(group)} ranks")
    return _ScatterSeq.apply(x, group)


class _SumForward(torch.autograd.Function):
    """All-reduce (sum) in the forward, the identity in the backward:
    each rank's cotangent of the sum seeds its own addend (Megatron's
    reduce from the model-parallel region)."""

    @staticmethod
    def forward(ctx, t, group):
        t = t.clone()
        dist.all_reduce(t, group=process_group(group))
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_forward(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` (one ``all_reduce``; the identity for one
    rank), differentiable so that each rank's gradient is of its own
    addend (:class:`_SumForward`): summed over the ranks, the gradients are
    those of the one sum.  A loss each rank computes over its stripe of the
    sequence (``models/lm.lm_loss`` under TP) is summed so."""
    if group_size(group) == 1:
        return t
    return _SumForward.apply(t, group)


class _Psum(torch.autograd.Function):
    """All-reduce (sum) in the forward and in the backward: the
    reference's ``psum``, whose transpose is a psum of the cotangents.  A
    value every rank then uses alike carries on each rank a share of its
    cotangent (each rank differentiates its own copy of the loss); the
    backward sums the shares, so each addend gets the whole cotangent."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=process_group(group))
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=process_group(ctx.group))
        return g, None


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` (one ``all_reduce``; the identity for one
    rank), whose backward sums the ranks' cotangents (:class:`_Psum`): the
    exit of a region each rank computes a part of, such as the Mamba2
    mixer's heads over a model group (``layers/ssm.py``)."""
    if group_size(group) == 1:
        return t
    return _Psum.apply(t, group)


def all_gather_seq(x: torch.Tensor,
                   group: dist.ProcessGroup | None) -> torch.Tensor:
    """The stripes of every rank joined along the sequence (dim 1), in lane
    order: the reference's tiled ``all_gather`` over the EP axis.  The
    identity for one lane, with no collective.  Differentiable: see
    :class:`_GatherSeq` for whose loss the backward sums."""
    if group_size(group) == 1:
        return x
    return _GatherSeq.apply(x, group)


def all_gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` (a process group) joined on ``dim``
    in rank order (one ``all_gather_into_tensor``; a new contiguous
    tensor)."""
    src = t.movedim(dim, 0).contiguous()
    buf = src.new_empty((dist.get_world_size(group) * src.shape[0],
                         *src.shape[1:]))
    dist.all_gather_into_tensor(buf, src, group=group)
    return buf.movedim(0, dim).contiguous()


def reduce_scatter_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``t`` summed over ``group`` and cut on ``dim`` into one equal slice a
    rank, this rank's returned: one ``reduce_scatter_tensor`` on NCCL; an
    ``all_reduce`` and the slice elsewhere (gloo runs no reduce-scatter)."""
    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    if dist.get_backend(group) == "nccl":
        out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=group)
    else:
        if src.data_ptr() == t.data_ptr():    # all_reduce writes in place
            src = src.clone()
        dist.all_reduce(src, group=group)
        k = src.shape[0] // n
        r = dist.get_rank(group)
        out = src[r * k:(r + 1) * k]
    return out.movedim(0, dim).contiguous()


class _GatherDim(torch.autograd.Function):
    """:func:`all_gather_dim`, whose transpose is :func:`reduce_scatter_dim`
    (sum): ZeRO-3's gather of a sharded weight, each rank's gradient of its
    slice summed over the group."""

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


def gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Differentiable :func:`all_gather_dim` (:class:`_GatherDim`)."""
    return _GatherDim.apply(t, dim, group)


class _VocabEmbed(torch.autograd.Function):
    """The vocab-parallel lookup (Megatron's ``VocabParallelEmbedding``):
    ``table`` is this rank's rows [r * n, (r + 1) * n) of the vocab; each
    token outside them takes a zero row, and the partial rows are summed
    over the group (exact: one rank holds each row), to the whole sequence
    on every rank (``all_reduce``) or, with ``stripe``, reduce-scattered to
    this rank's (B, S / m, d) stripe.  The backward sums the cotangent over
    the group (the ranks' shares of the replicated layout) or all-gathers
    the stripes' cotangents, and adds each position's into this rank's row
    of its token."""

    @staticmethod
    def forward(ctx, table, tokens, group, stripe):
        n = table.shape[0]
        idx = tokens - lane_index(group) * n
        mine = (idx >= 0) & (idx < n)
        idx = torch.where(mine, idx, 0)
        rows = table[idx].masked_fill_(~mine[..., None], 0)
        ctx.save_for_backward(idx, mine)
        ctx.group, ctx.stripe, ctx.shape = group, stripe, table.shape
        pg = process_group(group)
        if stripe:
            return reduce_scatter_dim(rows, 1, pg)
        dist.all_reduce(rows, group=pg)
        return rows

    @staticmethod
    def backward(ctx, g):
        idx, mine = ctx.saved_tensors
        pg = process_group(ctx.group)
        if ctx.stripe:
            g = all_gather_dim(g, 1, pg)
        else:
            g = g.clone()
            dist.all_reduce(g, group=pg)
        g = g.masked_fill_(~mine[..., None], 0)
        grad = g.new_zeros(ctx.shape)
        grad.index_put_((idx.reshape(-1),), g.reshape(-1, ctx.shape[1]),
                        accumulate=True)
        return grad, None, None, None


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, group,
                stripe: bool = False) -> torch.Tensor:
    """(B, S) ``tokens`` looked up in this rank's vocab rows ``table``
    (V / m, d) of a group of m (:class:`_VocabEmbed`): the whole
    sequence's rows (B, S, d) on every rank, or with ``stripe`` this
    rank's stripe of them (B, S / m, d), Megatron-SP's entry."""
    return _VocabEmbed.apply(table, tokens, group, stripe)


class _CopyToGroup(torch.autograd.Function):
    """The identity forward; in the backward the ranks' cotangents summed
    over the group and divided by its size (Megatron's copy to the
    model-parallel region, on a layout whose ranks each differentiate a
    share of the replicated loss: each rank's head takes the cotangent of
    its vocab shard of the one loss, and their sum over m is the whole
    loss's; the 1 / m makes each rank's the share the replicated layout
    passes on, ``launch/steps.py``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=process_group(ctx.group))
        return g.div_(group_size(ctx.group)), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is (:class:`_CopyToGroup`): the head's entry without
    Megatron-SP, h whole on every rank."""
    return _CopyToGroup.apply(x, group)


class _VocabCE(torch.autograd.Function):
    """Next-token CE over logits split on the vocab (Megatron's
    ``vocab_parallel_cross_entropy``): (B, c, V / m) float32 logits of this
    rank's vocab columns [r * n, (r + 1) * n), (B, c) labels (-1: none).
    The max is all-reduced, then Σ exp and the gold logit (taken on the
    rank that owns the label, zero on the others) in one all-reduce; every
    rank returns the same (B, c) losses, log Σ exp - gold (0 where no
    label).  The backward seeds only this rank's shard, softmax - one-hot
    of its columns: every rank's loss is the same, so no collective runs
    there (an all-reduce would count the loss m times)."""

    @staticmethod
    def forward(ctx, logits, labels, group):
        pg = process_group(group)
        n = logits.shape[-1]
        mx = logits.amax(dim=-1)
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=pg)
        z = logits - mx[..., None]
        e = z.exp()
        idx = labels.long() - lane_index(group) * n
        mine = (idx >= 0) & (idx < n)
        idx = torch.where(mine, idx, 0)
        gold = torch.where(mine, z.gather(-1, idx[..., None])[..., 0], 0.0)
        both = torch.stack([e.sum(dim=-1), gold])
        dist.all_reduce(both, group=pg)
        se, gold = both
        valid = labels >= 0
        ctx.save_for_backward(e.div_(se[..., None]), idx, mine, valid)
        return torch.where(valid, se.log() - gold, 0.0)

    @staticmethod
    def backward(ctx, g):
        p, idx, mine, valid = ctx.saved_tensors
        grad = p.clone()
        grad.scatter_add_(-1, idx[..., None],
                          -mine[..., None].to(grad.dtype))
        return grad.mul_(torch.where(valid, g, 0.0)[..., None]), None, None


def vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor,
                      group) -> torch.Tensor:
    """The (B, c) next-token losses of (B, c, V / m) float32 logits split
    on the vocab over ``group`` (:class:`_VocabCE`), 0 where a label is
    -1; the same on every rank."""
    return _VocabCE.apply(logits, labels, group)


class DispatchResult(NamedTuple):
    """What the expert FFN consumes: a landed buffer already grouped by local
    expert, plus what combine() needs to route outputs home."""
    expert_rows: torch.Tensor     # (S, E_local, C, d) rows for this lane's experts
    state: Any                    # engine-private
    dropped: torch.Tensor | None = None   # this shard's capacity overflow
    counts: torch.Tensor | None = None    # (S, E_local) landed occupancy
    row_gates: torch.Tensor | None = None  # (S, E_local, C): gated at the
                                           # expert (hier, dedup), else None


def _all_to_all(buf: torch.Tensor, group) -> torch.Tensor:
    buf = buf.contiguous()
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all of a lane-major buffer over one group; its
    transpose is the same exchange of the cotangent (the reference's
    all_to_all transposes into all_to_all)."""

    @staticmethod
    def forward(ctx, buf, group):
        ctx.group = group
        return _all_to_all(buf, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _exchanges(buf: torch.Tensor, ep: int, group) -> bool:
    """Whether the tiled exchange of a lane-major (EP, rows, ...) buffer
    over ``group`` moves anything: False for one lane; raises for a group
    that does not match the buffer."""
    if group_size(group) == 1:
        return False
    if buf.shape[0] != ep or group_size(group) != ep:
        raise ValueError(f"exchange of {buf.shape[0]} lanes over a group of "
                         f"{group_size(group)}, placement ep={ep}")
    return True


def _flat_exchange(buf: torch.Tensor, cfg: DcommConfig, ep: int,
                   group=None, reverse: bool = False) -> torch.Tensor:
    """Tiled exchange of a lane-major (EP, rows, ...) buffer over the EP
    axis: block i goes to lane i, and the block from lane j lands at j.
    The leading axis is the destination lane on dispatch and the origin lane
    on combine.  On a (pod, model) axis it is two exchanges, over the model
    group and then over the pod group; ``reverse`` runs them in the
    opposite order, so the combine retraces the dispatch's route."""
    if not _exchanges(buf, ep, group):
        return buf
    if cfg.pod_axis is None:
        return _AllToAll.apply(buf, process_group(group))
    g = _pod_groups(group)
    npod = dist.get_world_size(g.pod)
    b = buf.reshape(npod, ep // npod, *buf.shape[1:])
    over_model = lambda v: _AllToAll.apply(v.transpose(0, 1),
                                           g.model).transpose(0, 1)
    if reverse:
        b = over_model(_AllToAll.apply(b, g.pod))
    else:
        b = _AllToAll.apply(over_model(b), g.pod)
    return b.reshape(buf.shape)


def _node_exchange(buf: torch.Tensor, node: dist.ProcessGroup | None,
                   ns: int) -> torch.Tensor:
    """Tiled exchange of a lane-major (node_size, rows, ...) buffer within
    this lane's node (``fused_hier``'s stage 2); the identity for a node of
    one lane."""
    if ns == 1:
        return buf
    if buf.shape[0] != ns or node is None or dist.get_world_size(node) != ns:
        raise ValueError(f"stage-2 exchange of {buf.shape[0]} lanes in a node "
                         f"of {ns}: pass dcomm.ep_groups(group, {ns})")
    return _AllToAll.apply(buf, node)


def _a2a_vec(v: torch.Tensor, ep: int, group) -> torch.Tensor:
    """Exchange one row per peer over the EP axis: v (EP, ...) -> (EP, ...),
    row j from lane j (the reference's one scalar per peer, (EP,) -> (EP,));
    no gradient."""
    if not _exchanges(v, ep, group):
        return v
    return _all_to_all(v.detach().reshape(ep, -1),
                       process_group(group)).reshape(v.shape)


def _landed_counts(plan: planner_lib.FlatPlan, placement: ExpertPlacement,
                   cap: int, group) -> torch.Tensor:
    """The (source lane, E_local) occupancy of this lane's landed buffer:
    the plan's per-group counts clipped at capacity, through one small
    exchange of their own so the FFN kernel can skip empty row tiles (the
    reference passes none)."""
    sent = plan.slots.counts.clamp(max=cap).to(I32)
    return _a2a_vec(sent.reshape(placement.ep, placement.experts_per_lane),
                    placement.ep, group)


def flat_dispatch(x: torch.Tensor, A: torch.Tensor, gates: torch.Tensor,
                  placement: ExpertPlacement, cfg: DcommConfig,
                  group: dist.ProcessGroup | None = None) -> DispatchResult:
    t, d = x.shape
    k = A.shape[1]
    e_local = placement.experts_per_lane
    cap = _cap(t * k / (placement.ep * e_local), cfg.capacity_factor)
    plan = planner_lib.build_flat_plan(A, gates, placement, cap)

    # ONE fused gather: token layout -> comm buffer (EP * E_local * C, d)
    buf = kops.segment_gather(x, plan.src_of_slot, plan.slots.slot)
    buf = _flat_exchange(buf.reshape(placement.ep, e_local * cap, d), cfg,
                         placement.ep, group)
    # landed layout: (source lane, E_local, C, d), expert-grouped already
    counts = _landed_counts(plan, placement, cap, group)
    expert_rows = buf.reshape(placement.ep, e_local, cap, d)
    return DispatchResult(expert_rows, (plan, t, d, cap), plan.dropped, counts)


def flat_combine(expert_out: torch.Tensor, res: DispatchResult,
                 placement: ExpertPlacement, cfg: DcommConfig,
                 group: dist.ProcessGroup | None = None) -> torch.Tensor:
    plan, t, d, cap = res.state
    e_local = placement.experts_per_lane
    buf = _flat_exchange(expert_out.reshape(placement.ep, e_local * cap, d),
                         cfg, placement.ep, group, reverse=True)
    buf = buf.reshape(placement.ep * e_local * cap, d)
    # fused gated scatter-add straight into the original token layout, each
    # token summed over its slots: the slot table is src_of_slot's inverse
    return kops.segment_scatter_add(buf, plan.src_of_slot, plan.gate_of_slot, t,
                                    plan.slots.slot)


# ======================================================================
# fused_flat + dedup: the condensed flat wire
# ======================================================================

def _ones(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.ones(n, dtype=torch.float32, device=like.device)


def dedup_dispatch(x: torch.Tensor, A: torch.Tensor, gates: torch.Tensor,
                   placement: ExpertPlacement, cfg: DcommConfig,
                   group=None) -> DispatchResult:
    """Condensed flat dispatch: one wire row per distinct (token, dest lane),
    the one tiled exchange of ``flat_dispatch`` over the condensed plan.
    The landing lane expands the rows per local expert from the piggybacked
    metadata (``build_stage2_plan`` at node size 1: a local gather, no
    second exchange), so the FFN sees the grouped layout, gates at
    ``row_gates``.  Both gathers take their plan's slot table as the owner
    table of their backward; the FFN's occupancy is the expansion's counts,
    local to the lane."""
    t, d = x.shape
    k = A.shape[1]
    ep, e_local = placement.ep, placement.experts_per_lane
    # condensed rows per dest lane: distinct lanes per token <= min(k, ep)
    c1 = _cap(t * min(k, ep) / ep, cfg.capacity_factor)
    # expansion rows per local expert: ~t*k assignments land from all lanes
    c2 = _cap(t * k / e_local, cfg.capacity_factor)

    plan1 = planner_lib.build_condensed_plan(A, gates, placement, c1)
    buf = kops.segment_gather(x, plan1.src_of_slot, plan1.slots.slot)
    buf = _flat_exchange(buf.reshape(ep, c1, d), cfg, ep, group)
    me = _flat_exchange(plan1.meta_expert.reshape(ep, c1, k), cfg, ep, group)
    mg = _flat_exchange(plan1.meta_gate.reshape(ep, c1, k), cfg, ep, group)

    plan2 = planner_lib.build_stage2_plan(me.reshape(ep * c1, k),
                                          mg.reshape(ep * c1, k), 1, e_local, c2)
    buf2 = kops.segment_gather(buf.reshape(ep * c1, d), plan2.src_of_slot,
                               plan2.slots.slot)
    counts = plan2.slots.counts.clamp(max=c2).to(I32).reshape(1, e_local)
    return DispatchResult(buf2.reshape(1, e_local, c2, d),
                          (plan1, plan2, t, d, c1, c2),
                          plan1.dropped + plan2.slots.dropped(), counts,
                          plan2.gate_of_slot.reshape(1, e_local, c2))


def dedup_combine(expert_out: torch.Tensor, res: DispatchResult,
                  placement: ExpertPlacement, cfg: DcommConfig,
                  group=None) -> torch.Tensor:
    """Gate at the expert (in the expert's dtype, as the reference), sum
    each wire row's expert partials on the landing lane (the owner-reduce
    over the expansion's slot table), reverse the condensed exchange, and
    sum each token's rows home over the condensed slot table: condensed
    bytes on the wire both ways."""
    plan1, plan2, t, d, c1, c2 = res.state
    ep = placement.ep
    out = (expert_out * res.row_gates[..., None].to(expert_out.dtype)).reshape(-1, d)
    part = kops.segment_scatter_add(out, plan2.src_of_slot,
                                    _ones(out.shape[0], out), ep * c1,
                                    plan2.slots.slot)
    part = _flat_exchange(part.reshape(ep, c1, d), cfg, ep, group,
                          reverse=True).reshape(ep * c1, d)
    return kops.segment_scatter_add(part, plan1.src_of_slot,
                                    _ones(ep * c1, part), t, plan1.slots.slot)


# ======================================================================
# fused_pipe: the paper's pipelined engine (Fig. 5) on the flat plan, split
# into issue/consume slice primitives so a schedule (one shuffle, or the
# moe_tx stream) can hold slices in flight explicitly.  The reference's
# lax.scan is a Python loop here, in its order: issue slice i+1, then
# consume slice i.
# ======================================================================

class InFlight(NamedTuple):
    """An exchange issued on the wire: ``out`` is valid once :meth:`wait`
    returns it.  ``work`` is the collective's handle (None when the exchange
    ran synchronously or was the identity); ``sent`` keeps the send buffer
    alive until then."""
    out: torch.Tensor
    work: Any = None
    sent: torch.Tensor | None = None

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
        return self.out


def _pipe_exchange(buf: torch.Tensor, cfg: DcommConfig, ep: int, group,
                   reverse: bool = False) -> InFlight:
    """The tiled exchange of one slice.  Over an EP group of more than one
    rank with autograd off it is issued with ``async_op=True`` (consumed
    after ``wait``); under autograd, and on a (pod, model) axis, whose
    second exchange waits on the first, it is the synchronous exchange;
    with one lane, the identity."""
    if not _exchanges(buf, ep, group):
        return InFlight(buf)
    if torch.is_grad_enabled() or cfg.pod_axis is not None:
        return InFlight(_flat_exchange(buf, cfg, ep, group, reverse))
    sent = buf.contiguous()
    out = torch.empty_like(sent)
    work = dist.all_to_all_single(out, sent, group=process_group(group),
                                  async_op=True)
    return InFlight(out, work, sent)


@functools.lru_cache(maxsize=256)
def pipe_geometry(t: int, k: int, d: int, itemsize: int,
                  placement: ExpertPlacement, cfg: DcommConfig,
                  n_layers: int = 1, interleave: int = 1,
                  attn_s: float = 0.0) -> tuple[int, int]:
    """(capacity, n_slices) for a pipelined shuffle: a static plan, computed
    once per set of arguments (the reference computes it at trace time; a
    pipesim sweep costs milliseconds of host time, more than the shuffle).

    ``t`` is the tokens of ONE shuffle.  S is ``cfg.pipe_slices`` when set;
    else the pipesim knee for the staging buffer's byte volume at the
    config's hardware point: the attention-filled knee from
    :func:`pipesim.plan_tx_stream` when ``attn_s > 0`` (the caller's
    estimate of the attention seconds that fill the tail's window), the
    interleaved knee from :func:`pipesim.plan_interleaved_stream` when
    micro-batches are interleaved, the joint cross-layer knee from
    :func:`pipesim.plan_layer_stream` for one layer of an ``n_layers``
    stream, else :func:`pipesim.plan_slices`.  Clamped so every slice keeps
    at least one row per (lane, expert) sub-slot; capacity is rounded up to
    a multiple of S."""
    e_local = placement.experts_per_lane
    cap = _cap(t * k / (placement.ep * e_local), cfg.capacity_factor)
    if cfg.pipe_slices > 0:
        s = cfg.pipe_slices
    else:
        payload = float(placement.ep * e_local * cap * d * itemsize)
        p = pipesim.params_from_dcomm(payload, cfg)
        if attn_s > 0.0:
            s = pipesim.plan_tx_stream(
                p, max(1, n_layers), max(1, interleave), attn_s,
                payload_bytes=payload * max(1, interleave))["n_slices"]
        elif interleave > 1:
            s = pipesim.plan_interleaved_stream(
                p, max(1, n_layers), interleave,
                payload_bytes=payload * interleave)["n_slices"]
        elif n_layers > 1:
            s = pipesim.plan_layer_stream(p, n_layers)["n_slices"]
        else:
            s = pipesim.plan_slices(p)["n_slices"]
    s = max(1, min(int(s), cap))
    cap = int(-(-cap // s)) * s                       # round up to S slices
    return cap, s


class PipePlan(NamedTuple):
    """What the slices of one pipelined shuffle read: the sliced
    descriptors, each slice's owner table (S, T, K) and landed occupancy
    (S, EP, E_local), from one plan and one counts exchange."""
    plan: planner_lib.FlatPlan
    sliced: planner_lib.SlicedFlatPlan
    owners: torch.Tensor
    counts: torch.Tensor
    cap: int
    n_slices: int


def _pipe_slice_plan(x: torch.Tensor, A: torch.Tensor, gates: torch.Tensor,
                     placement: ExpertPlacement, cfg: DcommConfig,
                     group: dist.ProcessGroup | None) -> PipePlan:
    """The flat plan with capacity rounded so it splits into S slices, and
    what each slice needs: a slice's occupancy is the landed count less the
    rows of the slices before it, clamped to [0, Cs], so row tiles past it
    skip their weights (their rows are empty, and SwiGLU(0) = 0)."""
    t, d = x.shape
    cap, s = pipe_geometry(t, A.shape[1], d, x.element_size(), placement, cfg)
    plan = planner_lib.build_flat_plan(A, gates, placement, cap)
    sliced = planner_lib.slice_flat_plan(plan, placement, cap, s)
    cs = cap // s
    landed = _landed_counts(plan, placement, cap, group)
    first = torch.arange(s, dtype=I32, device=landed.device) * cs
    counts = (landed[None] - first[:, None, None]).clamp(0, cs).to(I32)
    owners = planner_lib.slice_owner_table(plan.slots.slot, cap, s)
    return PipePlan(plan, sliced, owners, counts, cap, s)


def pipe_issue(x: torch.Tensor, src_slice: torch.Tensor,
               owners_slice: torch.Tensor, placement: ExpertPlacement,
               cfg: DcommConfig,
               group: dist.ProcessGroup | None = None) -> InFlight:
    """Producer half of one slice: the descriptor gather stages it, the
    tiled exchange puts it on the wire.  ``src_slice`` is (EP, E_local, Cs);
    ``owners_slice`` its (T, K) owner table (the gather's backward).  The
    landed (EP (source lane), E_local, Cs, d) sub-buffer is the
    ``fused_flat`` layout, one capacity stripe at a time."""
    ep, d = placement.ep, x.shape[1]
    _, e_local, cs = src_slice.shape
    buf = kops.segment_gather(x, src_slice.reshape(-1), owners_slice)
    return _pipe_exchange(buf.reshape(ep, e_local, cs, d), cfg, ep, group)


def pipe_return_issue(out_slice: torch.Tensor, placement: ExpertPlacement,
                      cfg: DcommConfig,
                      group: dist.ProcessGroup | None = None) -> InFlight:
    """Wire half of one slice's combine: the reverse tiled exchange of the
    expert outputs (EP, E_local, Cs, d), back on their origin lane."""
    return _pipe_exchange(out_slice, cfg, placement.ep, group, reverse=True)


def pipe_return_consume(y: torch.Tensor | None, returned: InFlight,
                        src_slice: torch.Tensor, gate_slice: torch.Tensor,
                        owners_slice: torch.Tensor, t: int) -> torch.Tensor:
    """Local half of one slice's combine: the gated scatter-add (the
    owner-reduce over the slice's owner table) added into ``y`` in its
    dtype, as the reference accumulates; ``y`` None starts the sum."""
    rows = returned.wait()
    part = kops.segment_scatter_add(rows.reshape(-1, rows.shape[-1]),
                                    src_slice.reshape(-1),
                                    gate_slice.reshape(-1), t, owners_slice)
    return part if y is None else y + part


def pipe_consume(y: torch.Tensor | None, landed: InFlight,
                 src_slice: torch.Tensor, gate_slice: torch.Tensor,
                 owners_slice: torch.Tensor, counts_slice: torch.Tensor,
                 ffn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                 t: int, placement: ExpertPlacement, cfg: DcommConfig,
                 group: dist.ProcessGroup | None = None) -> torch.Tensor:
    """Consumer half of one slice: grouped FFN and both combine halves.
    ``landed`` is a slice from :func:`pipe_issue`; ``ffn(rows, counts)``
    maps it to expert outputs of the same shape."""
    returned = pipe_return_issue(ffn(landed.wait(), counts_slice), placement,
                                 cfg, group)
    return pipe_return_consume(y, returned, src_slice, gate_slice,
                               owners_slice, t)


class PipeTail(NamedTuple):
    """The in-flight queue entry that survives a shuffle's epilogue: one
    slice whose combine *exchange* has been issued but whose scatter-add
    has not landed.  ``fusco.tx_layer_stream`` carries it across a layer's
    attention block and lands it in the next layer's prologue."""
    returned: InFlight          # (EP, E_local, Cs, d) reverse-exchanged outputs
    src: torch.Tensor           # (EP, E_local, Cs) origin token per slot
    gate: torch.Tensor          # (EP, E_local, Cs) combine weight per slot
    owners: torch.Tensor        # (T, K) the slice's owner table


def pipe_empty_tail(placement: ExpertPlacement, cs: int, d: int, t: int,
                    k: int, dtype, gate_dtype, device) -> PipeTail:
    """A tail whose consumption adds zeros (every slot and owner empty): the
    stream's first carry before any layer has a slice in flight."""
    ep, e_local = placement.ep, placement.experts_per_lane
    return PipeTail(
        InFlight(torch.zeros((ep, e_local, cs, d), dtype=dtype, device=device)),
        torch.full((ep, e_local, cs), -1, dtype=I32, device=device),
        torch.zeros((ep, e_local, cs), dtype=gate_dtype, device=device),
        torch.full((t, k), -1, dtype=I32, device=device))


def pipe_empty_tails(placement: ExpertPlacement, cs: int, d: int, t: int,
                     k: int, dtype, gate_dtype, device,
                     lanes: int) -> list[PipeTail]:
    """K no-op tails, one in-flight queue entry per micro-batch lane: the
    first carry of the interleaved stream (the reference stacks them on a
    leading lane axis of its scan carry; here lane j's tail is entry j).
    ``t`` is one lane's tokens."""
    return [pipe_empty_tail(placement, cs, d, t, k, dtype, gate_dtype, device)
            for _ in range(lanes)]


def pipe_tail_consume(y: torch.Tensor, tail: PipeTail, t: int) -> torch.Tensor:
    """Land a deferred tail slice: the scatter-add that completes ``y``."""
    return pipe_return_consume(y, tail.returned, tail.src, tail.gate,
                               tail.owners, t)


def pipe_shuffle_ffn_stream(
        x: torch.Tensor, A: torch.Tensor, gates: torch.Tensor,
        ffn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
        placement: ExpertPlacement, cfg: DcommConfig,
        y0: torch.Tensor | None = None,
        group: dist.ProcessGroup | None = None
) -> tuple[torch.Tensor | None, PipeTail]:
    """One shuffle of a stream: pipelined like :func:`pipe_shuffle_ffn`, but
    the tail slice's scatter-add is NOT taken: its combine exchange is
    issued and handed back as a :class:`PipeTail` for the caller to land
    later.  ``y0`` seeds the accumulator (the residual stream input), so the
    returned partial output is ``y0 + all but the tail slice's
    contribution`` (None when ``y0`` is None and there is one slice)."""
    t = x.shape[0]
    pp = _pipe_slice_plan(x, A, gates, placement, cfg, group)
    src, gate, owners, counts = (pp.sliced.src, pp.sliced.gate, pp.owners,
                                 pp.counts)
    y = y0
    landed = pipe_issue(x, src[0], owners[0], placement, cfg, group)   # prologue
    for i in range(1, pp.n_slices):
        landed_next = pipe_issue(x, src[i], owners[i], placement, cfg, group)
        y = pipe_consume(y, landed, src[i - 1], gate[i - 1], owners[i - 1],
                         counts[i - 1], ffn, t, placement, cfg, group)
        landed = landed_next
    # tail: FFN + combine exchange issued; the scatter-add is deferred
    out = ffn(landed.wait(), counts[-1])
    returned = pipe_return_issue(out, placement, cfg, group)
    return y, PipeTail(returned, src[-1], gate[-1], owners[-1])


def pipe_shuffle_ffn(x: torch.Tensor, A: torch.Tensor, gates: torch.Tensor,
                     ffn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                     placement: ExpertPlacement, cfg: DcommConfig,
                     group: dist.ProcessGroup | None = None) -> torch.Tensor:
    """The fully fused pipelined path: slice i's FFN and combine run while
    slice i+1's gather and exchange are in flight.  ``ffn(rows, counts)``
    maps a landed (EP, E_local, Cs, d) slice and its (EP, E_local)
    occupancy to expert outputs of the same shape."""
    y, tail = pipe_shuffle_ffn_stream(x, A, gates, ffn, placement, cfg,
                                      group=group)
    return pipe_tail_consume(y, tail, x.shape[0])


def pipe_dispatch(x: torch.Tensor, A: torch.Tensor, gates: torch.Tensor,
                  placement: ExpertPlacement, cfg: DcommConfig,
                  group: dist.ProcessGroup | None = None) -> DispatchResult:
    """Split-phase API: pipelined communication only, the landed buffer
    identical to ``fused_flat``'s (the FFN-overlapped path is
    :func:`pipe_shuffle_ffn`)."""
    t, d = x.shape
    e_local = placement.experts_per_lane
    pp = _pipe_slice_plan(x, A, gates, placement, cfg, group)
    issued = [pipe_issue(x, pp.sliced.src[i], pp.owners[i], placement, cfg,
                         group) for i in range(pp.n_slices)]
    landed = torch.stack([f.wait() for f in issued])     # (S, EP, El, Cs, d)
    # slices are capacity stripes: (S, EP, El, Cs, d) -> (EP, El, C, d)
    expert_rows = landed.permute(1, 2, 0, 3, 4).reshape(
        placement.ep, e_local, pp.cap, d)
    counts = pp.counts.sum(0)                            # (EP, E_local)
    return DispatchResult(expert_rows, (pp, t, d), pp.plan.dropped, counts)


def pipe_combine(expert_out: torch.Tensor, res: DispatchResult,
                 placement: ExpertPlacement, cfg: DcommConfig,
                 group: dist.ProcessGroup | None = None) -> torch.Tensor:
    pp, t, d = res.state
    e_local, s = placement.experts_per_lane, pp.n_slices
    out = expert_out.reshape(placement.ep, e_local, s, pp.cap // s, d).permute(
        2, 0, 1, 3, 4)                                   # (S, EP, El, Cs, d)
    y = None
    for i in range(s):
        returned = pipe_return_issue(out[i], placement, cfg, group)
        y = pipe_return_consume(y, returned, pp.sliced.src[i],
                                pp.sliced.gate[i], pp.owners[i], t)
    return y


# ======================================================================
# fused_hier: node-level forwarding (Online Load Balancer) + expert-level
# expansion within the node
# ======================================================================

def _node_of(group, placement: ExpertPlacement) -> dist.ProcessGroup | None:
    """The group of this lane's node: the EP group when it is one node,
    else the ``node`` of the :class:`EPGroups` passed for it."""
    ns = placement.node_size
    if ns == group_size(group):
        return process_group(group)
    if isinstance(group, EPGroups) and group.node_size == ns:
        return group.node
    raise ValueError(f"fused_hier with nodes of {ns} of {group_size(group)} "
                     f"lanes needs the node groups: pass "
                     f"dcomm.ep_groups(group, {ns})")


def hier_dispatch(x: torch.Tensor, A: torch.Tensor, gates: torch.Tensor,
                  placement: ExpertPlacement, cfg: DcommConfig,
                  assignment: torch.Tensor | None = None,
                  group=None) -> DispatchResult:
    """Stage 1: one row per (token, destination node) to the node's
    forwarder, with the token's (node-local expert, gate) pairs, over the
    EP axis (two levels on a (pod, model) axis).  Stage 2, on the
    forwarder: the expansion per expert (``build_stage2_plan``) and an
    exchange within the node that lands the rows expert-grouped, gates at
    ``row_gates``.  ``assignment`` is the balancer's (n_nodes, node_size)
    group table (None: the static grouping).  Both gathers take their
    plan's slot table as the owner table of their backward; the FFN's
    occupancy is the expansion's counts, through one small exchange in the
    node (the reference passes none)."""
    t, d = x.shape
    k = A.shape[1]
    ep, e_local = placement.ep, placement.experts_per_lane
    ns, n_nodes = placement.node_size, placement.n_nodes
    # stage-1 rows per destination rank: distinct nodes per token <= min(k, n)
    c1 = _cap(t * min(k, n_nodes) / ep, cfg.capacity_factor)
    c2 = _cap(t * k * ns / (ep * ns * e_local), cfg.capacity_factor)
    node = _node_of(group, placement)

    plan1 = planner_lib.build_hier_plan(A, gates, placement, c1,
                                        _lane_index(cfg, group), assignment)
    # stage 1: node-level forwarding (dedup, slow tier)
    buf1 = kops.segment_gather(x, plan1.src_of_slot, plan1.slots.slot)
    ex = lambda v: _flat_exchange(v.reshape(ep, c1, -1), cfg, ep,
                                  group).reshape(ep * c1, -1)
    buf1, me, mg = ex(buf1), ex(plan1.meta_expert), ex(plan1.meta_gate)

    # stage 2: expert-level distribution within the node (fast tier)
    plan2 = planner_lib.build_stage2_plan(me, mg, ns, e_local, c2)
    buf2 = kops.segment_gather(buf1, plan2.src_of_slot, plan2.slots.slot)
    buf2 = _node_exchange(buf2.reshape(ns, e_local * c2, d), node, ns)
    g2 = _node_exchange(plan2.gate_of_slot.reshape(ns, e_local * c2), node, ns)
    sent = plan2.slots.counts.clamp(max=c2).to(I32).reshape(ns, e_local)
    counts = sent if ns == 1 else _all_to_all(sent, node)
    # stage-1 drops are the sender's; stage-2 drops the forwarder's
    return DispatchResult(buf2.reshape(ns, e_local, c2, d),
                          (plan1, plan2, t, d, c1, c2, node),
                          plan1.dropped + plan2.slots.dropped(), counts,
                          g2.reshape(ns, e_local, c2))


def hier_combine(expert_out: torch.Tensor, res: DispatchResult,
                 placement: ExpertPlacement, cfg: DcommConfig,
                 group=None) -> torch.Tensor:
    """Gate at the expert, return within the node, pre-reduce each node's
    partials per stage-1 row on the forwarder (over the expansion's slot
    table), return over the slow tier, and sum each token's node rows home
    over the stage-1 slot table."""
    plan1, plan2, t, d, c1, c2, node = res.state
    ep, e_local, ns = placement.ep, placement.experts_per_lane, placement.node_size
    out = expert_out * res.row_gates[..., None].to(expert_out.dtype)
    out = _node_exchange(out.reshape(ns, e_local * c2, d), node,
                         ns).reshape(-1, d)
    part = kops.segment_scatter_add(out, plan2.src_of_slot,
                                    _ones(out.shape[0], out), ep * c1,
                                    plan2.slots.slot)
    part = _flat_exchange(part.reshape(ep, c1, d), cfg, ep, group,
                          reverse=True).reshape(ep * c1, d)
    return kops.segment_scatter_add(part, plan1.src_of_slot,
                                    _ones(ep * c1, part), t, plan1.slots.slot)


# ======================================================================
# disagg: the paper's §2.3 baseline (materialised sort passes, plain torch)
# ======================================================================

def _inverse_rows(slot: torch.Tensor, values: torch.Tensor,
                  n: int) -> torch.Tensor:
    """(n,) int32: ``values[i]`` at row ``slot[i]``, -1 where no slot
    lands (the reference's ``full(-1).at[drop_neg(slot)].set(values)``)."""
    out = torch.full((n + 1,), -1, dtype=I32, device=slot.device)
    out[torch.where(slot < 0, n, slot).long()] = values.to(I32)
    return out[:n]


def disagg_dispatch(x: torch.Tensor, A: torch.Tensor, gates: torch.Tensor,
                    placement: ExpertPlacement, cfg: DcommConfig,
                    group: dist.ProcessGroup | None = None) -> DispatchResult:
    t, d = x.shape
    k = A.shape[1]
    ep, e_local = placement.ep, placement.experts_per_lane
    cap_lane = _cap(t * k / ep, cfg.capacity_factor)
    cap_e = _cap(t * k / (ep * e_local), cfg.capacity_factor)
    dev = x.device

    replica = balanced_replica_choice(A, placement)
    lane = placement.lane_of_expert(A, replica).reshape(-1)       # (T*K,)
    eloc = placement.local_expert_index(A, replica).reshape(-1)
    tok = torch.arange(t, dtype=I32, device=dev)[:, None].expand(A.shape).reshape(-1)

    # pass 1: materialised sort by destination lane (the pre-a2a permutation)
    order = torch.argsort(lane, stable=True)
    xs = x[tok[order].long()]                                     # (T*K, d)
    lane_s, eloc_s = lane[order], eloc[order]

    # pass 2: pack into the per-lane capacity buffer (device-major layout)
    n1 = ep * cap_lane
    st = build_slot_table(lane_s, ep, cap_lane)
    inv = _inverse_rows(st.slot, torch.arange(t * k, device=dev), n1)
    buf = gather_rows(xs, inv)                                    # (EP*cap, d)
    meta = _inverse_rows(st.slot, eloc_s, n1)

    buf = _flat_exchange(buf.reshape(ep, cap_lane, d), cfg, ep, group)
    meta = _flat_exchange(meta.reshape(ep, cap_lane), cfg, ep, group)
    buf = buf.reshape(n1, d)
    meta = meta.reshape(n1)

    # pass 3: receiver-side materialised sort by expert, then repack
    order2 = torch.argsort(torch.where(meta >= 0, meta, e_local), stable=True)
    xr = buf[order2]
    meta_r = meta[order2]
    n2 = e_local * cap_e * ep
    st2 = build_slot_table(meta_r, e_local, cap_e * ep)
    inv2 = _inverse_rows(st2.slot, torch.arange(n1, device=dev), n2)
    ebuf = gather_rows(xr, inv2).reshape(1, e_local, cap_e * ep, d)
    counts = st2.counts.clamp(max=cap_e * ep).to(I32).reshape(1, e_local)
    state = (order, st, order2, st2, t, d, k, cap_lane)
    return DispatchResult(ebuf, state, st.dropped() + st2.dropped(), counts)


def disagg_combine(expert_out: torch.Tensor, res: DispatchResult,
                   placement: ExpertPlacement, cfg: DcommConfig,
                   gates: torch.Tensor,
                   group: dist.ProcessGroup | None = None) -> torch.Tensor:
    order, st, order2, st2, t, d, k, cap_lane = res.state
    ep = placement.ep
    flat = expert_out.reshape(-1, d)
    # inverse pass 3: sorted row i lives at expert-buffer slot st2.slot[i]
    # and came from receive-buffer row order2[i] (a permutation: each row is
    # written once)
    vals = gather_rows(flat, st2.slot)
    back = torch.zeros((ep * cap_lane, d), dtype=flat.dtype,
                       device=flat.device).index_copy(0, order2, vals)
    back = _flat_exchange(back.reshape(ep, cap_lane, d), cfg, ep, group,
                          reverse=True)
    back = back.reshape(ep * cap_lane, d)
    # inverse passes 2 + 1: unpack, unsort, gated sum over each token's k
    srt = gather_rows(back, st.slot)                              # sorted order
    unsrt = torch.zeros((t * k, d), dtype=srt.dtype,
                        device=srt.device).index_copy(0, order, srt)
    w = gates.reshape(-1, 1).to(unsrt.dtype)
    return (unsrt * w).reshape(t, k, d).sum(dim=1)


# ======================================================================
# ragged: compact rows on the wire, no capacity padding
# ======================================================================

class RaggedDescriptors(NamedTuple):
    """Sender-side ragged descriptors from a flat plan: ``compact_src`` (R,)
    the source token of each compact send row (the dense slot layout
    squeezed, -1 tail padding), ``compact_gate`` its combine weight, and per
    destination lane the (``input_offsets``, ``send_sizes``) pair over the
    compact buffer."""
    compact_src: torch.Tensor
    compact_gate: torch.Tensor
    input_offsets: torch.Tensor
    send_sizes: torch.Tensor


def build_ragged_descriptors(plan: planner_lib.FlatPlan,
                             placement: ExpertPlacement,
                             cap: int) -> RaggedDescriptors:
    e_local = placement.experts_per_lane
    counts = plan.slots.counts.reshape(placement.ep, e_local).clamp(max=cap)
    send_sizes = counts.sum(1).to(I32)                          # (EP,)
    input_offsets = (torch.cumsum(send_sizes, 0) - send_sizes).to(I32)
    # the dense slot table squeezed into wire order (lane-major,
    # expert-major, arrival order): a stable sort puts occupied slots first
    occupied = plan.src_of_slot >= 0
    order = torch.argsort((~occupied).to(torch.int8), stable=True)
    in_prefix = torch.arange(order.shape[0], device=order.device) < occupied.sum()
    compact_src = torch.where(in_prefix, plan.src_of_slot[order], -1).to(I32)
    compact_gate = torch.where(in_prefix, plan.gate_of_slot[order],
                               0).to(plan.gate_of_slot.dtype)
    return RaggedDescriptors(compact_src, compact_gate, input_offsets,
                             send_sizes)


def ragged_owner_table(plan: planner_lib.FlatPlan) -> torch.Tensor:
    """(T, K) int32: the compact row of each (token, k) assignment, -1 when
    dropped; the exact inverse of ``compact_src``, in k order as the flat
    plan's slot table, so the combine sums each token's rows in fused_flat's
    order (the port's addition)."""
    rank = torch.cumsum((plan.src_of_slot >= 0).to(I32), 0) - 1
    slot = plan.slots.slot
    return torch.where(slot >= 0, rank[slot.clamp_min(0).long()], -1).to(I32)


def ragged_reverse_descriptors(input_offsets: torch.Tensor,
                               send_sizes: torch.Tensor,
                               recv_offsets: torch.Tensor,
                               recv_sizes: torch.Tensor,
                               peer_input_offsets: torch.Tensor):
    """Invert a ragged exchange's descriptors for the combine: what this
    lane received from lane p (``recv_offsets[p]``/``recv_sizes[p]``) goes
    back to p's compact segment, whose start is p's forward offset for us
    (``peer_input_offsets``).  Returns the reverse (input_offsets,
    send_sizes, output_offsets, recv_sizes)."""
    return recv_offsets, recv_sizes, peer_input_offsets, send_sizes


def _ragged_all_to_all(buf: torch.Tensor, send: list[int], recv: list[int],
                       group) -> torch.Tensor:
    buf = buf.contiguous()
    out = torch.empty((sum(recv), *buf.shape[1:]), dtype=buf.dtype,
                      device=buf.device)
    dist.all_to_all_single(out, buf, recv, send, group=group)
    return out


class _RaggedAllToAll(torch.autograd.Function):
    """``all_to_all_single`` with per-peer split sizes (host lists); its
    transpose is the same exchange with the sizes swapped."""

    @staticmethod
    def forward(ctx, buf, send, recv, group):
        ctx.send, ctx.recv, ctx.group = send, recv, group
        return _ragged_all_to_all(buf, send, recv, group)

    @staticmethod
    def backward(ctx, g):
        return (_ragged_all_to_all(g, ctx.recv, ctx.send, ctx.group), None,
                None, None)


def _unpack_index(recv_counts: torch.Tensor, cap: int) -> torch.Tensor:
    """(EP * E_local * cap,) int32: the landed compact row of each (source
    lane, local expert, position) slot, -1 past the group's count.  Each
    source lane's segment arrives expert-major in arrival order, so group
    (s, e) starts at the exclusive prefix sum of the counts."""
    flat = recv_counts.reshape(-1).to(I32)
    start = torch.cumsum(flat, 0) - flat
    c = torch.arange(cap, dtype=I32, device=flat.device)
    return torch.where(c < flat[:, None], start[:, None] + c,
                       -1).reshape(-1).to(I32)


def ragged_dispatch(x: torch.Tensor, A: torch.Tensor, gates: torch.Tensor,
                    placement: ExpertPlacement, cfg: DcommConfig,
                    group=None) -> DispatchResult:
    """The compact rows (``build_ragged_descriptors``) gathered and sent
    with per-peer split sizes; the landing lane unpacks them into the
    (EP, E_local, C, d) expert-grouped buffer with one gather, from the
    exchanged per-(lane, expert) counts, which are also the FFN's
    occupancy.  Over more than one lane the split sizes are read to the
    host once (``all_to_all_single`` takes them as lists)."""
    t, d = x.shape
    k = A.shape[1]
    ep, e_local = placement.ep, placement.experts_per_lane
    cap = _cap(t * k / (ep * e_local), cfg.capacity_factor)
    plan = planner_lib.build_flat_plan(A, gates, placement, cap)
    desc = build_ragged_descriptors(plan, placement, cap)
    owners = ragged_owner_table(plan)
    send_buf = kops.segment_gather(x, desc.compact_src, owners)      # (R, d)
    recv_counts = _landed_counts(plan, placement, cap, group)   # (EP, El)
    splits = None
    landed = send_buf
    if group_size(group) > 1:
        # the one device-to-host read: both directions' split sizes
        send, recv = torch.stack([desc.send_sizes,
                                  recv_counts.sum(1).to(I32)]).tolist()
        splits = (send, recv)
        landed = _RaggedAllToAll.apply(send_buf[:sum(send)], send, recv,
                                       process_group(group))
    unpack = _unpack_index(recv_counts, cap)
    landed_slot = _inverse_rows(unpack, torch.arange(unpack.shape[0],
                                                     device=x.device),
                                landed.shape[0])
    expert_rows = kops.segment_gather(landed, unpack, landed_slot[:, None])
    return DispatchResult(expert_rows.reshape(ep, e_local, cap, d),
                          (desc, owners, unpack, landed_slot, splits, t),
                          plan.dropped, recv_counts)


def ragged_combine(expert_out: torch.Tensor, res: DispatchResult,
                   placement: ExpertPlacement, cfg: DcommConfig,
                   group=None) -> torch.Tensor:
    """The expert outputs gathered back into landed compact order, the
    reverse exchange with the split sizes swapped
    (``ragged_reverse_descriptors``' sizes; ``all_to_all_single`` places
    each segment at the running sum of the sizes, so the offsets are
    implied), and one gated scatter-add home over ``ragged_owner_table``."""
    desc, owners, unpack, landed_slot, splits, t = res.state
    d = expert_out.shape[-1]
    back = kops.segment_gather(expert_out.reshape(-1, d), landed_slot,
                               unpack[:, None])
    if splits is not None:
        send, recv = splits
        back = _RaggedAllToAll.apply(back, recv, send, process_group(group))
    n = back.shape[0]
    return kops.segment_scatter_add(back, desc.compact_src[:n],
                                    desc.compact_gate[:n], t, owners)
