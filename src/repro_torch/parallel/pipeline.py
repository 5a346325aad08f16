"""GPipe-style pipeline parallelism over a process group (port of
``repro/parallel/pipeline.py``).

Layers are split into ``n_stages`` groups, one a rank of ``group``;
microbatches stream through with a ring hop between neighbouring stages.
The schedule is the reference's fill-run-drain loop: at tick t stage 0 feeds
microbatch min(t, n_micro - 1), stage s runs ``stage_fn`` on what stage
s - 1 sent at tick t - 1, and the last stage emits microbatch t - (n_stages
- 1).  The fill and drain ticks run ``stage_fn`` too, as the reference's
scan does, and every tick's activations are kept for the backward.

Each rank holds its own stage's parameters (the reference's leading stage
dim over the pipeline axis; :func:`stage_slice` cuts one out of a stacked
tree).  The backward is differentiable end to end and counts the replicated
output once, as ``jax.grad`` through the reference does:

- the hop (the reference's ``ppermute``) is an ``all_to_all_single`` whose
  split sizes only the neighbour fills; its transpose is the reverse hop;
- stage 0 selects the feed over what it received with ``torch.where``, so
  the received tensor stays in the graph and takes a zero cotangent: every
  rank runs every hop's backward, in the same order;
- the last stage's outputs reach every rank by a broadcast (the
  reference's masked ``psum``); each rank differentiates the same loss of
  them, so the last stage takes its own cotangent once and the others none
  (:func:`last_stage_cotangent`);
- the replicated input is read by stage 0 alone, so its gradient is summed
  over the group (:func:`summed_cotangent`): every rank's is the whole.

``group`` None is a group of one rank (one stage, no collective).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.core import dcomm
from repro_torch.optim import adamw


def stage_slice(tree, s: int):
    """Stage ``s``'s parameters of a tree stacked on a leading stage dim."""
    return adamw.tree_map(lambda p: p[s], tree)


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """``x`` sent to the rank ``step`` after this one on the ring of
    ``group``; what the rank ``step`` before it sent."""
    n, r = dcomm.group_size(group), dcomm.lane_index(group)
    if n == 1:
        return x
    send, recv = [0] * n, [0] * n
    send[(r + step) % n], recv[(r - step) % n] = 1, 1
    buf = x.contiguous().reshape(1, -1)
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, recv, send, group=group)
    return out.reshape(x.shape)


class _RingHop(torch.autograd.Function):
    """Each rank's tensor to the next rank of the ring; the backward sends
    each cotangent back to the rank before."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def last_stage_cotangent(g: torch.Tensor, group) -> torch.Tensor:
    """The cotangent of the broadcast's input on this rank: on the last
    stage its own ``g``, elsewhere zeros (every rank holds the same loss of
    the one replicated output)."""
    n = dcomm.group_size(group)
    return g if dcomm.lane_index(group) == n - 1 else torch.zeros_like(g)


def summed_cotangent(g: torch.Tensor, group) -> torch.Tensor:
    """The cotangent of a replicated input that one rank reads: every
    rank's summed over the group."""
    if dcomm.group_size(group) == 1:
        return g
    g = g.clone()
    dist.all_reduce(g, group=group)
    return g


class _FromLastStage(torch.autograd.Function):
    """The last rank's tensor on every rank of the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dcomm.group_size(group)
        out = x.clone(memory_format=torch.contiguous_format)
        if n > 1:
            dist.broadcast(out, src=dist.get_global_rank(group, n - 1),
                           group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return last_stage_cotangent(g, ctx.group), None


def from_last_stage(x: torch.Tensor, group) -> torch.Tensor:
    return _FromLastStage.apply(x, group)


class _Replicated(torch.autograd.Function):
    """The identity on a tensor every rank holds; its cotangent summed over
    the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return summed_cotangent(g, ctx.group), None


def pipeline_apply(stage_fn: Callable, stage_params, x_microbatches: torch.Tensor,
                   *, group) -> torch.Tensor:
    """Run ``n_micro`` microbatches through the ``n_stages`` ranks of
    ``group``, this rank its stage.

    stage_fn(stage_params, x) -> y   (same shape as x)
    stage_params: this rank's stage.
    x_microbatches: (n_micro, mb, ...), the same on every rank.
    Returns the last stage's (n_micro, mb, ...) outputs on every rank.
    """
    n, s = dcomm.group_size(group), dcomm.lane_index(group)
    n_micro = x_microbatches.shape[0]
    ticks = n_micro + n - 1
    xs = _Replicated.apply(x_microbatches, group)
    first = torch.full((), s == 0, dtype=torch.bool, device=xs.device)
    state = torch.zeros(xs.shape[1:], dtype=xs.dtype, device=xs.device)
    emitted = []
    for t in range(ticks):
        out = stage_fn(stage_params,
                       torch.where(first, xs[min(t, n_micro - 1)], state))
        if t >= n - 1:
            emitted.append(out)
        if t < ticks - 1:       # the last tick's hop reaches no stage
            state = _RingHop.apply(out, group)
    return from_last_stage(torch.stack(emitted), group)
