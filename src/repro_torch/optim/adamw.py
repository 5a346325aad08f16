"""AdamW with global-norm clipping and a cosine schedule with warm-up, on an
f32 master, and ZeRO-1 state sharding over a data group (port of
``repro/optim/adamw.py``).

Over an EP group each rank holds its lane of the expert leaves, and their
state (mu, nu, master) with them; the other leaves, and their state, are the
same on every rank.  The clip norm is the whole tree's, as the reference
clips: the lane-sharded leaves' sum of squares is summed over the group, the
replicated leaves' is counted once (:func:`global_norm`).

ZeRO-1 over a data group of DP ranks (the reference's ``zero1_specs``): each
data rank holds 1/DP of a leaf's mu, nu and master, cut on the leaf's first
dim that is not sharded (the lane dim of a lane-sharded leaf is), divides by
DP and is at least DP (:func:`zero_dim`); a leaf with no such dim keeps its
whole state on every data rank.  The gradients reaching :func:`update` are
whole and summed over the data group, so the clip norm spans the EP group
only; each rank updates its slice and the new slices are all-gathered over
the data group, so every data rank again holds whole parameters.  (An
all-reduce and an all-gather, not a reduce-scatter: ZeRO-1 shards the state
alone, and gloo runs no reduce-scatter.)

A leaf that ``fsdp`` (a predicate on its path) names is the rank's own
slice of a parameter split over the data group (ZeRO-3 of the experts,
``models/lm.fsdp_group``): its gradient arrives already summed over the data
group and cut to the slice, its state is the slice's own (no ZeRO-1 cut)
and nothing is gathered after its update.  Its sum of squares is the rank's
share of the clip norm over the group it is split across (the caller's
``group``: the whole grid).

Under Megatron TP each rank also holds its shard of the TP leaves
(``parallel/sharding.TP_DIM``), and in training over a model group its
shard of the vocab pair (``embed``, ``lm_head``); their gradients are whole
over the model group and the same on every data rank.  The clip norm sums
their squares over the model group once: the caller's ``split`` names them
beside the lane-sharded leaves, and over a group where each shard is held
by k ranks (the grid, under FSDP: k = DP) it weighs their squares by 1/k.
ZeRO-1 cuts the local shard on its first dim that is not the model-split
one (:func:`zero_dim`: a vocab-split ``embed`` (V / m, d) on d, as the
reference's ``zero1_specs``).  A Mamba2 leaf split by SSM head over the
model group holds besides its heads' columns the B and C columns whole
(``parallel/sharding.ssm_whole``): the caller's ``whole`` names those, and
the clip norm counts their squares once.

Parameters and optimizer state are dictionaries of tensors (the model's
parameter tree).  Mixed precision as in the reference: the gradients, in
the parameters' dtype, update the f32 master, mu and nu; the parameters are
the master cast back to their dtype.  Where the reference builds new arrays,
:func:`update` writes every leaf in place, and walks each leaf in slices of
at most ``SLICE`` elements, so its f32 temporaries stay a few hundred MB
even for a 805 M-element expert leaf (a whole-leaf update would add ~3.2 GB
per temporary).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.distributed as dist

# LANE_DIM: the dim a ``sharded`` leaf is split on over the EP group, the
# lane axis of lm's (L, lanes, ...) experts
from repro_torch.parallel.sharding import LANE_DIM

SLICE = 1 << 26          # elements per slice of a leaf in update/global_norm


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: int
    mu: dict
    nu: dict
    master: dict       # f32 master weights (model params may be bf16)


def leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested dictionary, in insertion order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    return [tree]


def paths(tree, prefix: str = "") -> list[str]:
    """The "a/b/c" paths of a nested dictionary's tensors, in the order of
    :func:`leaves`."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in paths(v, f"{prefix}{k}/")]
    return [prefix[:-1]]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def unflatten(like, flat):
    """A tree shaped like ``like`` holding ``flat`` (as :func:`leaves`
    orders them)."""
    it = iter(flat)
    return tree_map(lambda _: next(it), like)


def zero_dim(shape, dp: int, sharded: bool = False,
             split: int | None = None) -> int | None:
    """ZeRO-1's dim of a leaf of ``shape`` over ``dp`` data ranks: its first
    dim that is not sharded (``sharded``: dim ``LANE_DIM`` is; ``split``,
    from the end: the dim split over the model group, a TP leaf's or the
    vocab pair's), is divisible by ``dp`` and at least ``dp``; None with
    one data rank or no such dim (the reference's ``zero1_specs``, which
    skips every dim its spec shards)."""
    if dp <= 1:
        return None
    skip = {LANE_DIM} if sharded else set()
    if split is not None:
        skip.add(split % len(shape))
    return next((i for i, n in enumerate(shape)
                 if i not in skip and n % dp == 0 and n >= dp), None)


def _data_rank(data_group) -> tuple[int, int]:
    """(DP, this rank's index) of ``data_group`` (None: one data rank)."""
    if data_group is None:
        return 1, 0
    return dist.get_world_size(data_group), dist.get_rank(data_group)


def _own(t: torch.Tensor, dim: int | None, dp: int, d: int) -> torch.Tensor:
    """Data rank ``d``'s slice of ``t`` on ``dim`` (a view; ``t`` itself
    when ``dim`` is None)."""
    if dim is None:
        return t
    n = t.shape[dim] // dp
    return t.narrow(dim, d * n, n)


def _zero_dim(path: str, shape, dp: int, sharded, fsdp,
              model_dim=None) -> int | None:
    """:func:`zero_dim` of the leaf at ``path`` (``model_dim``: ``fn(path)
    -> dim`` split over the model group, ``models/lm.model_dim``); None
    for an ``fsdp`` leaf, whose state is its slice's own."""
    if fsdp is not None and fsdp(path):
        return None
    return zero_dim(shape, dp, bool(sharded and sharded(path)),
                    None if model_dim is None else model_dim(path))


def init(params, data_group: dist.ProcessGroup | None = None,
         sharded=None, fsdp=None, model_dim=None) -> AdamWState:
    """Zero mu and nu and the f32 master of ``params``; over a
    ``data_group`` of more than one rank this rank's ZeRO-1 slice of each
    (:func:`zero_dim`; ``sharded``, a predicate on a leaf's path, names the
    lane-sharded leaves; ``fsdp`` those held as the rank's slice, whose
    state is whole; ``model_dim`` the dim of each leaf split over the
    model group, which ZeRO-1 skips)."""
    dp, d = _data_rank(data_group)

    def own(path, p):
        dim = _zero_dim(path, p.shape, dp, sharded, fsdp, model_dim)
        return _own(p.detach(), dim, dp, d)

    mine = unflatten(params, [own(path, p) for path, p in
                              zip(paths(params), leaves(params))])
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    master = tree_map(lambda p: p.to(torch.float32, copy=True), mine)
    return AdamWState(0, tree_map(zeros, mine), tree_map(zeros, mine), master)


def schedule(cfg: AdamWConfig, step: int) -> float:
    """Learning rate at ``step`` (1-based): linear warm-up, then a cosine to
    ``min_lr_frac`` of ``lr`` at ``total_steps``."""
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    t = min(max((step - cfg.warmup_steps)
                / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def _slices(t: torch.Tensor):
    return t.reshape(-1).split(SLICE)


def _sum_squares(ts) -> torch.Tensor | None:
    tot = None
    for t in ts:
        for sl in _slices(t):
            part = sl.float().square().sum()
            tot = part if tot is None else tot + part
    return tot


def _whole_parts(t: torch.Tensor, cols) -> tuple[list, list]:
    """(the parts of ``t`` outside ``cols``, those inside): ``cols`` = (dim,
    [(start, stop)]) names the columns of a shard every rank holds alike
    (None: none)."""
    if not cols:
        return [t], []
    dim = cols[0] % t.dim()
    own, whole, at = [], [], 0
    for lo, hi in cols[1]:
        own.append(t.narrow(dim, at, lo - at))
        whole.append(t.narrow(dim, lo, hi - lo))
        at = hi
    own.append(t.narrow(dim, at, t.shape[dim] - at))
    return own, whole


def global_norm(tree, group: dist.ProcessGroup | None = None,
                sharded=None, whole=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, on the leaves'
    device (no host synchronisation).  Over a ``group`` of more than one
    rank, ``sharded`` (a predicate on a leaf's path, :func:`paths`) names
    the leaves each rank holds a shard of: their sum of squares is summed
    over the group with one ``all_reduce``, and the other leaves, the same
    on every rank, count once.  Where ``sharded`` returns a count k > 1,
    k ranks of the group hold that shard, and its squares are divided by k
    before the sum.  ``whole`` (``fn(path) -> (dim, [(start, stop)]) |
    None``) names the columns of a sharded leaf that every rank of the
    group holds alike: they count once.  With no group, or one of one
    rank, no collective is launched."""
    if group is None or dist.get_world_size(group) == 1:
        return _sum_squares(leaves(tree)).sqrt()
    if sharded is None:
        raise ValueError("global_norm over a group needs the predicate of "
                         "the sharded leaves")
    own, rep = {}, []
    for path, t in zip(paths(tree), leaves(tree)):
        k = int(sharded(path))
        if not k:
            rep.append(t)
            continue
        mine, alike = _whole_parts(t, whole and whole(path))
        own.setdefault(k, []).extend(mine)
        rep.extend(alike)
    part = torch.zeros((), device=leaves(tree)[0].device)
    for k, ts in own.items():
        sq = _sum_squares(ts)
        part = part + (sq if k == 1 else sq / k)
    dist.all_reduce(part, group=group)
    rest = _sum_squares(rep)
    return (part if rest is None else part + rest).sqrt()


def _gather(p: torch.Tensor, own: torch.Tensor, dim: int, group) -> None:
    """Write every data rank's slice ``own`` of ``p`` on ``dim`` into ``p``
    (one ``all_gather_into_tensor`` over ``group``, whose output is the
    ranks' slices concatenated on dim 0)."""
    if dim == 0:
        dist.all_gather_into_tensor(p, own, group=group)
        return
    src = own.movedim(dim, 0).contiguous()
    buf = src.new_empty((dist.get_world_size(group) * src.shape[0],
                         *src.shape[1:]))
    dist.all_gather_into_tensor(buf, src, group=group)
    p.movedim(dim, 0).copy_(buf)


@torch.no_grad()
def update(grads, state: AdamWState, params, cfg: AdamWConfig,
           group: dist.ProcessGroup | None = None, sharded=None,
           data_group: dist.ProcessGroup | None = None, fsdp=None,
           split=None, model_dim=None, whole=None):
    """One AdamW step: clip the gradients to ``clip_norm`` by their global
    norm (over ``group``, with ``split`` naming the leaves sharded over it,
    by default ``sharded``: :func:`global_norm`; ``sharded`` names the
    lane-sharded leaves, whose lane dim ZeRO-1 skips), update mu, nu and
    the f32 master, and copy the master into the parameters in their own
    dtype.  Over a ``data_group``
    of more than one rank the gradients are whole and the same on every
    data rank; the state is this rank's ZeRO-1 slice (:func:`init`), and
    the updated slices are all-gathered over the data group into the
    parameters; an ``fsdp`` leaf (a predicate on its path) is the rank's
    slice, its state whole, and is not gathered; ``model_dim`` (as in
    :func:`init`) names the dim ZeRO-1 skips; ``whole`` the columns of a
    split leaf the clip norm counts once (:func:`global_norm`).  Every leaf
    is written in place (params, mu, nu, master).
    Returns (params, new state, metrics)."""
    gnorm = global_norm(grads, group, sharded if split is None else split,
                        whole)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step
    b2c = 1 - cfg.b2 ** step
    dp, d = _data_rank(data_group)
    for path, g, m, v, w, p in zip(paths(params), leaves(grads),
                                   leaves(state.mu), leaves(state.nu),
                                   leaves(state.master), leaves(params)):
        p = p.detach()
        dim = _zero_dim(path, p.shape, dp, sharded, fsdp, model_dim)
        g = _own(g, dim, dp, d)
        own = p if dim is None else p.new_empty(g.shape)
        if g.shape != w.shape or own.shape != w.shape:
            raise ValueError(f"update: leaf {path} shapes {tuple(g.shape)}, "
                             f"{tuple(own.shape)}, {tuple(w.shape)} differ")
        pv = own.view(-1)
        for i, (gs, ms, vs, ws) in enumerate(zip(
                _slices(g.contiguous()), _slices(m), _slices(v),
                _slices(w))):
            gs = gs.float() * scale
            ms.mul_(cfg.b1).add_(gs, alpha=1 - cfg.b1)
            vs.mul_(cfg.b2).addcmul_(gs, gs, value=1 - cfg.b2)
            del gs
            den = (vs / b2c).sqrt_().add_(cfg.eps)
            upd = (ms / b1c).div_(den).add_(ws, alpha=cfg.weight_decay)
            del den
            ws.sub_(upd, alpha=lr)
            del upd
            pv[i * SLICE:i * SLICE + ws.numel()].copy_(ws)
        if dim is not None:
            _gather(p, own, dim, data_group)
    return params, AdamWState(step, state.mu, state.nu, state.master), {
        "grad_norm": gnorm, "lr": lr}


def state_bytes(state: AdamWState) -> int:
    """The bytes of ``state``'s mu, nu and master on this rank."""
    return sum(t.numel() * t.element_size()
               for tree in (state.mu, state.nu, state.master)
               for t in leaves(tree))
