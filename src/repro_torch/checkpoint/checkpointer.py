"""Step-atomic checkpoints in the reference's on-disk layout, with an async
save and a restore onto another grid (port of
``repro/checkpoint/checkpointer.py``).

Layout, the reference's:  <dir>/step_<N>/
                            manifest.json  {"step", "treedef", "leaves":
                                            [{"shape", "dtype"}, ...]}
                            arr_<i>.npy    one file a leaf, whole
                          <dir>/LATEST     the committed step, written last

``step_<N>`` is written as ``step_<N>.tmp`` and renamed, then ``LATEST``
through ``LATEST.tmp``: a step counts once ``LATEST`` names it.  Leaf ``i``
is the ``i``-th in the order jax flattens the tree: dicts by sorted key,
tuples and NamedTuples by position, so a train state ``(params,
AdamWState(step, mu, nu, master))`` numbers the params' leaves, then the
step as a 0-d int32 (the reference's ``adamw.init``), then mu, nu and
master.  bfloat16 is stored as its ``uint16`` bits with ``"bfloat16"`` in
the manifest, as the reference stores it; the port reads those bits as
``torch.bfloat16``, so no ``ml_dtypes`` is needed.  ``treedef`` is a
string of the port's own; the reference's restore does not read it.

An async save takes the host copy at once (the train step then updates the
state in place), and a thread writes the files; :func:`wait` joins it.

Over a group of ranks (:class:`Layout`) every leaf is still saved whole, as
the reference's host-gathered leaves: each expert leaf (``lm.lane_sharded``)
is gathered over the EP group, each ZeRO-1 slice of mu, nu and master
(``adamw.zero_dim`` of its parameter) over the data group first; rank 0 of
the layout's world writes, and :func:`wait` ends in a barrier, so that every
rank reads the same ``LATEST`` after it.  :func:`restore` over a group reads
each leaf with ``np.load(mmap_mode="r")`` and keeps this rank's lane and
ZeRO-1 slice of the layout given, which may be another grid's than the
saver's (``runtime/elastic.remesh_restore``).  Under FSDP of the experts
(``Layout.fsdp``) an expert leaf's f-slice, parameter and state alike, is
gathered over the data group on its f dim (``parallel/sharding``) instead
of a ZeRO-1 slice, and a restore cuts it so, with FSDP on or off.  Under
Megatron TP (``Layout.tp``) a TP leaf's shard, parameter and state alike,
is gathered over the model group on its TP dim (``sharding.TP_DIM``) after
its ZeRO-1 slice over the data group, so the file holds the whole leaf, the
reference's bits; a restore cuts it onto any grid, TP or not.  A training
layout over a model group (``Layout.vocab``) holds the vocab pair split
over it the same way, on the dim ``sharding.vocab_dim`` gives its whole
shape (the vocab, or d where the group does not divide the vocab).  A
layout whose Mamba2 mixers split by SSM head (``Layout.ssm``, the ssm and
hybrid families over a model group that divides their heads) holds each
Mamba2 leaf's head-aligned cut (``sharding.SSM_DIM``): a save gathers the
ranks' cuts whole (``sharding.ssm_gather``), a restore cuts them again
(``sharding.ssm_cut``), onto any grid.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import dcomm
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.parallel import sharding

_BF16 = "bfloat16"


@dataclasses.dataclass(frozen=True, eq=False)
class Layout:
    """How this rank holds the whole leaves: lane ``lane`` of ``ep`` (the
    expert leaves) over ``ep_group``, data rank ``d`` of ``dp`` (ZeRO-1 of
    the optimizer state) over ``data_group``; ``world`` holds every rank
    (None: one); ``fsdp``: the expert leaves' f dim is split over the data
    group (parameters and state; ZeRO-3 of the experts); ``tp``: the TP
    leaves are this rank's shard of ``ep`` over ``ep_group`` (the model
    group); ``vocab``: (V, d) of a model whose vocab pair is this rank's
    shard of ``ep`` (``models/lm.vocab_parallel``; None: whole); ``ssm``:
    the ``sharding.SsmDims`` of a model whose Mamba2 leaves are this rank's
    cut by SSM head of ``ep`` (``models/lm.ssm_group``; None: whole)."""
    ep: int = 1
    lane: int = 0
    dp: int = 1
    d: int = 0
    ep_group: dist.ProcessGroup | None = None
    data_group: dist.ProcessGroup | None = None
    world: dist.ProcessGroup | None = None
    fsdp: bool = False
    tp: bool = False
    vocab: tuple[int, int] | None = None
    ssm: sharding.SsmDims | None = None

    @property
    def writer(self) -> bool:
        return self.world is None or dist.get_rank(self.world) == 0


ONE = Layout()


def layout(ep_group=None, mesh=None, fsdp: bool = False,
           tp: bool = False, vocab: tuple[int, int] | None = None,
           ssm: sharding.SsmDims | None = None) -> Layout:
    """The :class:`Layout` of a rank over ``ep_group`` (a group, a
    ``dcomm.EPGroups`` or None) or over ``mesh`` (a ``launch.mesh.HostMesh``,
    whose EP group is taken then), with the experts under FSDP over its
    data group (``fsdp``), the TP leaves sharded over its model group
    (``tp``), with ``vocab`` = (V, d) the vocab pair split over it (a
    training layout) and with ``ssm`` (a model's ``lm.ssm_dims``) the
    Mamba2 leaves cut by SSM head where the group divides the heads
    (``sharding.ssm_split``); that of a model context is
    :func:`context_layout`."""
    if mesh is not None:
        m = mesh.model
        return Layout(m, dcomm.lane_index(mesh.ep_group), mesh.data,
                      mesh.data_index, mesh.ep_group, mesh.data_group,
                      mesh.grid, fsdp and mesh.data > 1, tp and m > 1,
                      vocab if m > 1 else None,
                      ssm if sharding.ssm_split(ssm, m) else None)
    ep = dcomm.group_size(ep_group)
    if ep == 1:
        return ONE
    g = dcomm.process_group(ep_group)
    return Layout(ep, dcomm.lane_index(ep_group), ep_group=g, world=g, tp=tp,
                  vocab=vocab,
                  ssm=ssm if sharding.ssm_split(ssm, ep) else None)


def context_layout(ctx) -> Layout:
    """The :class:`Layout` of a ``models.lm.ModelContext``'s rank."""
    return layout(ctx.ep_group, ctx.mesh, ctx.fsdp_experts,
                  lm.tensor_parallel(ctx),
                  (ctx.cfg.vocab, ctx.cfg.d_model) if lm.vocab_parallel(ctx)
                  else None, lm.ssm_dims(ctx.cfg))


# --- the tree -----------------------------------------------------------------

def _flatten(tree, path=()):
    """(path, leaf) pairs in jax's flattening order; a path holds dict keys,
    tuple positions and NamedTuple field names."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (k,))
    elif isinstance(tree, tuple):
        names = getattr(tree, "_fields", None) or range(len(tree))
        for name, sub in zip(names, tree):
            yield from _flatten(sub, path + (name,))
    else:
        yield path, tree


def _unflatten(tree, leaves):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}      # the like tree's order
        if isinstance(node, tuple):
            subs = [build(s) for s in node]
            return type(node)(*subs) if hasattr(node, "_fields") else tuple(
                subs)
        return next(it)

    return build(tree)


def _treedef(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, tuple):
        inner = ", ".join(_treedef(s) for s in tree)
        return f"{type(tree).__name__}({inner})"
    return "*"


class _Role:
    """Where a leaf of a train state sits: its model path ("a/b/c", None
    outside a params-shaped tree), whether it is optimizer state (mu, nu or
    master: ZeRO-1 cuts it), and its parameter's shape on this rank."""

    def __init__(self, path: tuple, params_shape: dict):
        keys = [p for p in path if isinstance(p, str)]
        self.state = bool(keys) and keys[0] in ("mu", "nu", "master")
        self.model = "/".join(keys[1:] if self.state else keys) or None
        self.param = params_shape.get(self.model)

    def sharded(self, lay: Layout) -> bool:
        return lay.ep > 1 and self.model is not None and lm.lane_sharded(
            self.model)

    def fsdp(self, lay: Layout) -> bool:
        return lay.fsdp and self.model is not None and sharding.fsdp_sharded(
            self.model)

    def split(self, lay: Layout) -> int | None:
        """The dim, from the end, this rank's part is cut on over the model
        group: a TP shard's under ``lay.tp``, the vocab pair's under
        ``lay.vocab`` (``sharding.vocab_dim`` of its whole shape), a Mamba2
        leaf's under ``lay.ssm`` (:meth:`ssm`)."""
        if self.model is None:
            return None
        if self.ssm(lay):
            return sharding.SSM_DIM[self.model][0]
        if lay.tp and sharding.tp_sharded(self.model):
            return sharding.tp_dim(self.model)
        if lay.vocab is None or self.model not in sharding.VOCAB_DIM:
            return None
        v, d = lay.vocab
        shape = (v, d) if self.model == "embed" else (d, v)
        return sharding.vocab_dim(self.model, shape, lay.ep)

    def ssm(self, lay: Layout) -> bool:
        """Whether this rank's part is a Mamba2 leaf's cut by SSM head."""
        return self.model is not None and sharding.ssm_segments(
            self.model, lay.ssm, lay.ep) is not None

    def zero(self, rank_param_shape, lay: Layout) -> int | None:
        if not self.state or rank_param_shape is None or self.fsdp(lay):
            return None
        return adamw.zero_dim(rank_param_shape, lay.dp,
                              self.model is not None
                              and lm.lane_sharded(self.model),
                              self.split(lay))


def _params_shapes(tree) -> dict:
    """The shape of each parameter of a train state ``(params, AdamWState)``
    by model path (empty for another tree)."""
    if (isinstance(tree, tuple) and len(tree) == 2
            and isinstance(tree[1], adamw.AdamWState)
            and isinstance(tree[0], dict)):
        return {"/".join(p): tuple(t.shape) for p, t in _flatten(tree[0])}
    return {}


def _roles(tree):
    shapes = _params_shapes(tree)
    return [(_Role(path, shapes), leaf) for path, leaf in _flatten(tree)]


# --- save -----------------------------------------------------------------------

def _all_gather(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


def _whole(role: _Role, t: torch.Tensor, lay: Layout) -> torch.Tensor:
    """The whole leaf of this rank's ``t``: its ZeRO-1 slice (or its FSDP
    slice) gathered over the data group, then its lane over the EP group
    (or its TP or vocab shard over the model group)."""
    if role.fsdp(lay):
        t = _all_gather(t, sharding.fsdp_dim(role.model) % t.dim(),
                        lay.data_group, lay.dp)
    elif lay.dp > 1:
        dim = role.zero(role.param, lay)
        if dim is not None:
            t = _all_gather(t, dim, lay.data_group, lay.dp)
    if role.sharded(lay):
        t = _all_gather(t, adamw.LANE_DIM, lay.ep_group, lay.ep)
    split = role.split(lay)
    if role.ssm(lay):
        parts = [torch.empty_like(t) for _ in range(lay.ep)]
        dist.all_gather(parts, t.contiguous(), group=lay.ep_group)
        t = sharding.ssm_gather(role.model, parts, lay.ssm)
    elif split is not None:
        t = _all_gather(t, split % t.dim(), lay.ep_group, lay.ep)
    return t


def _host(t) -> np.ndarray:
    """A host copy of a leaf, bf16 as its uint16 bits (the file's form)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t, dtype=np.int32)            # AdamWState.step
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


class Pending:
    """A save in flight: ``gather_ms`` (the host copy, gathers included) at
    once; after :func:`wait`, ``write_s`` and ``bytes`` (the step's files)
    on the writing rank."""

    def __init__(self, gather_ms: float, lay: Layout):
        self.gather_ms = gather_ms
        self.write_s = None
        self.bytes = 0
        self.error = None
        self.thread = None
        self.layout = lay


def save(path: str, tree, step: int, async_: bool = True,
         lay: Layout = ONE) -> Pending:
    """Save ``tree`` as committed step ``step`` under ``path``; with
    ``async_`` the files are written on a thread (:func:`wait` joins it).
    Over a group every rank calls it (the gathers are collective)."""
    t0 = time.perf_counter()
    host, meta = [], []
    for role, leaf in _roles(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = _whole(role, leaf, lay)
        if lay.writer:
            a = _host(leaf)
            bf16 = isinstance(leaf, torch.Tensor) and (
                leaf.dtype == torch.bfloat16)
            host.append(a)
            meta.append({"shape": list(a.shape),
                         "dtype": _BF16 if bf16 else str(a.dtype)})
    pending = Pending((time.perf_counter() - t0) * 1e3, lay)
    if not lay.writer:
        return pending
    manifest = {"step": step, "treedef": _treedef(tree), "leaves": meta}
    tdir = os.path.join(path, f"step_{step}")

    def write():
        try:
            w0 = time.perf_counter()
            tmp = tdir + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            for i, a in enumerate(host):
                np.save(os.path.join(tmp, f"arr_{i}.npy"), a)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(tdir):
                shutil.rmtree(tdir)
            os.replace(tmp, tdir)
            with open(os.path.join(path, "LATEST.tmp"), "w") as f:
                f.write(str(step))
            os.replace(os.path.join(path, "LATEST.tmp"),
                       os.path.join(path, "LATEST"))
            pending.write_s = time.perf_counter() - w0
            pending.bytes = sum(
                os.path.getsize(os.path.join(tdir, n))
                for n in os.listdir(tdir))
        except Exception as e:      # re-raised by wait() on the caller's thread
            pending.error = e

    if async_:
        pending.thread = threading.Thread(target=write, daemon=True)
        pending.thread.start()
    else:
        write()
    return pending


def barrier(lay: Layout) -> None:
    """Wait for every rank of ``lay``'s world (none alone)."""
    if lay.world is not None:
        dist.barrier(group=lay.world)


def wait(handle: Pending | None) -> None:
    """Join a save (None: nothing); over a group every rank calls it, and
    it ends in a barrier, after which ``LATEST`` names the step on every
    rank.  Raises what the writing thread raised."""
    if handle is None:
        return
    if handle.thread is not None:
        handle.thread.join()
        handle.thread = None
    barrier(handle.layout)
    if handle.error is not None:
        err, handle.error = handle.error, None
        raise err


def latest_step(path: str | None) -> int | None:
    """The committed step under ``path`` (None: none, or no ``path``)."""
    if path is None:
        return None
    p = os.path.join(path, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


# --- restore --------------------------------------------------------------------

def _cut(role: _Role, a: np.ndarray, lay: Layout) -> np.ndarray:
    """This rank's part of a whole leaf ``a``: its lane or its TP or vocab
    shard, then its ZeRO-1 slice (of the parameter's held shape) or its
    FSDP slice."""
    if role.sharded(lay):
        a = lm.lane_cut(role.model, a, lay.ep, range(lay.lane, lay.lane + 1))
    split = role.split(lay)
    if role.ssm(lay):
        a = sharding.ssm_cut(role.model, a, lay.ssm, lay.ep, lay.lane)
    elif split is not None:
        a = sharding.data_cut(a, split, lay.ep, lay.lane)
    if role.fsdp(lay):
        return sharding.data_cut(a, sharding.fsdp_dim(role.model), lay.dp,
                                 lay.d)
    if lay.dp > 1:
        dim = role.zero(a.shape, lay)
        if dim is not None:
            n = a.shape[dim] // lay.dp
            a = a[(slice(None),) * dim + (slice(lay.d * n, (lay.d + 1) * n),)]
    return a


def _leaf(a: np.ndarray, dtype_name: str, like):
    """The saved array ``a`` as ``like``'s type, dtype and device."""
    if not isinstance(like, torch.Tensor):
        return type(like)(a)
    a = np.array(a)                       # read from the file, contiguous
    t = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
         if dtype_name == _BF16 else torch.from_numpy(a))
    return t.to(device=like.device, dtype=like.dtype)


def restore(path: str, like_tree, step: int | None = None,
            lay: Layout = ONE):
    """Restore into the structure of ``like_tree`` (leaves: this rank's
    tensors, on their devices; the step an int); returns (tree, step).
    Each leaf's saved shape must be the whole of ``like``'s under ``lay``
    (the reference checks the shape, ``:112-114``); values are cast to
    ``like``'s dtype."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {path}")
    tdir = os.path.join(path, f"step_{step}")
    with open(os.path.join(tdir, "manifest.json")) as f:
        manifest = json.load(f)
    roles = _roles(like_tree)
    if len(roles) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, "
                         f"the tree {len(roles)}")
    out = []
    for i, (role, like) in enumerate(roles):
        a = np.load(os.path.join(tdir, f"arr_{i}.npy"), mmap_mode="r")
        a = _cut(role, a, lay)
        want = tuple(like.shape) if isinstance(like, torch.Tensor) else ()
        if tuple(a.shape) != want:
            raise ValueError(f"leaf {i}: checkpoint shape {tuple(a.shape)} "
                             f"(this rank's part) != {want}")
        out.append(_leaf(a, manifest["leaves"][i]["dtype"], like))
    return _unflatten(like_tree, out), step
