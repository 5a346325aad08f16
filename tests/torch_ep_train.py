"""Harness of the grid training tests (``test_torch_train_ep.py``: the moe
family, ``test_torch_train_ep_tx.py``: moe_tx, both over an EP group of
four; ``test_torch_train_dp.py``: both over a (2, 2) (data, model) grid):
one train step of the port over four gloo ranks against the reference's
under ``shard_map``.

:func:`run_grid` saves, for each arch, seeded numpy parameters (the
reference's tree, expert leaves lane-major over the grid's EP lanes) and a
batch (labels with a few -1), then at once runs the reference in one
subprocess on four forced host devices (``jax.value_and_grad(lm.lm_loss)``
and the jitted ``make_train_step`` of each case on a ``(data, model)``
mesh, traffic threaded) and the port's four ranks on
``launch.mesh.make_host_mesh(data, model)`` (``convert.params_from_jax(...,
lane=r % model)``, the data rank's rows of the batch;
``steps.value_and_grad`` and ``steps.make_train_step``).  Each rank also
runs its gradients once more with the replicated leaves' reduction switched
off, and a second step; over more than one data rank it also runs the
three mutations of the data sync (:data:`MUTATIONS`).  With ``fsdp`` both
sides run the expert weights under FSDP over the data group (the
reference's ``fsdp_experts``; each rank converts its f-slice), and the
mutations are not run.  With ``tp`` the port's ranks run Megatron-SP
tensor parallelism over the model group (``lm.tensor_parallel``; each rank
converts its TP shards, ``convert.params_from_jax(..., model=)``), as the
reference does by default (``explicit_tp``); without it they keep the
replicated attention (``explicit_tp=False``), the same function in the
layout the EP and grid tests were written for.  Either way a model group
of more than one rank splits ``embed`` and ``lm_head`` over it
(``lm.vocab_parallel``, the reference's training specs): each rank converts
its shards of them, and the checks hold them against the reference's whole
leaf cut to the rank (:func:`lane_of`).  A dense arch (no experts)
threads no traffic state.  Everything lands in npz files that the tests
compare rank by rank.  :func:`run` is the (1, 4)
run of one arch.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from conftest import run_devices
from xla_prelude import PRELUDE
from torch_adam import close_updated, step_slack
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core import dcomm, traffic
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import data_rows
from repro_torch.models import lm, zoo
from repro_torch.optim import adamw
from repro_torch.parallel import sharding, tp_blocks

EP, NODE, B, S = 4, 2, 2, 16
TOL = 1e-5
# clip_norm well under the gradients' norm, so that clipping binds and a
# norm over one rank's leaves would scale the step differently
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10, clip_norm=0.05)
COUNTS = ("last_expert_count", "steps")
# the JAX oracle compiled without LLVM's optimisation passes: the same HLO
# (values agree to ~1e-7), a third less compile time
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def nest(items) -> dict:
    tree = {}
    for k, v in items:
        node = tree
        *path, leaf = k.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def close(got, want, what=""):
    """Within TOL relative to max(1, the leaf's largest magnitude)."""
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=what)


def check_state(got: dict, want: dict, what=""):
    """Every TrafficState leaf (``name -> array``): counts exactly."""
    for name in traffic.TrafficState._fields:
        assert got[name].shape == want[name].shape, (what, name)
        if name in COUNTS:
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=f"{what} {name}")
        else:
            close(got[name], want[name], f"{what} {name}")


def lane_of(want: np.ndarray, path: str, rank: int,
            shape=(1, EP), fsdp: bool = False, tp: bool = False) -> np.ndarray:
    """A whole leaf of the reference cut to the lane rank ``rank`` of a
    ``shape`` = (data, model) grid holds; with ``fsdp`` an expert leaf's
    f dim then cut to its data rank's slice; the vocab pair cut to the
    rank's shard over the model group (every training context splits it),
    and with ``tp`` a TP leaf too."""
    lane = rank % shape[1]
    t = lm.lane_cut(path, want, shape[1], range(lane, lane + 1))
    t = lm.tp_cut(path, t, shape[1], lane, tp=tp)
    if fsdp and shape[0] > 1 and sharding.fsdp_sharded(path):
        t = sharding.data_cut(t, sharding.fsdp_dim(path), shape[0],
                              rank // shape[1])
    return t


def state_of_rank(want: np.ndarray, path: str, rank: int,
                  shape=(1, EP), fsdp: bool = False,
                  tp: bool = False) -> np.ndarray:
    """A whole mu, nu or master leaf of the reference cut to what rank
    ``rank`` holds: its lane, then its data rank's ZeRO-1 slice on the
    port's ZeRO dim (``adamw.zero_dim``), or with ``fsdp`` an expert
    leaf's f-slice (its state is the slice's own)."""
    if fsdp and sharding.fsdp_sharded(path):
        return lane_of(want, path, rank, shape, fsdp)
    t = lane_of(want, path, rank, shape, tp=tp)
    data = shape[0]
    dim = adamw.zero_dim(t.shape, data, lm.lane_sharded(path),
                         split_dim(path, want.shape, shape[1], tp))
    if dim is None:
        return t
    n, d = t.shape[dim] // data, rank // shape[1]
    return np.take(t, np.arange(d * n, (d + 1) * n), axis=dim)


def split_dim(path: str, shape, model: int, tp: bool = False) -> int | None:
    """The dim, from the end, of the leaf at ``path`` (whole ``shape``)
    split over a model group of ``model`` in training: the vocab pair's
    (``sharding.vocab_dim``), with ``tp`` a TP leaf's."""
    if tp and model > 1 and sharding.tp_sharded(path):
        return sharding.tp_dim(path)
    return sharding.vocab_dim(path, shape, model)


def batch(vocab: int, seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1                      # no label: out of the denominator
    labels[1, -2] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


def reduced(arch: str):
    """The reduced config of ``arch``, "name" or "name@V" (its vocab V)."""
    name, _, vocab = arch.partition("@")
    cfg = get_arch(name).reduced()
    return dataclasses.replace(cfg, vocab=int(vocab)) if vocab else cfg


def params(arch: str, seed: int = 0, ep: int = EP, node: int = NODE) -> dict:
    """Seeded numpy parameters in the reference's tree, expert leaves over
    ``ep`` lanes: norms near 1, weights scaled by their fan-in, the
    embedding unit normal (the port's ``init_params`` gives the keys and
    shapes); ``arch`` as :func:`reduced` takes it."""
    cfg = reduced(arch)
    ctx = lm.make_context(cfg, "cpu")
    if ctx.placement is not None:      # the dense family has no experts
        ctx = dataclasses.replace(ctx, placement=dataclasses.replace(
            ctx.placement, ep=ep, node_size=node))
    shapes = flat(lm.init_params(cfg, ctx, torch.Generator().manual_seed(0),
                                 dtype=torch.float32))
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in shapes.items():
        shape = tuple(v.shape)
        if k.endswith(("norm", "ln1", "ln2")):
            a = 1 + 0.1 * rng.standard_normal(shape)
        elif k == "embed":
            a = rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape) * shape[-2] ** -0.5
        out[k] = a.astype(np.float32)
    return out


JAX_CODE = """
import dataclasses, numpy as np, jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.configs import get_arch
from repro.core import traffic
from repro.launch.steps import make_train_step
from repro.models import lm, zoo
from repro.optim import adamw


def flat(tree, prefix=""):
    out = {{}}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def nest(items):
    tree = {{}}
    for k, v in items:
        node = tree
        *path, leaf = k.split("/")
        for part in path:
            node = node.setdefault(part, {{}})
        node[leaf] = v
    return tree


mesh = make_mesh({shape!r}, ("data", "model"))
out = {{}}
for arch, data, engine, stream, slices in {runs!r}:
    d = np.load(data)
    params = jax.tree.map(jnp.asarray, nest(
        (k[2:], d[k]) for k in d.files if k.startswith("p/")))
    batch = {{k: jnp.asarray(d[k]) for k in ("tokens", "labels")}}
    name, _, vocab = arch.partition("@")
    cfg = get_arch(name).reduced()
    if vocab:
        cfg = dataclasses.replace(cfg, vocab=int(vocab))
    mixed = tuple(engine.split(",")) if "," in engine else None
    ctx = dataclasses.replace(
        lm.make_context(cfg, mesh, multi_pod=False,
                        engine="fused_hier" if mixed else engine,
                        node_size={node}, moe_stream=stream,
                        pipe_slices=slices),
        compute_dtype=jnp.float32, remat=False, engines=mixed,
        fsdp_experts={fsdp!r})
    tr = None if cfg.moe is None else traffic.init_traffic_state(
        cfg.moe.n_experts, {shape[1]}, n_layers=cfg.n_layers)
    vg = jax.value_and_grad(lambda p, b, t: lm.lm_loss(p, b, ctx, traffic=t),
                            has_aux=True)
    step = make_train_step(zoo.build(cfg, ctx), adamw.AdamWConfig(**{opt!r}))

    def both(p, b, t):
        new, opt, sm = step(p, adamw.init(p), b, t)
        # the second step's params, over a data group only
        two = (step(new, opt, b, sm.get("traffic"))[:2] if {two!r}
               else ({{}}, None))
        return vg(p, b, t), (new, opt, sm), two

    with mesh:
        ((loss, m), grads), (new, opt, sm), (new2, opt2) = jax.jit(
            both).lower(params, batch, tr).compile({fast!r})(params, batch, tr)
    c = engine + "/" + str(slices)
    for k, v in flat(new2).items():
        out[c + "/p2/" + k] = np.asarray(v)
    if opt2 is not None:      # the second step's moments: its update's room
        for kind, tree in (("mu2", opt2.mu), ("nu2", opt2.nu)):
            for k, v in flat(tree).items():
                out[c + "/" + kind + "/" + k] = np.asarray(v)
    out[c + "/loss"] = np.asarray(loss)
    out[c + "/grad_norm"] = np.asarray(sm["grad_norm"])
    out[c + "/step_loss"] = np.asarray(sm["loss"])
    for kind, tree in (("g", grads), ("p", new), ("mu", opt.mu),
                       ("nu", opt.nu), ("master", opt.master)):
        for k, v in flat(tree).items():
            out[c + "/" + kind + "/" + k] = np.asarray(v)
    for kind, st in (("t", m.get("traffic")), ("st", sm.get("traffic"))):
        for f in traffic.TrafficState._fields if st is not None else ():
            out[c + "/" + kind + "/" + f] = np.asarray(getattr(st, f))
np.savez({out!r}, **out)
print("JAX_OK")
"""


def _save_state(out: dict, key: str, st) -> None:
    for f in traffic.TrafficState._fields if st is not None else ():
        out[f"{key}/{f}"] = getattr(st, f).numpy().copy()


def _no_sync(grads, paths, group, *_):
    return list(grads)


def _grid_norm(grid):
    """``adamw.global_norm`` with its group swapped for the whole grid: the
    clip norm summed over the data ranks too."""
    norm = adamw.global_norm
    return lambda tree, group=None, sharded=None, whole=None: norm(
        tree, grid, sharded, whole)


# the mutations of the data sync a grid run makes on each rank: (name, module,
# attribute, the replacement given the mesh)
MUTATIONS = (
    ("permean", steps, "data_total", lambda mesh: lambda t, group: t),
    ("nolanes", steps, "reduce_lanes", lambda mesh: _no_sync),
    ("gridnorm", adamw, "global_norm", lambda mesh: _grid_norm(mesh.grid)),
)


def _save_tree(out: dict, key: str, tree) -> None:
    for k, v in flat(tree).items():
        out[f"{key}/{k}"] = v.detach().numpy().copy()


def engines_of(engine: str) -> tuple:
    """(the context's engine, its per-layer ``engines``) of a case's engine
    name: a comma-separated list is one engine a layer, on a fused_hier
    context (as ``--engine auto`` builds it)."""
    if "," in engine:
        return "fused_hier", tuple(engine.split(","))
    return engine, None


def case_tp(tp, case: str) -> bool:
    """Whether ``case`` runs Megatron TP: ``tp`` a bool for every case, or
    the names of the cases that do."""
    return tp if isinstance(tp, bool) else case in tp


def _rank_main(rank, world, init_file, out_dir, runs, extra, shape, node,
               fsdp=False, tps=False):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(*shape)
        opt_cfg = adamw.AdamWConfig(**OPT)
        out = {}
        for arch, data, engine, stream, slices in runs:
            d = np.load(data)
            tree = nest((k[2:], d[k]) for k in d.files if k.startswith("p/"))
            rows = data_rows(B, mesh.data, mesh.data_index)
            bt = {k: torch.from_numpy(d[k][rows]).long()
                  for k in ("tokens", "labels")}
            cfg = reduced(arch)
            cold = lambda: None if cfg.moe is None else (
                traffic.init_traffic_state(cfg.moe.n_experts, mesh.model,
                                           n_layers=cfg.n_layers))
            c = f"{engine}/{slices}"
            tp = case_tp(tps, c)
            base, mixed = engines_of(engine)
            ctx = dataclasses.replace(lm.make_context(
                cfg, "cpu", mesh=mesh, engine=base, node_size=node,
                moe_stream=stream, pipe_slices=slices,
                compute_dtype=torch.float32, fsdp_experts=fsdp,
                explicit_tp=tp), engines=mixed)
            model = zoo.build(cfg, ctx)
            fresh = lambda: convert.params_from_jax(
                tree, "cpu", lane=rank % mesh.model,
                data=(mesh.data, mesh.data_index) if fsdp else None,
                model=(mesh.model, rank % mesh.model), tp=tp)
            p = fresh()
            loss, m, grads = steps.value_and_grad(model)(p, bt, cold())
            out[f"{c}/loss"] = loss.numpy()
            for k, g in zip(adamw.paths(p), grads):
                out[f"{c}/g/{k}"] = g.numpy().copy()
            _save_state(out, f"{c}/t", m.get("traffic"))
            # the replicated leaves' reduction switched off
            sync, steps.reduce_replicated = steps.reduce_replicated, _no_sync
            try:
                _, _, grads = steps.value_and_grad(model)(p, bt, cold())
            finally:
                steps.reduce_replicated = sync
            for k, g in zip(adamw.paths(p), grads):
                out[f"{c}/nosync/{k}"] = g.numpy().copy()
            step = steps.make_train_step(model, opt_cfg)
            p, opt, m = step(p, steps.init_state(model, p), bt, cold())
            out[f"{c}/grad_norm"] = m["grad_norm"].numpy()
            out[f"{c}/step_loss"] = m["loss"].numpy()
            for kind, t in (("p", p), ("mu", opt.mu), ("nu", opt.nu),
                            ("master", opt.master)):
                _save_tree(out, f"{c}/{kind}", t)
            _save_state(out, f"{c}/st", m.get("traffic"))
            p, opt, m = step(p, opt, bt, m.get("traffic"))
            _save_tree(out, f"{c}/p2", p)
            for name, mod, attr, swap in (MUTATIONS if mesh.data > 1
                                          and not fsdp and not tps else ()):
                saved = getattr(mod, attr)
                setattr(mod, attr, swap(mesh))
                try:
                    p = fresh()
                    loss, _, grads = steps.value_and_grad(model)(p, bt,
                                                                 cold())
                    p, _, m = step(p, steps.init_state(model, p), bt, cold())
                finally:
                    setattr(mod, attr, saved)
                out[f"{c}/{name}/loss"] = loss.numpy()
                out[f"{c}/{name}/grad_norm"] = m["grad_norm"].numpy()
                for k, g in zip(adamw.paths(p), grads):
                    out[f"{c}/{name}/g/{k}"] = g.numpy().copy()
                _save_tree(out, f"{c}/{name}/p", p)
        if extra is not None:
            out.update(extra(rank, world))
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def run_grid(tmp_path, archs, extra=None, shape=(1, EP), node=NODE,
             fsdp=False, tp=False, two=None):
    """Run the reference and the four ranks of a ``shape`` = (data, model)
    grid over ``archs`` ((arch, cases) pairs, an arch as :func:`reduced`
    takes it, each case (engine, moe_stream, pipe_slices), all named
    "engine/slices" apart; an engine "a,b,..." is one a layer,
    :func:`engines_of`), and on each
    rank ``extra``: ``(rank, world) -> {name: array}``, saved beside the
    rest; ``fsdp``: both sides under FSDP of the experts; ``tp``: the
    port's ranks under Megatron TP (the reference's default), for every
    case or for the cases it names (:func:`case_tp`); ``two``: the
    reference's second step too (by default over a data group only).
    Returns (the reference's arrays, each rank's arrays, each arch's
    parameters)."""
    world = shape[0] * shape[1]
    runs, ps = [], {}
    for arch, cases in archs:
        cfg = reduced(arch)
        data = str(tmp_path / f"data-{arch}.npz")
        ps[arch] = params(arch, ep=shape[1], node=node)
        np.savez(data, **batch(cfg.vocab),
                 **{"p/" + k: v for k, v in ps[arch].items()})
        runs += [(arch, data, *case) for case in cases]
    names = [f"{e}/{s}" for _, _, e, _, s in runs]
    assert len(set(names)) == len(names), names
    code = PRELUDE + JAX_CODE.format(
        shape=tuple(shape), node=node, runs=tuple(runs),
        two=shape[0] > 1 if two is None else two, fsdp=fsdp, opt=OPT,
        fast=FAST, out=str(tmp_path / "jax.npz"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(run_devices, code, world, 600)
        mp.spawn(_rank_main, args=(world, str(tmp_path / "rendezvous"),
                                   str(tmp_path), tuple(runs), extra,
                                   tuple(shape), node, fsdp, tp),
                 nprocs=world, join=True)
        assert "JAX_OK" in jax_run.result()
    want = dict(np.load(tmp_path / "jax.npz"))
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]
    return want, ranks, ps


def run(tmp_path, arch: str, cases, extra=None):
    """:func:`run_grid` of one arch over an EP group of four, (1, 4).
    Returns (the reference's arrays, each rank's arrays, the parameters)."""
    want, ranks, ps = run_grid(tmp_path, ((arch, cases),), extra)
    return want, ranks, ps[arch]


def state_of(arrays: dict, key: str) -> dict:
    return {f: arrays[f"{key}/{f}"] for f in traffic.TrafficState._fields}


# --------------------------------------------------- the rank-by-rank checks

def check_grads(want, got, case, rank, shape=(1, EP), fsdp=False, tp=False):
    """Loss, every gradient leaf (the replicated leaves' the reference's
    whole gradient, the expert leaves' the rank's lane of it, with
    ``fsdp`` its f-slice) and the traffic state of one rank of a ``shape``
    grid."""
    what = f"{case} rank {rank}"
    close(got[f"{case}/loss"], want[f"{case}/loss"], f"{what} loss")
    grads = {k[len(case) + 3:]: v for k, v in got.items()
             if k.startswith(f"{case}/g/")}
    ref = {k[len(case) + 3:]: v for k, v in want.items()
           if k.startswith(f"{case}/g/")}
    assert grads.keys() == ref.keys(), what
    for k, g in grads.items():
        w = lane_of(ref[k], k, rank, shape, fsdp, tp)
        assert g.shape == w.shape, (what, k)
        assert float(np.abs(w).max()) > 0, (what, k)
        close(g, w, f"{what} grad {k}")
    if f"{case}/t/steps" in want:            # no traffic without experts
        check_state(state_of(got, f"{case}/t"), state_of(want, f"{case}/t"),
                    what)


def check_step(want, got, case, rank, shape=(1, EP), fsdp=False, tp=False):
    """The grad norm (clipping binding), the step's loss, the updated
    params, the rank's ZeRO-1 slices of mu, nu and master
    (:func:`state_of_rank`; with ``fsdp`` the expert leaves' f-slices)
    and the traffic state of one rank of a ``shape`` grid."""
    what = f"{case} rank {rank}"
    assert float(want[f"{case}/grad_norm"]) > OPT["clip_norm"], what
    close(got[f"{case}/grad_norm"], want[f"{case}/grad_norm"], f"{what} norm")
    close(got[f"{case}/step_loss"], want[f"{case}/step_loss"], f"{what} loss")
    for kind in ("p", "mu", "nu", "master"):
        pre = f"{case}/{kind}/"
        keys = [k for k in want if k.startswith(pre)]
        assert sorted(keys) == sorted(k for k in got if k.startswith(pre))
        for k in keys:
            path = k[len(pre):]
            cut = lane_of if kind == "p" else state_of_rank
            w = cut(want[k], path, rank, shape, fsdp, tp)
            assert got[k].shape == w.shape, (what, kind, path)
            if kind in ("mu", "nu"):
                close(got[k], w, f"{what} {kind} {path}")
            else:
                close_updated(got[k], w, cut(update_room(want, case, path),
                                             path, rank, shape, fsdp, tp),
                              f"{what} {kind} {path}")


def update_room(want: dict, case: str, path: str, steps: int = 1):
    """The whole leaf's room for its first ``steps`` AdamW steps
    (``torch_adam``) from the reference's moments after each."""
    cfg = adamw.AdamWConfig(**OPT)
    return sum(step_slack(want[f"{case}/{mu}/{path}"],
                          want[f"{case}/{nu}/{path}"], i,
                          adamw.schedule(cfg, i), cfg)
               for i, (mu, nu) in enumerate((("mu", "nu"), ("mu2", "nu2")
                                             )[:steps], 1))
    check_state(state_of(got, f"{case}/st"), state_of(want, f"{case}/st"),
                what)


def unsynced_misses(want, got, case, rank) -> list[str]:
    """The replicated leaves whose gradient without the reduction is not
    the reference's (each rank holds a share of it).  The vocab pair is
    not one: each rank's shard of it gets its whole gradient unsynced."""
    pre = f"{case}/nosync/"
    missed = []
    for k in (k for k in got if k.startswith(pre)):
        path = k[len(pre):]
        if lm.lane_sharded(path):
            continue
        if path in sharding.VOCAB_DIM:
            close(got[k], lane_of(want[f"{case}/g/{path}"], path, rank))
            continue
        try:
            close(got[k], want[f"{case}/g/{path}"])
        except AssertionError:
            missed.append(path)
    return missed


def mutation_misses(want, got, case, rank, name, shape) -> list[str]:
    """What a run under the mutation ``name`` (:data:`MUTATIONS`) gets
    wrong on one rank: "loss", "grad <path>", "grad_norm", "p <path>"
    where it is not the reference's."""
    missed = []

    def miss(what, a, b):
        try:
            close(a, b)
        except AssertionError:
            missed.append(what)

    pre = f"{case}/{name}/"
    miss("loss", got[pre + "loss"], want[f"{case}/loss"])
    miss("grad_norm", got[pre + "grad_norm"], want[f"{case}/grad_norm"])
    for kind, ref in (("g", "g"), ("p", "p")):
        for k in (k for k in got if k.startswith(f"{pre}{kind}/")):
            path = k[len(pre) + 2:]
            miss(f"{kind} {path}", got[k],
                 lane_of(want[f"{case}/{ref}/{path}"], path, rank, shape))
    return missed


def replicated_bits_differ(ranks, case, tp=False) -> list[str]:
    """The replicated leaves whose bits after two steps are not rank 0's on
    every rank (the vocab pair's shards are not replicated, nor with
    ``tp`` the TP shards)."""
    pre = f"{case}/p2/"
    return [k for k in ranks[0] if k.startswith(pre)
            and not lm.lane_sharded(k[len(pre):])
            and k[len(pre):] not in sharding.VOCAB_DIM
            and not (tp and sharding.tp_sharded(k[len(pre):]))
            and not all(np.array_equal(r[k], ranks[0][k]) for r in ranks)]


# ------------------------------------------------ the per-rank state, reckoned

def state_gib_per_rank(arch: str = "qwen3-moe-30b-a3b",
                       eps=(1, 2, 4, 8, 16, 32), cfg=None,
                       dps=(1, 2, 4), tp: bool = False) -> dict:
    """Per-rank training state of ``arch`` (or ``cfg``) over an EP group of
    each size in ``eps`` and a data group of each size in ``dps``, reckoned
    from the parameter counts (``lm.param_counts``), not measured: bf16
    params and grads (4 bytes a parameter) of the replicated leaves on
    every rank and of 1/EP of the expert leaves, f32 master, mu and nu (12
    bytes) of the same divided by DP (ZeRO-1), plus the replicated
    gradients' all-reduce bucket (2 bytes a replicated parameter) while it
    is alive.  Activations are not counted.  ``gib_per_rank`` is DP 1 by
    EP, ``gib_per_rank_dp`` every (EP, DP); ``gib_per_rank_fsdp`` the same
    under FSDP of the experts, whose bf16 params and grads are divided by
    DP too.  The model group (the EP group) splits ``embed`` and
    ``lm_head`` by the training rule (``lm.vocab_param_count``: on the
    vocab, or on d where EP does not divide the vocab, or not at all):
    each rank holds 1/EP of them, and they leave the all-reduce bucket.
    With ``tp`` it also splits the TP leaves (``lm.tp_param_count``: wq,
    wo, the dense MLP), Megatron TP's layout, the same way, where EP
    divides the heads (``lm.ModelContext.tp_eligible``'s rule; else the
    replicated attention).  The ssm and hybrid families split their Mamba2
    leaves by SSM head where EP divides the heads (``lm.ssm_param_count``:
    each rank its heads' columns and the B and C columns whole); those
    leave the replicated bucket, and their B and C columns are summed over
    the model group in a bucket of their own.

        PYTHONPATH=src python tests/torch_ep_train.py

    prints it for the full qwen3-moe-30b-a3b, replicated and under TP."""
    cfg = cfg or get_arch(arch)
    replicated, experts = lm.param_counts(cfg)
    split = lm.tp_param_count(cfg) if tp else 0

    def gib(ep, dp, fsdp=False):
        # one model rank: no TP, no vocab split
        tp_on = ep > 1 and cfg.n_heads % ep == 0
        cut = (split if tp_on else 0) + lm.vocab_param_count(cfg, ep)
        ssm, ssm_held = lm.ssm_param_count(cfg), lm.ssm_param_count(cfg, ep)
        whole = replicated - cut + cut / ep - ssm + ssm_held
        held = whole + experts / ep
        bf16 = whole + experts / ep / (dp if fsdp else 1)
        bucket = replicated - cut
        if ssm_held < ssm:       # split by head: the B and C columns alone
            gn = lm.ssm_dims(cfg).groups
            bucket += cfg.n_layers * (cfg.d_model + cfg.ssm.conv_kernel) * gn
            bucket -= ssm
        return (4 * bf16 + 12 / dp * held + 2 * bucket) / 2**30

    return {"replicated_params": replicated, "expert_params": experts,
            "tp_params": split, "vocab_params": 2 * cfg.vocab * cfg.d_model,
            "ssm_params": lm.ssm_param_count(cfg),
            "gib_per_rank": {ep: gib(ep, 1) for ep in eps},
            "gib_per_rank_dp": {(ep, dp): gib(ep, dp) for ep in eps
                                for dp in dps},
            "gib_per_rank_fsdp": {(ep, dp): gib(ep, dp, True) for ep in eps
                                  for dp in dps}}


# --------------------------------- Megatron TP against the replicated layout

def _counting(mod, name: str, log: list, record=None):
    """Swap ``mod.name`` for a wrapper that appends ``name`` (or
    ``record(*args)``) to ``log``; returns the undo."""
    fn = getattr(mod, name)

    def wrapped(*a, **k):
        log.append(name if record is None else record(*a, **k))
        return fn(*a, **k)

    setattr(mod, name, wrapped)
    return lambda: setattr(mod, name, fn)


def tp_probe(shape, node, archs, rank, world) -> dict:
    """On each rank of a ``shape`` grid, for each (arch, cases) of
    ``archs``: the loss, the grad norm of one step and every gradient
    under ``explicit_tp`` True and False from the same parameters and
    batch (``tpoff/err``: the largest difference of a leaf relative to
    max(1, |x|), the TP shard against its cut of the replicated layout's
    gradient), and what one forward of the loss launches under each:
    ``dcomm.all_gather_seq`` / ``reduce_scatter_seq`` calls from the TP
    blocks, ``lm.all_gather_seq`` calls (the MoE output's gather), the
    ``torch.distributed`` collectives (``dcomm.collective_calls``), the
    shapes of h entering each TP layer, and q's and k's heads at the flash
    call.  Used as ``run_grid``'s ``extra`` (``functools.partial``)."""
    mesh = make_host_mesh(*shape)
    lane = rank % mesh.model
    out = {}
    for arch, cases in archs:
        cfg = reduced(arch)
        tree = nest(params(arch, ep=mesh.model, node=node).items())
        rows = data_rows(B, mesh.data, mesh.data_index)
        bt = {k: torch.from_numpy(v[rows]).long()
              for k, v in batch(cfg.vocab).items()}
        cold = lambda: None if cfg.moe is None else (
            traffic.init_traffic_state(cfg.moe.n_experts, mesh.model,
                                       n_layers=cfg.n_layers))
        for engine, stream, slices in cases:
            c = f"{engine}/{slices}/tp"
            res = {}
            for tp in (True, False):
                ctx = lm.make_context(
                    cfg, "cpu", mesh=mesh, engine=engine, node_size=node,
                    moe_stream=stream, pipe_slices=slices,
                    compute_dtype=torch.float32, explicit_tp=tp)
                assert lm.tensor_parallel(ctx) == tp
                model = zoo.build(cfg, ctx)
                p = convert.params_from_jax(
                    tree, "cpu", lane=lane, model=(mesh.model, lane), tp=tp)
                loss, _, grads = steps.value_and_grad(model)(p, bt, cold())
                step = steps.make_train_step(model, adamw.AdamWConfig(**OPT))
                _, _, m = step(p, steps.init_state(model, p), bt, cold())
                log, heads, undo = [], [], []
                undo.append(_counting(dcomm, "all_gather_seq", log))
                undo.append(_counting(dcomm, "reduce_scatter_seq", log))
                undo.append(_counting(lm, "all_gather_seq", log,
                                      lambda *a, **k: "moe_gather"))
                undo.append(_counting(
                    tp_blocks, "causal_attention", heads,
                    lambda q, k, *a, **kw: (q.shape[2], k.shape[2])))
                undo.append(_counting(
                    lm, "_tp_layer", heads,
                    lambda hh, *a, **kw: tuple(hh.shape)))
                try:
                    with dcomm.collective_calls() as calls:
                        p = convert.params_from_jax(
                            tree, "cpu", lane=lane, model=(mesh.model, lane),
                            tp=tp)
                        model.loss(p, bt, traffic=cold())
                finally:
                    for u in undo:
                        u()
                key = "on" if tp else "off"
                out[f"{c}/{key}/loss"] = loss.numpy()
                out[f"{c}/{key}/grad_norm"] = m["grad_norm"].numpy()
                out[f"{c}/{key}/log"] = np.array(log, dtype=str)
                out[f"{c}/{key}/calls"] = np.array(calls, dtype=str)
                out[f"{c}/{key}/h"] = np.array(
                    [x for x in heads if len(x) == 3], dtype=np.int64
                ).reshape(-1, 3)
                out[f"{c}/{key}/heads"] = np.array(
                    [x for x in heads if len(x) == 2], dtype=np.int64
                ).reshape(-1, 2)
                res[tp] = dict(zip(adamw.paths(p), grads))
            err = 0.0
            for path, g in res[True].items():
                # both layouts hold the vocab pair's shards already
                w = res[False][path]
                if sharding.tp_sharded(path):
                    w = sharding.data_cut(w, sharding.tp_dim(path),
                                          mesh.model, lane)
                err = max(err, float((g - w).abs().max())
                          / max(1.0, float(w.abs().max())))
            out[f"{c}/err"] = np.array(err)
    return out


if __name__ == "__main__":
    for arch, eps in (("qwen3-moe-30b-a3b", (1, 2, 4, 8, 16, 32, 64)),
                      ("mixtral-8x22b", (1, 2, 4, 8)),
                      ("deepseek-v3-bench", (1, 8, 16, 32, 64)),
                      ("mamba2-2.7b", (1, 2, 4, 8, 16)),
                      ("hymba-1.5b", (1, 2, 4))):
        moe = get_arch(arch).moe is not None
        for tp in (False, True) if moe else (False,):
            mem = state_gib_per_rank(arch, eps=eps, tp=tp)
            print(f"reckoned (not measured) per-rank training state of the "
                  f"full {arch} ({mem['replicated_params']} replicated, "
                  f"{mem['tp_params']} of them split by TP, "
                  f"{mem['ssm_params']} in the Mamba2 leaves, split by SSM "
                  f"head, and {mem['vocab_params']} in embed and lm_head, "
                  f"split over the EP group, and "
                  f"{mem['expert_params']} expert parameters), "
                  f"{'Megatron TP over the EP group' if tp else 'replicated attention'}, "
                  f"GiB, by EP (rows) and DP (columns), ZeRO-1 -> with FSDP "
                  f"of the experts:")
            table, fsdp = mem["gib_per_rank_dp"], mem["gib_per_rank_fsdp"]
            dps = sorted({dp for _, dp in table})
            print("EP \\ DP " + "".join(f"{dp:>18}" for dp in dps))
            for ep in sorted({ep for ep, _ in table}):
                print(f"{ep:>7} " + "".join(
                    f"{table[ep, dp]:>9.2f} ->{fsdp[ep, dp]:>7.2f}"
                    for dp in dps))
