"""Harness of the EP-group training tests (``test_torch_train_ep.py``: the
moe family, ``test_torch_train_ep_tx.py``: moe_tx): one train step of the
port over four gloo ranks against the reference's under ``shard_map``.

:func:`run` saves seeded numpy parameters (the reference's tree, expert
leaves lane-major over EP = 4) and a batch (labels with a few -1), then at
once runs the reference in one subprocess on four forced host devices
(``jax.value_and_grad(lm.lm_loss)`` and the jitted ``make_train_step`` of
each case on a (1, 4) mesh, traffic threaded) and the port's four ranks
(``convert.params_from_jax(..., lane=r)``; ``steps.value_and_grad`` and
``steps.make_train_step``).  Each rank also runs its gradients once more
with the replicated leaves' reduction switched off, and a second step.
Everything lands in npz files that the tests compare rank by rank.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from conftest import run_devices
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core import traffic
from repro_torch.launch import steps
from repro_torch.models import lm, zoo
from repro_torch.optim import adamw

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


def lane_of(want: np.ndarray, path: str, rank: int) -> np.ndarray:
    """A whole leaf of the reference cut to what rank ``rank`` holds."""
    return lm.lane_cut(path, want, EP, range(rank, rank + 1))


def batch(vocab: int, seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1                      # no label: out of the denominator
    labels[1, -2] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


def params(arch: str, seed: int = 0) -> dict:
    """Seeded numpy parameters in the reference's tree, expert leaves over
    EP lanes: norms near 1, weights scaled by their fan-in, the embedding
    unit normal (the port's ``init_params`` gives the keys and shapes)."""
    cfg = get_arch(arch).reduced()
    ctx = lm.make_context(cfg, "cpu")
    ctx = dataclasses.replace(ctx, placement=dataclasses.replace(
        ctx.placement, ep=EP, node_size=NODE))
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


mesh = make_mesh((1, {ep}), ("data", "model"))
d = np.load({data!r})
params = jax.tree.map(jnp.asarray, nest(
    (k[2:], d[k]) for k in d.files if k.startswith("p/")))
batch = {{k: jnp.asarray(d[k]) for k in ("tokens", "labels")}}
cfg = get_arch({arch!r}).reduced()
out = {{}}
for engine, stream, slices in {cases!r}:
    ctx = dataclasses.replace(
        lm.make_context(cfg, mesh, multi_pod=False, engine=engine,
                        node_size={node}, moe_stream=stream,
                        pipe_slices=slices),
        compute_dtype=jnp.float32, remat=False)
    tr = traffic.init_traffic_state(cfg.moe.n_experts, {ep},
                                    n_layers=cfg.n_layers)
    vg = jax.value_and_grad(lambda p, b, t: lm.lm_loss(p, b, ctx, traffic=t),
                            has_aux=True)
    step = make_train_step(zoo.build(cfg, ctx), adamw.AdamWConfig(**{opt!r}))
    both = lambda p, b, t: (vg(p, b, t), step(p, adamw.init(p), b, t))
    with mesh:
        ((loss, m), grads), (new, opt, sm) = jax.jit(both).lower(
            params, batch, tr).compile({fast!r})(params, batch, tr)
    c = engine + "/" + str(slices)
    out[c + "/loss"] = np.asarray(loss)
    out[c + "/grad_norm"] = np.asarray(sm["grad_norm"])
    out[c + "/step_loss"] = np.asarray(sm["loss"])
    for kind, tree in (("g", grads), ("p", new), ("mu", opt.mu),
                       ("nu", opt.nu), ("master", opt.master)):
        for k, v in flat(tree).items():
            out[c + "/" + kind + "/" + k] = np.asarray(v)
    for kind, st in (("t", m["traffic"]), ("st", sm["traffic"])):
        for f in traffic.TrafficState._fields:
            out[c + "/" + kind + "/" + f] = np.asarray(getattr(st, f))
np.savez({out!r}, **out)
print("JAX_OK")
"""


def _save_state(out: dict, key: str, st) -> None:
    for f in traffic.TrafficState._fields:
        out[f"{key}/{f}"] = getattr(st, f).numpy().copy()


def _no_sync(grads, paths, group):
    return list(grads)


def _rank_main(rank, world, init_file, data, out_dir, arch, cases, extra):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        d = np.load(data)
        tree = nest((k[2:], d[k]) for k in d.files if k.startswith("p/"))
        bt = {k: torch.from_numpy(d[k]).long() for k in ("tokens", "labels")}
        cfg = get_arch(arch).reduced()
        cold = lambda: traffic.init_traffic_state(
            cfg.moe.n_experts, world, n_layers=cfg.n_layers)
        opt_cfg = adamw.AdamWConfig(**OPT)
        out = {}
        for engine, stream, slices in cases:
            c = f"{engine}/{slices}"
            ctx = lm.make_context(cfg, "cpu", ep_group=dist.group.WORLD,
                                  engine=engine, node_size=NODE,
                                  moe_stream=stream, pipe_slices=slices,
                                  compute_dtype=torch.float32)
            model = zoo.build(cfg, ctx)
            p = convert.params_from_jax(tree, "cpu", lane=rank)
            loss, m, grads = steps.value_and_grad(model)(p, bt, cold())
            out[f"{c}/loss"] = loss.numpy()
            for k, g in zip(adamw.paths(p), grads):
                out[f"{c}/g/{k}"] = g.numpy().copy()
            _save_state(out, f"{c}/t", m["traffic"])
            # the replicated leaves' reduction switched off
            sync, steps.reduce_replicated = steps.reduce_replicated, _no_sync
            try:
                _, _, grads = steps.value_and_grad(model)(p, bt, cold())
            finally:
                steps.reduce_replicated = sync
            for k, g in zip(adamw.paths(p), grads):
                out[f"{c}/nosync/{k}"] = g.numpy().copy()
            step = steps.make_train_step(model, opt_cfg)
            p, opt, m = step(p, adamw.init(p), bt, cold())
            out[f"{c}/grad_norm"] = m["grad_norm"].numpy()
            out[f"{c}/step_loss"] = m["loss"].numpy()
            for kind, t in (("p", p), ("mu", opt.mu), ("nu", opt.nu),
                            ("master", opt.master)):
                for k, v in flat(t).items():
                    out[f"{c}/{kind}/{k}"] = v.detach().numpy().copy()
            _save_state(out, f"{c}/st", m["traffic"])
            p, opt, m = step(p, opt, bt, m["traffic"])
            for k, v in flat(p).items():
                out[f"{c}/p2/{k}"] = v.detach().numpy().copy()
        if extra is not None:
            out.update(extra(rank, world))
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def run(tmp_path, arch: str, cases, extra=None):
    """Run the reference and the four ranks (and, on each rank, ``extra``:
    ``(rank, world) -> {name: array}``, saved beside the rest).  Returns
    (the reference's arrays, each rank's arrays, the parameters)."""
    cfg = get_arch(arch).reduced()
    data = str(tmp_path / "data.npz")
    p = params(arch)
    np.savez(data, **batch(cfg.vocab), **{"p/" + k: v for k, v in p.items()})
    code = JAX_CODE.format(ep=EP, node=NODE, arch=arch, cases=tuple(cases),
                           data=data, opt=OPT, fast=FAST,
                           out=str(tmp_path / "jax.npz"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(run_devices, code, EP, 600)
        mp.spawn(_rank_main, args=(EP, str(tmp_path / "rendezvous"), data,
                                   str(tmp_path), arch, tuple(cases), extra),
                 nprocs=EP, join=True)
        assert "JAX_OK" in jax_run.result()
    want = dict(np.load(tmp_path / "jax.npz"))
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(EP)]
    return want, ranks, p


def state_of(arrays: dict, key: str) -> dict:
    return {f: arrays[f"{key}/{f}"] for f in traffic.TrafficState._fields}


# --------------------------------------------------- the rank-by-rank checks

def check_grads(want, got, case, rank):
    """Loss, every gradient leaf (the replicated leaves' the reference's
    whole gradient, the expert leaves' lane ``rank`` of it) and the
    traffic state of one rank."""
    what = f"{case} rank {rank}"
    close(got[f"{case}/loss"], want[f"{case}/loss"], f"{what} loss")
    grads = {k[len(case) + 3:]: v for k, v in got.items()
             if k.startswith(f"{case}/g/")}
    ref = {k[len(case) + 3:]: v for k, v in want.items()
           if k.startswith(f"{case}/g/")}
    assert grads.keys() == ref.keys(), what
    for k, g in grads.items():
        w = lane_of(ref[k], k, rank)
        assert g.shape == w.shape, (what, k)
        assert float(np.abs(w).max()) > 0, (what, k)
        close(g, w, f"{what} grad {k}")
    check_state(state_of(got, f"{case}/t"), state_of(want, f"{case}/t"), what)


def check_step(want, got, case, rank):
    """The grad norm (clipping binding), the step's loss, the updated
    params, mu, nu and master and the traffic state of one rank."""
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
            close(got[k], lane_of(want[k], path, rank),
                  f"{what} {kind} {path}")
    check_state(state_of(got, f"{case}/st"), state_of(want, f"{case}/st"),
                what)


def unsynced_misses(want, got, case, rank) -> list[str]:
    """The replicated leaves whose gradient without the reduction is not
    the reference's (each rank holds a share of it)."""
    pre = f"{case}/nosync/"
    missed = []
    for k in (k for k in got if k.startswith(pre)):
        path = k[len(pre):]
        if lm.lane_sharded(path):
            continue
        try:
            close(got[k], want[f"{case}/g/{path}"])
        except AssertionError:
            missed.append(path)
    return missed


def replicated_bits_differ(ranks, case) -> list[str]:
    """The replicated leaves whose bits after two steps are not rank 0's on
    every rank."""
    pre = f"{case}/p2/"
    return [k for k in ranks[0] if k.startswith(pre)
            and not lm.lane_sharded(k[len(pre):])
            and not all(np.array_equal(r[k], ranks[0][k]) for r in ranks)]


# ------------------------------------------------ the per-rank state, reckoned

def state_gib_per_rank(arch: str = "qwen3-moe-30b-a3b",
                       eps=(1, 2, 4, 8, 16, 32), cfg=None) -> dict:
    """Per-rank training state of ``arch`` (or ``cfg``) over an EP group of
    each size in ``eps``, reckoned from the parameter counts, not measured:
    bf16 params and grads, f32 master, mu and nu (16 bytes a parameter) of
    the replicated leaves on every rank and of 1/EP of the expert leaves,
    plus the replicated gradients' all-reduce bucket (2 bytes a replicated
    parameter) while it is alive.  Activations are not counted.

        PYTHONPATH=src python tests/torch_ep_train.py

    prints it for the full qwen3-moe-30b-a3b."""
    cfg = cfg or get_arch(arch)
    d, hd, L = cfg.d_model, cfg.hd, cfg.n_layers
    attn = d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads) + (
        2 * hd if cfg.qk_norm else 0)
    layer = 2 * d + attn + d * cfg.moe.n_experts
    replicated = L * layer + 2 * cfg.vocab * d + d
    experts = L * 3 * cfg.moe.n_experts * d * cfg.moe.d_ff_expert
    return {"replicated_params": replicated, "expert_params": experts,
            "gib_per_rank": {ep: (16 * (replicated + experts / ep)
                                  + 2 * replicated) / 2**30 for ep in eps}}


if __name__ == "__main__":
    import json
    mem = state_gib_per_rank()
    print(f"reckoned (not measured) per-rank training state of the full "
          f"qwen3-moe-30b-a3b (48 layers; {mem['replicated_params']} "
          f"replicated and {mem['expert_params']} expert parameters) by EP "
          f"size, GiB: {json.dumps(mem['gib_per_rank'])}")
