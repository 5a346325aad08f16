"""The port's ``moe_tx`` training path and the traffic state threaded through
the loss, the train step and the train loop, against the JAX package.

Reduced ``moe-tx-stream`` in float32 at EP = 1: ``lm_loss`` with a cold
traffic state, every gradient leaf and the new state against
``jax.value_and_grad(jlm.lm_loss)`` through the per-layer barriers
(``fused_flat``, ``fused_hier``) and the streamed schedule (``fused_pipe``
in one block of both layers at 1 and 2 slices: the tail's cotangent of
layer 0 lands through layer 1's prologue); one ``make_train_step`` step
against JAX's (params, mu, nu, master and the state); the moe family's
state through ``lm_loss``; at EP = 4 over four gloo ranks the forward loss
and state of both families rank by rank against ``shard_map`` on four
forced host devices; ``train.run`` against a hand loop of the train step;
serial accumulation without a state.

The same parameters (JAX's ``init_params``, converted leaf by leaf) and the
same batch (labels with a few -1) on both sides.  Tolerance 1e-5 relative
to each leaf's max(1, |x|) (float32 sums in another order across two layers
and the vocabulary projection); integer counts exactly.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from conftest import run_devices
from xla_prelude import PRELUDE
from torch_adam import check_step
from repro.compat import make_mesh
from repro.configs import get_arch as jget_arch
from repro.core import traffic as jtraffic
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import lm as jlm
from repro.models import zoo as jzoo
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core import traffic
from repro_torch.data import pipeline
from repro_torch.launch import steps, train
from repro_torch.models import lm, zoo
from repro_torch.optim import adamw

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

TX, MOE = "moe-tx-stream", "qwen3-moe-30b-a3b"
TOL = 1e-5
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
COUNTS = ("last_expert_count", "steps")
# the JAX oracles compiled without LLVM's optimisation passes: the same HLO
# (values agree to ~1e-7), a third less compile time
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}
# (engine, moe_stream, pipe_slices): the barrier engines, and the streamed
# schedule over one block of both layers at 1 and 2 slices
ENGINES = [("fused_flat", 0, 0), ("fused_hier", 0, 0), ("fused_pipe", 2, 1),
           ("fused_pipe", 2, 2)]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _close(got, want, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, dtype=np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=what)


def _check_state(got, want, what=""):
    """Every leaf of a port TrafficState against the reference's."""
    for name in traffic.TrafficState._fields:
        g = np.asarray(getattr(got, name))
        w = np.asarray(getattr(want, name))
        assert g.shape == w.shape, (what, name)
        if name in COUNTS:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")
        else:
            _close(g, w, f"{what} {name}")


def _batch(vocab, b=2, s=16, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1                      # no label: out of the denominator
    return {"tokens": toks[:, :-1], "labels": labels}


def _jax_ctx(arch, engine, moe_stream=0, pipe_slices=0):
    """The reference's context on a (1, 1) mesh in float32, without its
    rematerialisation (which changes what the backward keeps, not what it
    computes, and doubles the compile time)."""
    mesh = make_mesh((1, 1), ("data", "model"))
    cfg = jget_arch(arch).reduced()
    return cfg, mesh, dataclasses.replace(
        jlm.make_context(cfg, mesh, multi_pod=False, engine=engine,
                         moe_stream=moe_stream, pipe_slices=pipe_slices),
        compute_dtype=jnp.float32, remat=False)


def _params(arch, seed=0):
    """Seeded numpy parameters in the reference's tree (the port's
    ``init_params`` gives the keys and shapes): norms near 1, weights
    scaled by their fan-in, the embedding unit normal."""
    cfg = get_arch(arch).reduced()
    shapes = _flat(lm.init_params(
        cfg, lm.make_context(cfg, "cpu"), torch.Generator().manual_seed(0),
        dtype=torch.float32))
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in shapes.items():
        shape = tuple(v.shape)
        if k.endswith("norm") or k.endswith(("ln1", "ln2")):
            a = 1 + 0.1 * rng.standard_normal(shape)
        elif k == "embed":
            a = rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape) * shape[-2] ** -0.5
        out[k] = a.astype(np.float32)
    tree = {}
    for k, v in out.items():
        node = tree
        *path, leaf = k.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def _jax_loss(arch, engine, moe_stream=0, pipe_slices=0, step=False):
    """JAX: (loss, grads, new traffic) of the seeded parameters from a cold
    state and, with ``step``, one train step threading the same state;
    float32."""
    cfg, mesh, ctx = _jax_ctx(arch, engine, moe_stream, pipe_slices)
    params = jax.tree.map(jnp.asarray, _params(arch))
    batch = _batch(cfg.vocab)
    jb = jax.tree.map(jnp.asarray, batch)
    tr0 = jtraffic.init_traffic_state(cfg.moe.n_experts, 1,
                                      n_layers=cfg.n_layers)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    value_and_grad = jax.value_and_grad(
        lambda p, b, tr: jlm.lm_loss(p, b, ctx, traffic=tr), has_aux=True)
    train_step = jmake_train_step(jzoo.build(cfg, ctx),
                                  jadamw.AdamWConfig(**OPT))

    def both(p, b, tr):        # one program: one compile for the two
        return value_and_grad(p, b, tr), (train_step(p, jadamw.init(p), b, tr)
                                          if step else None)

    with mesh:
        ((loss, metrics), grads), stepped = jax.jit(both).lower(
            params, jb, tr0).compile(FAST)(params, jb, tr0)
    out = dict(params=to_np(params), batch=batch, loss=float(loss),
               grads=to_np(grads), traffic=to_np(metrics["traffic"]))
    if step:
        new_params, opt, m = stepped
        out.update(new_params=to_np(new_params), mu=to_np(opt.mu),
                   nu=to_np(opt.nu), master=to_np(opt.master),
                   step_loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                   step_traffic=to_np(m["traffic"]))
    return out


@pytest.fixture(scope="module")
def streamed_jax():
    """The streamed fused_pipe case at S 2, with JAX's train step."""
    return _jax_loss(TX, "fused_pipe", 2, 2, step=True)


def _port(arch, want, engine, moe_stream=0, pipe_slices=0):
    cfg = get_arch(arch).reduced()
    ctx = lm.make_context(cfg, "cpu", engine=engine, moe_stream=moe_stream,
                          pipe_slices=pipe_slices, compute_dtype=torch.float32)
    params = convert.params_from_jax(want["params"], device="cpu")
    state = traffic.init_traffic_state(cfg.moe.n_experts, 1,
                                       n_layers=cfg.n_layers)
    return cfg, ctx, params, pipeline.to_device(want["batch"], "cpu"), state


@pytest.mark.parametrize("engine,moe_stream,pipe_slices", ENGINES)
def test_moe_tx_lm_loss_grads_and_traffic_match_jax(engine, moe_stream,
                                                    pipe_slices, request):
    """Loss, every gradient leaf (the embedding's carries the cotangent of
    every layer input, the expert leaves that of each layer's lane slice of
    the stacked weights) and the traffic state of ``lm_loss``."""
    want = (request.getfixturevalue("streamed_jax")
            if (engine, pipe_slices) == ("fused_pipe", 2)
            else _jax_loss(TX, engine, moe_stream, pipe_slices))
    cfg, ctx, params, batch, state = _port(TX, want, engine, moe_stream,
                                           pipe_slices)
    leaves = adamw.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = lm.lm_loss(params, batch, ctx, traffic=state)
    assert metrics["tokens"] == 2 * 16 - 3
    np.testing.assert_allclose(float(loss.detach()), want["loss"], rtol=TOL,
                               atol=TOL)
    grads = _flat(adamw.unflatten(params, torch.autograd.grad(loss, leaves)))
    flat_want = _flat(want["grads"])
    assert grads.keys() == flat_want.keys()
    for k in flat_want:
        assert float(np.abs(flat_want[k]).max()) > 0, k
        _close(grads[k], flat_want[k], what=f"{engine} S {pipe_slices} {k}")
    _check_state(traffic.TrafficState(*(x.numpy() for x in metrics["traffic"])),
                 want["traffic"], engine)
    assert int(metrics["traffic"].last_expert_count.sum()) == (
        cfg.n_layers * 2 * 16 * cfg.moe.top_k)


def test_moe_tx_train_step_with_traffic_matches_jax_step(streamed_jax):
    """One streamed fused_pipe step (S 2) threading the state: loss, grad
    norm, updated params, mu, nu, master and the new state."""
    want = streamed_jax
    cfg, ctx, params, batch, state = _port(TX, want, "fused_pipe", 2, 2)
    step = steps.make_train_step(zoo.build(cfg, ctx), adamw.AdamWConfig(**OPT))
    params, opt, metrics = step(params, adamw.init(params), batch, state)
    assert opt.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), want["step_loss"],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]), want["grad_norm"],
                               rtol=TOL)
    cfg = adamw.AdamWConfig(**OPT)
    check_step(params, opt, want, cfg, adamw.schedule(cfg, 1), _close)
    _check_state(traffic.TrafficState(*(x.numpy() for x in metrics["traffic"])),
                 want["step_traffic"], "step")


def test_moe_lm_loss_threads_traffic_like_jax():
    """The moe family's per-layer states through ``lm_loss``, with its
    gradients unchanged by the state."""
    want = _jax_loss(MOE, "fused_flat")
    cfg, ctx, params, batch, state = _port(MOE, want, "fused_flat")
    loss, metrics = lm.lm_loss(params, batch, ctx, traffic=state)
    np.testing.assert_allclose(float(loss), want["loss"], rtol=TOL, atol=TOL)
    _check_state(traffic.TrafficState(*(x.numpy() for x in metrics["traffic"])),
                 want["traffic"], "moe")
    plain, m = lm.lm_loss(params, batch, ctx)
    assert "traffic" not in m and float(plain) == float(loss)


# --------------------------------------------- both families at EP = 4 ----

EP, NODE, B, S = 4, 2, 2, 16
# (arch, engine, moe_stream): the moe family through fused_hier (nodes of
# 2: Algorithm 1 on the state), moe_tx streamed through fused_pipe
EP4 = ((MOE, "fused_hier", 0), (TX, "fused_pipe", 2))

JAX_CODE = """
import dataclasses, numpy as np, jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.configs import get_arch
from repro.core import traffic
from repro.models import lm
mesh = make_mesh((1, {ep}), ("data", "model"))
out = {{}}
for arch, engine, stream in {cases!r}:
    d = np.load({data!r}.format(arch=arch))
    tree = {{}}
    for key in d.files:
        if not key.startswith("p/"):
            continue
        node = tree
        *path, leaf = key[2:].split("/")
        for p in path:
            node = node.setdefault(p, {{}})
        node[leaf] = jnp.asarray(d[key])
    cfg = get_arch(arch).reduced()
    ctx = dataclasses.replace(
        lm.make_context(cfg, mesh, multi_pod=False, engine=engine,
                        node_size={node}, moe_stream=stream),
        compute_dtype=jnp.float32)
    tr = traffic.init_traffic_state(cfg.moe.n_experts, {ep},
                                    n_layers=cfg.n_layers)
    batch = {{"tokens": jnp.asarray(d["tokens"]),
             "labels": jnp.asarray(d["labels"])}}
    with mesh:
        loss, m = jax.jit(lambda p, b, t: lm.lm_loss(
            p, b, ctx, traffic=t)).lower(tree, batch, tr).compile(
                {fast!r})(tree, batch, tr)
    out[arch + "/loss"] = np.asarray(loss)
    for f in traffic.TrafficState._fields:
        out[arch + "/t/" + f] = np.asarray(getattr(m["traffic"], f))
np.savez({out!r}, **out)
print("JAX_OK")
"""


def _rank_main(rank, world, init_file, data, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        out = {}
        for arch, engine, stream in EP4:
            d = np.load(data.format(arch=arch))
            params = {}
            for key in d.files:
                if key.startswith("p/"):
                    node = params
                    *path, leaf = key[2:].split("/")
                    for p in path:
                        node = node.setdefault(p, {})
                    node[leaf] = torch.from_numpy(d[key])
            cfg = get_arch(arch).reduced()
            ctx = lm.make_context(cfg, "cpu", ep_group=dist.group.WORLD,
                                  engine=engine, node_size=NODE,
                                  moe_stream=stream,
                                  compute_dtype=torch.float32,
                                  explicit_tp=False)     # the replicated layout
            state = traffic.init_traffic_state(cfg.moe.n_experts, world,
                                               n_layers=cfg.n_layers)
            batch = {k: torch.from_numpy(d[k]).long()
                     for k in ("tokens", "labels")}
            params = lm.shard_params(params, ctx)     # this rank's lane
            with torch.no_grad():
                loss, m = lm.lm_loss(params, batch, ctx, traffic=state)
            out[arch + "/loss"] = loss.numpy()
            for f in traffic.TrafficState._fields:
                out[arch + "/t/" + f] = getattr(m["traffic"], f).numpy()
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def test_lm_loss_traffic_ep4_matches_shard_map_rank_by_rank(tmp_path):
    """Each rank's forward loss and traffic state, both families, against
    the reference's ``lm_loss(traffic=)`` under ``shard_map`` on a (1, 4)
    mesh: every rank holds the whole loss and the group's statistics."""
    data = str(tmp_path / "data_{arch}.npz")
    for arch, _, _ in EP4:
        cfg = get_arch(arch).reduced()
        ctx = lm.make_context(cfg, "cpu", compute_dtype=torch.float32)
        ctx = dataclasses.replace(ctx, placement=dataclasses.replace(
            ctx.placement, ep=EP, node_size=NODE))
        params = lm.init_params(cfg, ctx, torch.Generator().manual_seed(0),
                                dtype=torch.float32)
        batch = _batch(cfg.vocab, B, S, seed=3)
        np.savez(data.format(arch=arch), **batch,
                 **{"p/" + k: v.numpy() for k, v in _flat(params).items()})
    code = PRELUDE + JAX_CODE.format(ep=EP, node=NODE, cases=EP4, data=data,
                                     fast=FAST, out=str(tmp_path / "jax.npz"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(run_devices, code, EP, 300)
        mp.spawn(_rank_main, args=(EP, str(tmp_path / "rendezvous"), data,
                                   str(tmp_path)), nprocs=EP, join=True)
        assert "JAX_OK" in jax_run.result()
    want = np.load(tmp_path / "jax.npz")
    fields = traffic.TrafficState._fields
    for r in range(EP):
        got = np.load(tmp_path / f"rank{r}.npz")
        for arch, _, _ in EP4:
            _close(got[arch + "/loss"], want[arch + "/loss"], f"rank {r} {arch}")
            _check_state(
                traffic.TrafficState(*(got[f"{arch}/t/{f}"] for f in fields)),
                traffic.TrafficState(*(want[f"{arch}/t/{f}"] for f in fields)),
                f"rank {r} {arch}")


# ------------------------------------------------------- the train loop ----

def test_train_run_streams_moe_tx_and_threads_traffic_like_a_hand_loop():
    """``train.run --arch moe-tx-stream --reduced --engine fused_pipe
    --moe-stream 2``: finite losses, and the final state (steps counted
    through the warm-up) equal to a hand loop of ``make_train_step`` over
    the same batches."""
    argv = ["--arch", TX, "--reduced", "--engine", "fused_pipe",
            "--moe-stream", "2", "--steps", "3", "--seq", "16", "--batch", "2"]
    args = train.parse_args(argv)
    out = train.run(args, device="cpu")
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    s = train.setup(args, device="cpu")
    assert s.ctx.moe_stream == 2 and s.ctx.dcfg.engine == "fused_pipe"
    step = steps.make_train_step(zoo.build(s.cfg, s.ctx), s.opt_cfg)
    params, opt = s.params, adamw.init(s.params)
    state = traffic.init_traffic_state(s.cfg.moe.n_experts, 1,
                                       n_layers=s.cfg.n_layers)
    losses = []
    for i in range(3):
        batch = pipeline.to_device(s.source.batch_at(i), "cpu")
        params, opt, m = step(params, opt, batch, state)
        state = m["traffic"]
        losses.append(float(m["loss"]))
    assert losses == out["losses"]
    for name in traffic.TrafficState._fields:
        assert torch.equal(getattr(out["traffic"], name), getattr(state, name)), name
    assert out["traffic"].steps.tolist() == [3] * s.cfg.n_layers


def test_serial_accumulation_trains_without_traffic(capsys):
    argv = ["--arch", TX, "--reduced", "--engine", "fused_flat", "--accum",
            "2", "--steps", "3", "--seq", "16", "--batch", "2"]
    out = train.run(train.parse_args(argv), device="cpu")
    assert out["traffic"] is None and np.isfinite(out["losses"]).all()
    assert ("[traffic] stats disabled under serial gradient accumulation"
            in capsys.readouterr().out)
