"""The port's attention-free ``moe_ffn`` family against the JAX package:
the cross-layer stream of consecutive MoE layers (``fusco.layer_stream``:
per-layer barriers, or the streamed K = 1 schedule of ``fused_pipe`` whose
tail combine of each layer lands in the next layer's prologue;
``layers/moe.stream_moe_layers``) and the reduced ``moe-ffn-stream`` model
(2 layers, d 64, 8 experts, top-2, d_ff_expert 32) in float32 on the CPU.

The stream runs at EP = 1 in-process and at EP = 4 on four gloo ranks, each
holding its stripe of the sequence and its lane's experts, compared rank by
rank with the reference's stream under ``jax.vmap(..., axis_name="model")``
(the emulated EP axis of ``tests/test_torch_tx.py``), with the traffic
state threaded; both against ``stream_dense_reference``.  Then the model's
``lm_loss``, every gradient leaf and the new traffic state against
``jax.value_and_grad(repro.models.lm.lm_loss)`` through ``fused_flat`` and
the streamed ``fused_pipe --moe-stream 2`` (one train step too), the
prefill and three decode steps, ``dcomm.pipe_geometry``'s joint slice
count against the reference's, and ``convert``.

Capacity factor 8 (no row dropped: the dense oracle applies).  Tolerances:
1e-5 for a stream and relative to each leaf's max(1, |x|) for the loss, the
gradients, the step and the traffic EMAs (float32 sums in another order);
integer counts exactly; 1e-4 on logits (two layers and the vocabulary
projection, over prefill and three decode steps).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from torch_adam import check_step
from repro.compat import make_mesh
from repro.configs import get_arch as jget_arch
from repro.core import dcomm as jdcomm
from repro.core import fusco as jfusco
from repro.core import traffic as jtraffic
from repro.core.dcomm import DcommConfig as JDcommConfig
from repro.core.routing import ExpertPlacement as JPlacement
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import lm as jlm
from repro.models import zoo as jzoo
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core import dcomm, fusco, traffic
from repro_torch.core.dcomm import DcommConfig
from repro_torch.core.routing import ExpertPlacement
from repro_torch.data import pipeline
from repro_torch.launch import serve, steps, train
from repro_torch.layers.moe import stream_moe_layers
from repro_torch.models import lm, zoo
from repro_torch.optim import adamw

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

ARCH = "moe-ffn-stream"
CFG = get_arch(ARCH).reduced()
N, D = CFG.n_layers, CFG.d_model
E, K, F = CFG.moe.n_experts, CFG.moe.top_k, CFG.moe.d_ff_expert
CF = 8.0
TOL = 1e-5
TOL_MODEL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
COUNTS = ("last_expert_count", "steps")
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}
# (engine, pipe slices) of the stream cases: the barriers, and the streamed
# schedule at one slice, at two, and at pipesim's joint count (each package
# at its own default constants: no row is dropped, so the count changes
# only the order of the sums)
STREAMS = [("fused_flat", 0), ("fused_pipe", 1), ("fused_pipe", 2),
           ("fused_pipe", 0)]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _close(got, want, what="", tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, dtype=np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _check_state(got, want, what=""):
    """Every leaf of a TrafficState (port or numpy) against the
    reference's: counts exactly, EMAs within TOL."""
    for name in traffic.TrafficState._fields:
        g = np.asarray(getattr(got, name))
        w = np.asarray(getattr(want, name))
        assert g.shape == w.shape, (what, name)
        if name in COUNTS:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")
        else:
            _close(g, w, f"{what} {name}")


# ------------------------------------------------------------ the stream --

def _stream_params(seed):
    """A block's stacked weights with ALL experts: router (N, d, E), w1/w3
    (N, E, d, f), w2 (N, E, f, d), the pre-norm scales ln (N, d)."""
    rng = np.random.default_rng(seed)
    w = lambda *s: (rng.standard_normal(s) * s[-2] ** -0.5).astype(np.float32)
    return {"router": w(N, D, E), "w1": w(N, E, D, F), "w3": w(N, E, D, F),
            "w2": w(N, E, F, D),
            "ln": (1 + 0.1 * rng.standard_normal((N, D))).astype(np.float32)}


def _x(seed, b, s):
    return np.random.default_rng(seed).standard_normal((b, s, D)).astype(np.float32)


def _jax_stream(ep, p, x, engine, slices):
    """The reference's ``layer_stream`` on ``ep`` emulated lanes, each its
    stripe of the sequence flattened b-major, with a cold traffic state
    observed in every layer: h (ep, b * S/ep, d) and each lane's new state
    (the same on every lane)."""
    b, s, _ = x.shape
    placement = JPlacement(n_experts=E, ep=ep, node_size=max(1, ep // 2))
    cfg = JDcommConfig(engine=engine, ep_axis="model",
                       node_size=placement.node_size, capacity_factor=CF,
                       pipe_slices=slices)
    xl = x.reshape(b, ep, s // ep, D).transpose(1, 0, 2, 3).reshape(ep, -1, D)
    lanes = {w: np.moveaxis(p[w].reshape(N, ep, E // ep, *p[w].shape[2:]),
                            1, 0) for w in ("w1", "w3", "w2")}
    tr0 = jtraffic.init_traffic_state(E, ep, n_layers=N)

    def fn(xs, w1, w3, w2):
        observe = lambda st, A: jtraffic.observe(
            st, A, placement, jax.lax.axis_index("model"), decay=0.99,
            axis_names=("model",))
        return jfusco.layer_stream(
            xs, jnp.asarray(p["router"]), w1, w3, w2, placement, cfg, K,
            ln=jnp.asarray(p["ln"]), stream=engine == "fused_pipe",
            traffic=tr0, observe=observe)

    h, tr = jax.jit(jax.vmap(fn, axis_name="model"))(
        jnp.asarray(xl), *(jnp.asarray(lanes[w]) for w in ("w1", "w3", "w2")))
    return np.asarray(h), jax.tree.map(np.asarray, tr)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _port_stream(p, x, engine, slices, ep=1, rank=0, group=None):
    """The port's ``layer_stream`` on this rank's stripe (flattened b-major)
    and its lane's experts, with a cold traffic state: (h, new state)."""
    b, s, _ = x.shape
    s_l = s // ep
    xs = torch.from_numpy(np.ascontiguousarray(
        x[:, rank * s_l:(rank + 1) * s_l])).reshape(-1, D)
    placement = ExpertPlacement(n_experts=E, ep=ep, node_size=max(1, ep // 2))
    cfg = DcommConfig(engine=engine, capacity_factor=CF, pipe_slices=slices)
    t = _t(p)
    lane = {w: t[w].reshape(N, ep, E // ep, *t[w].shape[2:])[:, rank]
            for w in ("w1", "w3", "w2")}
    observe = lambda st, A: traffic.observe(st, A, placement, rank,
                                            decay=0.99, group=group)
    return fusco.layer_stream(
        xs, t["router"], lane["w1"], lane["w3"], lane["w2"], placement, cfg,
        K, ln=t["ln"], traffic=traffic.init_traffic_state(E, ep, n_layers=N),
        observe=observe, group=group)


def _dense(p, x):
    """Both packages' ``stream_dense_reference`` of the whole (b*S, d)
    batch; they must agree."""
    xt = x.reshape(-1, D)
    t = _t(p)
    got = fusco.stream_dense_reference(torch.from_numpy(xt), t["router"],
                                       t["w1"], t["w3"], t["w2"], K,
                                       ln=t["ln"]).numpy()
    want = np.asarray(jfusco.stream_dense_reference(
        jnp.asarray(xt), *(jnp.asarray(p[w]) for w in
                           ("router", "w1", "w3", "w2")), K,
        ln=jnp.asarray(p["ln"])))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    return got


@pytest.mark.parametrize("engine,slices", STREAMS)
def test_layer_stream_ep1_matches_jax_and_the_dense_oracle(engine, slices):
    """One lane: the barriers and the streamed schedule (the first empty
    tail, each deferred tail, the epilogue), with the traffic state."""
    p = _stream_params(3)
    x = _x(4, 2, 8)
    h_j, tr_j = _jax_stream(1, p, x, engine, slices)
    h, tr = _port_stream(p, x, engine, slices)
    np.testing.assert_allclose(h.numpy(), h_j[0], rtol=TOL, atol=TOL)
    _check_state(tr, jax.tree.map(lambda a: a[0], tr_j), "EP 1")
    assert tr.steps.tolist() == [1] * N
    assert tr.last_expert_count.sum(-1).tolist() == [16 * K] * N
    np.testing.assert_allclose(h.numpy(), _dense(p, x), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("engine", ["fused_flat", "fused_pipe"])
def test_stream_moe_layers_refuses_fsdp_and_runs_interleaved_lanes(
        engine, monkeypatch):
    """FSDP of the expert weights over a data group of one rank (a
    stand-in group) is the identity through either schedule: the plain
    stream's output with no collective (the grid is
    ``tests/test_torch_fsdp.py``'s); interleaved micro-batch lanes run (the
    barriers ignore them) and equal the plain stream."""
    t = _t(_stream_params(3))
    params = {"router": t["router"],
              **{w: t[w][:, None] for w in ("w1", "w3", "w2")}}
    kw = dict(placement=ExpertPlacement(n_experts=E, ep=1, node_size=1),
              dcfg=DcommConfig(engine=engine, capacity_factor=CF), top_k=K)
    x = torch.from_numpy(_x(4, 2, 8))
    one = stream_moe_layers(x, params, t["ln"], **kw)
    data = object()
    monkeypatch.setattr(dist, "get_world_size",
                        lambda group=None: 1 if group is data else 2)
    with dcomm.collective_calls() as calls:
        fsdp = stream_moe_layers(x, params, t["ln"], fsdp=data, **kw)
    assert calls == []
    np.testing.assert_array_equal(fsdp.numpy(), one.numpy())
    monkeypatch.undo()
    assert one.shape == x.shape
    np.testing.assert_allclose(
        stream_moe_layers(x, params, t["ln"], interleave=2, **kw).numpy(),
        one.numpy(), rtol=TOL, atol=TOL)


def _rank_main(rank, world, init_file, data, out_dir):
    """One EP rank: its stripe and its lane's experts through every stream
    case, and the streamed case at S 2 through ``stream_moe_layers`` (the
    rank's own lane of the stack, the (B, S/ep, d) stripe, traffic summed
    over the group)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        d = dict(np.load(data))
        x = d.pop("x")
        out = {}
        for engine, slices in STREAMS:
            h, tr = _port_stream(d, x, engine, slices, world, rank,
                                 dist.group.WORLD)
            out[f"h {engine} {slices}"] = h.numpy()
            out.update({f"tr {engine} {slices} {f}": getattr(tr, f).numpy()
                        for f in traffic.TrafficState._fields})
        s_l = x.shape[1] // world
        t = _t(d)
        placement = ExpertPlacement(n_experts=E, ep=world,
                                    node_size=max(1, world // 2))
        y, _ = stream_moe_layers(
            torch.from_numpy(np.ascontiguousarray(
                x[:, rank * s_l:(rank + 1) * s_l])),
            {"router": t["router"],
             **{w: t[w].reshape(N, world, E // world, *t[w].shape[2:])[
                 :, rank:rank + 1] for w in ("w1", "w3", "w2")}}, t["ln"],
            placement=placement,
            dcfg=DcommConfig(engine="fused_pipe", capacity_factor=CF,
                             pipe_slices=2),
            top_k=K, traffic=traffic.init_traffic_state(E, world, n_layers=N),
            group=dist.group.WORLD)
        out["y"] = y.numpy()
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def test_layer_stream_ep4_gloo_matches_jax_rank_by_rank(tmp_path):
    """Four lanes: every stream case rank by rank against the reference's,
    the traffic state summed over the group the same on every rank; the
    joined stripes equal the dense oracle."""
    ep, b, s = 4, 2, 16
    p = _stream_params(5)
    x = _x(6, b, s)
    np.savez(tmp_path / "data.npz", x=x, **p)
    ranks = mp.spawn(_rank_main, args=(ep, str(tmp_path / "rendezvous"),
                                       str(tmp_path / "data.npz"),
                                       str(tmp_path)),
                     nprocs=ep, join=False)
    want = {case: _jax_stream(ep, p, x, *case) for case in STREAMS}
    while not ranks.join():
        pass
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(ep)]
    dense = _dense(p, x).reshape(b, s, D)
    for engine, slices in STREAMS:
        h_j, tr_j = want[engine, slices]
        case = f"{engine} {slices}"
        for r in range(ep):
            np.testing.assert_allclose(got[r][f"h {case}"], h_j[r], rtol=TOL,
                                       atol=TOL, err_msg=f"{case} rank {r}")
            state = traffic.TrafficState(*(got[r][f"tr {case} {f}"] for f in
                                           traffic.TrafficState._fields))
            _check_state(state, jax.tree.map(lambda a: a[r], tr_j),
                         f"{case} rank {r}")
        joined = h_j.reshape(ep, b, s // ep, D).transpose(1, 0, 2, 3)
        np.testing.assert_allclose(joined.reshape(b, s, D), dense, rtol=TOL,
                                   atol=TOL, err_msg=case)
    for r in range(ep):
        np.testing.assert_array_equal(
            got[r]["y"].reshape(-1, D), got[r]["h fused_pipe 2"],
            err_msg=f"stream_moe_layers rank {r}")


@pytest.mark.parametrize("t,k,d,itemsize,n_e,ep", [
    (32, 2, 64, 4, 8, 1), (12, 2, 64, 4, 8, 4),       # reduced, EP 1 and 4
    (4096, 4, 1024, 2, 64, 1), (2048, 4, 1024, 2, 64, 1)])   # serve, train
def test_pipe_geometry_of_the_stream_is_the_references(t, k, d, itemsize,
                                                       n_e, ep):
    """The joint slice count of an N-layer stream (pipesim's
    ``plan_layer_stream`` branch) and its capacity, at the reduced and the
    full-width shapes, for blocks of 2 and 16 layers and one layer, at the
    port's default constants (the H100 spec point; the reference's default
    to another card's, so both sides are given the port's)."""
    placement = ExpertPlacement(n_e, ep, max(1, ep // 2))
    jplacement = JPlacement(n_experts=n_e, ep=ep, node_size=max(1, ep // 2))
    spec = DcommConfig()
    point = dict(pipe_stage_bw=spec.pipe_stage_bw,
                 pipe_wire_bw=spec.pipe_wire_bw,
                 pipe_overhead_s=spec.pipe_overhead_s)
    for layers in (1, 2, 16):
        for factor in (2.0, CF):
            kw = dict(engine="fused_pipe", capacity_factor=factor, **point)
            got = dcomm.pipe_geometry(t, k, d, itemsize, placement,
                                      DcommConfig(**kw), n_layers=layers)
            want = jdcomm.pipe_geometry(t, k, d, itemsize, jplacement,
                                        JDcommConfig(**kw), n_layers=layers)
            assert got == want, (layers, factor)


# ------------------------------------------------------------- the model --

def _model_params(seed=0):
    """Seeded numpy parameters in the reference's moe_ffn tree (ln1 and moe
    only): norms near 1, weights scaled by their fan-in."""
    shapes = _flat(lm.init_params(CFG, lm.make_context(CFG, "cpu"),
                                  torch.Generator().manual_seed(0),
                                  dtype=torch.float32))
    rng = np.random.default_rng(seed)
    tree = {}
    for k, v in shapes.items():
        shape = tuple(v.shape)
        if k.endswith(("norm", "ln1")):
            a = 1 + 0.1 * rng.standard_normal(shape)
        elif k == "embed":
            a = rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape) * shape[-2] ** -0.5
        node = tree
        *path, leaf = k.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = a.astype(np.float32)
    return tree


def _batch(b=2, s=16, seed=0):
    toks = np.random.default_rng(seed).integers(0, CFG.vocab, (b, s + 1))
    toks = toks.astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


def _jax_ctx(engine, moe_stream=0, pipe_slices=0):
    mesh = make_mesh((1, 1), ("data", "model"))
    cfg = jget_arch(ARCH).reduced()
    return cfg, mesh, dataclasses.replace(
        jlm.make_context(cfg, mesh, multi_pod=False, engine=engine,
                         moe_stream=moe_stream, pipe_slices=pipe_slices,
                         capacity_factor=CF),
        compute_dtype=jnp.float32, remat=False)


# (engine, moe_stream, pipe_slices) of the model cases: the barriers, and
# both layers in one streamed block at 2 slices (the tail of layer 0 lands
# in layer 1's prologue)
MODELS = {"fused_flat": ("fused_flat", 0, 0), "streamed": ("fused_pipe", 2, 2)}


@pytest.fixture(scope="module", params=list(MODELS))
def jax_model(request):
    """JAX: loss, every gradient and the new traffic state from a cold one,
    and one train step threading it, in one compiled program."""
    engine, moe_stream, slices = MODELS[request.param]
    cfg, mesh, ctx = _jax_ctx(engine, moe_stream, slices)
    params = jax.tree.map(jnp.asarray, _model_params())
    batch = _batch()
    jb = jax.tree.map(jnp.asarray, batch)
    tr0 = jtraffic.init_traffic_state(E, 1, n_layers=N)
    value_and_grad = jax.value_and_grad(
        lambda p, b, tr: jlm.lm_loss(p, b, ctx, traffic=tr), has_aux=True)
    train_step = jmake_train_step(jzoo.build(cfg, ctx),
                                  jadamw.AdamWConfig(**OPT))

    def both(p, b, tr):
        return value_and_grad(p, b, tr), train_step(p, jadamw.init(p), b, tr)

    with mesh:
        ((loss, m), grads), (new_params, opt, sm) = jax.jit(both).lower(
            params, jb, tr0).compile(FAST)(params, jb, tr0)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return dict(case=request.param, params=to_np(params), batch=batch,
                loss=float(loss), grads=to_np(grads),
                traffic=to_np(m["traffic"]), new_params=to_np(new_params),
                mu=to_np(opt.mu), nu=to_np(opt.nu), master=to_np(opt.master),
                step_loss=float(sm["loss"]), grad_norm=float(sm["grad_norm"]),
                step_traffic=to_np(sm["traffic"]))


def _port_model(want):
    engine, moe_stream, slices = MODELS[want["case"]]
    ctx = lm.make_context(CFG, "cpu", engine=engine, moe_stream=moe_stream,
                          pipe_slices=slices, capacity_factor=CF,
                          compute_dtype=torch.float32)
    params = convert.params_from_jax(want["params"], device="cpu")
    return (ctx, params, pipeline.to_device(want["batch"], "cpu"),
            traffic.init_traffic_state(E, 1, n_layers=N))


def test_moe_ffn_loss_grads_and_traffic_match_jax(jax_model):
    ctx, params, batch, state = _port_model(jax_model)
    leaves = adamw.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = lm.lm_loss(params, batch, ctx, traffic=state)
    np.testing.assert_allclose(float(loss.detach()), jax_model["loss"],
                               rtol=TOL, atol=TOL)
    _check_state(metrics["traffic"], jax_model["traffic"], "loss traffic")
    assert metrics["traffic"].steps.tolist() == [1] * N
    grads = _flat(adamw.unflatten(params, torch.autograd.grad(loss, leaves)))
    want = _flat(jax_model["grads"])
    assert grads.keys() == want.keys() == {
        "embed", "final_norm", "lm_head", "layers/ln1", "layers/moe/router",
        "layers/moe/w1", "layers/moe/w3", "layers/moe/w2"}
    for k in want:
        _close(grads[k], want[k], what=k)
        # the first layer's expert weights get a gradient: through the
        # deferred tail's scatter-add in the streamed case
        if k.startswith("layers/"):
            assert float(grads[k][0].abs().max()) > 0, k


def test_moe_ffn_train_step_matches_jax_step(jax_model):
    ctx, params, batch, state = _port_model(jax_model)
    model = zoo.build(CFG, ctx)
    step = steps.make_train_step(model, adamw.AdamWConfig(**OPT))
    params, opt, metrics = step(params, steps.init_state(model, params),
                                batch, state)
    np.testing.assert_allclose(float(metrics["loss"]),
                               jax_model["step_loss"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               jax_model["grad_norm"], rtol=TOL)
    _check_state(metrics["traffic"], jax_model["step_traffic"], "step traffic")
    cfg = adamw.AdamWConfig(**OPT)
    check_step(params, opt, jax_model, cfg, adamw.schedule(cfg, 1), _close)


@pytest.mark.parametrize("case", list(MODELS))
def test_moe_ffn_prefill_and_decode_match_jax(case):
    """The prefill's logits and length (no cache: the stack is stateless),
    then three decode steps (``h + moe(ln1 h)`` a layer) fed the same
    tokens, with the prefill's traffic state."""
    engine, moe_stream, slices = MODELS[case]
    _, mesh, ctx_j = _jax_ctx(engine, moe_stream, slices)
    params_np = _model_params(2)
    params_j = jax.tree.map(jnp.asarray, params_np)
    rng = np.random.default_rng(9)
    b, s, max_len = 3, 8, 12
    tokens = rng.integers(0, CFG.vocab, (b, s)).astype(np.int32)
    feeds = rng.integers(0, CFG.vocab, (3, b)).astype(np.int32)
    tr0 = jtraffic.init_traffic_state(E, 1, n_layers=N)
    with mesh:
        logits, state, tr = jax.jit(lambda p, t, tr: jlm.prefill(
            p, t, jnp.arange(s), ctx_j, max_len, traffic=tr))(
                params_j, jnp.asarray(tokens), tr0)
        want = [np.asarray(logits)]
        decode = jax.jit(lambda p, st, t: jlm.decode_step(p, st, t, ctx_j,
                                                          max_len))
        for tok in feeds:
            logits, state = decode(params_j, state, jnp.asarray(tok))
            want.append(np.asarray(logits))
    assert state.kv is None

    ctx = lm.make_context(CFG, "cpu", engine=engine, moe_stream=moe_stream,
                          pipe_slices=slices, capacity_factor=CF,
                          compute_dtype=torch.float32)
    params = convert.params_from_jax(params_np, device="cpu")
    logits, st, new_tr = lm.prefill(
        params, torch.from_numpy(tokens).long(), torch.arange(s), ctx,
        max_len, traffic=traffic.init_traffic_state(E, 1, n_layers=N))
    assert st.kv is None and int(st.length) == s
    _check_state(new_tr, jax.tree.map(np.asarray, tr), "prefill traffic")
    got = [logits]
    for tok in feeds:
        logits, st = lm.decode_step(params, st, torch.from_numpy(tok).long(),
                                    ctx, max_len)
        got.append(logits)
    for i, (a, w) in enumerate(zip(got, want, strict=True)):
        _close(a, w, f"logits {i}", TOL_MODEL)
    assert int(st.length) == s + 3


def test_convert_takes_the_jax_moe_ffn_tree():
    """The reference's moe_ffn tree (ln1 and moe, no attention) converts
    leaf for leaf; the port's init builds the same keys and shapes, and
    its parameter count is the reckoning's."""
    cfg, _, ctx = _jax_ctx("fused_flat")
    tree = jax.tree.map(np.asarray, jlm.init_params(
        cfg, jax.random.PRNGKey(1), ctx, dtype=jnp.float32))
    assert set(tree["layers"]) == {"ln1", "moe"}
    flat_j = _flat(tree)
    flat_t = _flat(convert.params_from_jax(tree, device="cpu"))
    assert flat_t.keys() == flat_j.keys()
    for key, leaf in flat_j.items():
        np.testing.assert_array_equal(flat_t[key].numpy(), leaf, err_msg=key)
    own = _flat(lm.init_params(CFG, lm.make_context(CFG, "cpu"),
                               torch.Generator().manual_seed(0)))
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: v.shape for k, v in flat_j.items()}
    rep, experts = lm.param_counts(CFG)
    assert rep + experts == sum(v.size for v in flat_j.values())
    assert experts == sum(flat_j[f"layers/moe/{w}"].size
                          for w in ("w1", "w3", "w2"))
    assert lm.param_counts(get_arch(ARCH)) == (68_174_848, 3_221_225_472)


def test_moe_ffn_entry_points_on_the_cpu():
    """``train.run`` and ``serve.run`` of the reduced model through both
    engines: finite losses and the traffic state threaded through every
    step; in-vocabulary tokens; the stream block must divide the depth."""
    base = ["--arch", ARCH, "--reduced"]
    for engine in (["--engine", "fused_flat"],
                   ["--engine", "fused_pipe", "--moe-stream", "2"]):
        out = train.run(train.parse_args(base + engine + [
            "--steps", "3", "--seq", "16", "--batch", "2"]), device="cpu")
        assert np.isfinite(out["losses"]).all()
        assert out["traffic"].steps.tolist() == [3] * N
        sv = serve.run(serve.parse_args(base + engine + [
            "--requests", "3", "--prompt-len", "8", "--gen", "3"]),
            device="cpu")
        assert sv["tokens"].shape == (3, 3)
        assert bool(((sv["tokens"] >= 0) & (sv["tokens"] < CFG.vocab)).all())
    ctx = lm.make_context(CFG, "cpu", engine="fused_pipe", moe_stream=3)
    params = lm.init_params(CFG, ctx, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="must divide"):
        lm.prefill(params, torch.zeros((1, 4), dtype=torch.long),
                   torch.arange(4), ctx, 8)
