"""The port's ``fused_pipe`` and ``disagg`` engines against the JAX package.

Each engine runs ``fusco.moe_shuffle_ffn`` beside the JAX engine of the same
name (``repro.core.fusco.moe_shuffle_ffn`` under ``jax.vmap(...,
axis_name="model")``, the emulated EP axis of ``tests/test_torch_moe.py``):
``fused_pipe`` at ``pipe_slices`` 1, 4 and 0 (pipesim's count; both sides
get the same explicit pipe constants), and ``disagg``.  EP = 1 in-process;
EP = 4 on four gloo ranks, every engine inside one spawned group, which also
holds the asynchronous exchange (autograd off) to the synchronous one.
Then the split-phase ``pipe_dispatch``/``pipe_combine`` against
``flat_dispatch``/``flat_combine``, ``slice_flat_plan`` and the per-slice
owner tables, and the gradients of both engines against ``jax.grad``.

float32, inputs from numpy seeds; tolerance 1e-5 (sums in another order),
gradients 1e-5 of each result's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.core import fusco as jfusco
from repro.core import planner as jplanner
from repro.core.dcomm import DcommConfig as JDcommConfig
from repro.core.routing import ExpertPlacement as JPlacement
from repro_torch.core import dcomm, fusco, planner
from repro_torch.core.dcomm import DcommConfig
from repro_torch.core.routing import (ExpertPlacement, router_logits,
                                      top_k_routing)
from repro_torch.kernels import ref

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

E, K, D, F, CF = 8, 2, 16, 24, 8.0
TOL = 1e-5
# a hardware point at which pipesim slices the tiny test payloads: a slow
# wire and almost no per-slice overhead (the H100 defaults give one slice)
PIPE = dict(pipe_stage_bw=1e9, pipe_wire_bw=1e6, pipe_overhead_s=1e-9)
ENGINES = [("fused_pipe", 1), ("fused_pipe", 4), ("fused_pipe", 0),
           ("disagg", 0)]


def _weights(seed, t_total):
    """Router, canonical experts (E, d, f)/(E, f, d), tokens and a
    cotangent, from numpy."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(wr=rng.standard_normal((D, E)).astype(f32) * 0.5,
                w1=rng.standard_normal((E, D, F)).astype(f32) * 0.1,
                w3=rng.standard_normal((E, D, F)).astype(f32) * 0.1,
                w2=rng.standard_normal((E, F, D)).astype(f32) * 0.1,
                x=rng.standard_normal((t_total, D)).astype(f32),
                cot=rng.standard_normal((t_total, D)).astype(f32))


def _cfgs(engine, slices, ep, cf=CF):
    """The port's and the reference's config of one engine."""
    kw = dict(engine=engine, capacity_factor=cf, pipe_slices=slices, **PIPE)
    return (DcommConfig(**kw),
            JDcommConfig(ep_axis="model", node_size=max(1, ep // 2), **kw))


def _jax_shuffle(engine, slices, ep, p, x, cf=CF):
    """The JAX engine on ``ep`` emulated lanes: x (ep, T, d) -> (ep, T, d)."""
    placement = JPlacement(n_experts=E, ep=ep, node_size=max(1, ep // 2))
    cfg = _cfgs(engine, slices, ep, cf)[1]
    lane = lambda w: jnp.asarray(w).reshape(ep, E // ep, *w.shape[1:])

    def fn(xl, a, b, c):
        return jfusco.moe_shuffle_ffn(xl, jnp.asarray(p["wr"]), a, b, c,
                                      placement, cfg, K)

    return np.asarray(jax.jit(jax.vmap(fn, axis_name="model"))(
        jnp.asarray(x), lane(p["w1"]), lane(p["w3"]), lane(p["w2"])))


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


@pytest.mark.parametrize("engine,slices", ENGINES)
def test_engine_ep1_matches_jax_and_dense(engine, slices):
    p = _weights(0, 24)
    y = fusco.moe_shuffle_ffn(_t(p["x"]), *(_t(p[n]) for n in
                                           ("wr", "w1", "w3", "w2")),
                              ExpertPlacement(E, 1, 1),
                              _cfgs(engine, slices, 1)[0], K).numpy()
    np.testing.assert_allclose(
        y, _jax_shuffle(engine, slices, 1, p, p["x"][None])[0], rtol=TOL,
        atol=TOL)
    dense = fusco.dense_moe_reference(*(_t(p[n]) for n in
                                        ("x", "wr", "w1", "w3", "w2")), K)
    np.testing.assert_allclose(y, dense.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("engine", ["fused_pipe", "disagg"])
def test_engine_capacity_overflow_drops_like_jax(engine):
    p = _weights(1, 32)
    y = fusco.moe_shuffle_ffn(_t(p["x"]), *(_t(p[n]) for n in
                                           ("wr", "w1", "w3", "w2")),
                              ExpertPlacement(E, 1, 1),
                              _cfgs(engine, 2, 1, cf=0.5)[0], K).numpy()
    np.testing.assert_allclose(
        y, _jax_shuffle(engine, 2, 1, p, p["x"][None], cf=0.5)[0], rtol=TOL,
        atol=TOL)


def test_pipe_geometry_slices_the_tiny_payload():
    """The ``pipe_slices=0`` cases above really slice: pipesim picks more
    than one slice at ``PIPE``, and the port's count is the reference's."""
    from repro.core import dcomm as jdcomm
    for ep in (1, 4):
        cfg, jcfg = _cfgs("fused_pipe", 0, ep)
        t = 24 if ep == 1 else 12
        got = dcomm.pipe_geometry(t, K, D, 4, ExpertPlacement(E, ep, max(1, ep // 2)),
                                  cfg)
        want = jdcomm.pipe_geometry(t, K, D, 4, JPlacement(
            n_experts=E, ep=ep, node_size=max(1, ep // 2)), jcfg)
        assert got == want and got[1] > 1


def _rank_main(rank, world, init_file, data, out_dir):
    """One EP rank: every engine on its token shard and its lane's experts;
    fused_pipe at S = 4 also with autograd on (the synchronous exchange)
    beside autograd off (the asynchronous one)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        d = np.load(data)
        placement = ExpertPlacement(n_experts=E, ep=world,
                                    node_size=max(1, world // 2))
        el = E // world
        lane = lambda w: torch.from_numpy(w.reshape(world, el, *w.shape[1:])[rank])
        args = (torch.from_numpy(d["x"][rank]), torch.from_numpy(d["wr"]),
                lane(d["w1"]), lane(d["w3"]), lane(d["w2"]), placement)
        group = dist.group.WORLD
        out = {}
        with torch.no_grad():
            for engine, slices in ENGINES:
                out[f"{engine}{slices}"] = fusco.moe_shuffle_ffn(
                    *args, _cfgs(engine, slices, world)[0], K,
                    group=group).numpy()
        with torch.enable_grad():
            out["sync"] = fusco.moe_shuffle_ffn(
                *args, _cfgs("fused_pipe", 4, world)[0], K,
                group=group).detach().numpy()
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def test_engines_ep4_gloo_match_jax_rank_by_rank(tmp_path):
    ep, t = 4, 12
    p = _weights(2, ep * t)
    x = p["x"].reshape(ep, t, D)
    np.savez(tmp_path / "data.npz", **{**p, "x": x})
    mp.spawn(_rank_main, args=(ep, str(tmp_path / "rendezvous"),
                               str(tmp_path / "data.npz"), str(tmp_path)),
             nprocs=ep, join=True)
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(ep)]
    for engine, slices in ENGINES:
        expect = _jax_shuffle(engine, slices, ep, p, x)
        for r in range(ep):
            np.testing.assert_allclose(got[r][f"{engine}{slices}"], expect[r],
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"{engine} S={slices} rank {r}")
    for r in range(ep):        # the async exchange computes the sync one's bits
        np.testing.assert_array_equal(got[r]["sync"], got[r]["fused_pipe4"])


def _routing(p, t):
    x = _t(p["x"][:t])
    A, gates = top_k_routing(router_logits(x, _t(p["wr"])), K)
    return x, A, gates


def test_pipe_dispatch_lands_the_flat_buffer_and_combines_like_it():
    """At a slice count dividing the flat capacity, the split-phase pipelined
    dispatch lands the buffer and counts ``flat_dispatch`` lands, and its
    combine gives the flat combine's output."""
    p = _weights(3, 24)
    x, A, gates = _routing(p, 24)
    placement = ExpertPlacement(E, 1, 1)
    flat = DcommConfig(engine="fused_flat", capacity_factor=CF)
    pipe = DcommConfig(engine="fused_pipe", capacity_factor=CF, pipe_slices=4)
    rf = dcomm.flat_dispatch(x, A, gates, placement, flat)
    rp = dcomm.pipe_dispatch(x, A, gates, placement, pipe)
    assert rp.expert_rows.shape == rf.expert_rows.shape
    assert torch.equal(rp.expert_rows, rf.expert_rows)
    assert torch.equal(rp.counts, rf.counts)
    assert int(rp.dropped) == int(rf.dropped) == 0
    out = ref.fused_swiglu_ref(rf.expert_rows, _t(p["w1"]), _t(p["w3"]),
                               _t(p["w2"]), rf.counts)
    np.testing.assert_allclose(
        fusco.combine(out, rp, placement, pipe).numpy(),
        fusco.combine(out, rf, placement, flat).numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("ep,cap,slices", [(1, 16, 4), (4, 24, 3), (2, 8, 8)])
def test_slice_flat_plan_matches_jax(ep, cap, slices):
    rng = np.random.default_rng(4)
    t = 20
    A = np.stack([rng.choice(E, K, replace=False) for _ in range(t)]).astype(np.int32)
    gates = rng.uniform(size=(t, K)).astype(np.float32)
    node = max(1, ep // 2)
    plan = planner.build_flat_plan(torch.from_numpy(A), torch.from_numpy(gates),
                                   ExpertPlacement(E, ep, node), cap)
    jplace = JPlacement(n_experts=E, ep=ep, node_size=node)
    jplan = jplanner.build_flat_plan(jnp.asarray(A), jnp.asarray(gates), jplace,
                                     cap)
    got = planner.slice_flat_plan(plan, ExpertPlacement(E, ep, node), cap, slices)
    want = jplanner.slice_flat_plan(jplan, jplace, cap, slices)
    assert got.n_slices == want.n_slices == slices
    np.testing.assert_array_equal(got.src.numpy(), np.asarray(want.src))
    np.testing.assert_array_equal(got.gate.numpy(), np.asarray(want.gate))
    with pytest.raises(ValueError, match="not divisible"):
        planner.slice_flat_plan(plan, ExpertPlacement(E, ep, node), cap,
                                slices + 1 if cap % (slices + 1) else 5)
    with pytest.raises(ValueError, match="not divisible"):
        jplanner.slice_flat_plan(jplan, jplace, cap,
                                 slices + 1 if cap % (slices + 1) else 5)


@pytest.mark.parametrize("t,ep,cf,slices", [(24, 1, 8.0, 4), (32, 1, 0.5, 2),
                                            (12, 4, 2.0, 8)])
def test_slice_owner_tables_are_the_counting_build(t, ep, cf, slices):
    """Each slice's owner table, the elementwise map of the slot table, is
    the inverse of that slice's descriptors: its rows sorted are the lists
    the counting build (``ref.build_owners_ref``) makes from the slice's
    ``src``, with dropped assignments -1."""
    rng = np.random.default_rng(5)
    A = np.stack([rng.choice(E, K, replace=False) for _ in range(t)]).astype(np.int32)
    gates = rng.uniform(size=(t, K)).astype(np.float32)
    placement = ExpertPlacement(E, ep, max(1, ep // 2))
    cap = -(-dcomm._cap(t * K / E, cf) // slices) * slices
    plan = planner.build_flat_plan(torch.from_numpy(A), torch.from_numpy(gates),
                                   placement, cap)
    sliced = planner.slice_flat_plan(plan, placement, cap, slices)
    owners = planner.slice_owner_table(plan.slots.slot, cap, slices)
    assert owners.shape == (slices, t, K) and owners.dtype == torch.int32
    live = plan.slots.slot >= 0
    assert torch.equal((owners >= 0).sum(0), live.to(torch.int64))
    for s in range(slices):
        offsets, lists = ref.build_owners_ref(sliced.src[s].reshape(-1), t)
        for i in range(t):
            assert lists[offsets[i]:offsets[i + 1]].tolist() == sorted(
                x for x in owners[s, i].tolist() if x >= 0)


@pytest.mark.parametrize("engine,slices", [("fused_pipe", 4), ("fused_pipe", 0),
                                           ("disagg", 0)])
def test_engine_grads_ep1_match_jax(engine, slices):
    """Gradients of ``sum(out * cot)`` for x, the router and w1/w3/w2, with
    capacity drops (factor 0.5)."""
    p = _weights(6, 32)
    names = ("x", "wr", "w1", "w3", "w2")
    cfg, jcfg = _cfgs(engine, slices, 1, cf=0.5)
    jp = JPlacement(n_experts=E, ep=1, node_size=1)

    def jloss(*a):
        y = jax.vmap(lambda *b: jfusco.moe_shuffle_ffn(*b, jp, jcfg, K),
                     in_axes=(0, None, 0, 0, 0), axis_name="model")(
            a[0][None], a[1], a[2][None], a[3][None], a[4][None])[0]
        return jnp.sum(y * jnp.asarray(p["cot"]))

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(5))))(
        *(jnp.asarray(p[n]) for n in names))
    ts = [_t(p[n], grad=True) for n in names]
    y = fusco.moe_shuffle_ffn(*ts, ExpertPlacement(E, 1, 1), cfg, K)
    (y * _t(p["cot"])).sum().backward()
    for n, t, w in zip(names, ts, want):
        w = np.asarray(w)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=TOL,
                                   atol=TOL * scale, err_msg=n)


@pytest.mark.parametrize("engine", ["fused_pipe", "disagg"])
def test_reduced_train_run_through_the_engine_follows_fused_flat(engine,
                                                                 capsys):
    """``launch/train.run`` of the reduced qwen3-moe on the CPU through the
    engine (fused_pipe with two slices and the CPU's calibrated constants)
    trains with finite losses, and the engine's train step follows
    fused_flat's two ways.

    bf16, along fused_flat's run: at every step the engine takes fused_flat's
    loss from the same parameters, batch and traffic state.  The engines
    round their partial sums in other places, so the losses agree to 2e-3
    relative (a quarter of bf16's epsilon), not bit for bit.  The bf16
    gradients are not held element by element: a token whose top-k choice
    flips under the other roundings moves every leaf's gradient, and at
    32 tokens that is far beyond any rounding bound.

    float32, each engine on its own: three steps of ``make_train_step`` from
    one f32 initialisation through the engine and through fused_flat give
    the same losses, clip norms, traffic state and final parameters within
    1e-5 relative (the parameters in each leaf's norm).  Steps 2 and 3 run
    on the parameters the engine's own backward and AdamW update made.  In
    bf16 the engines' roundings pick the sign of AdamW's first update
    wherever a gradient is within rounding of zero, so two free-running bf16
    runs part; in f32 that touches a few elements by a rounding's worth."""
    import dataclasses

    from repro_torch.data.pipeline import to_device
    from repro_torch.launch import steps, train
    from repro_torch.models import lm, zoo
    from repro_torch.optim import adamw
    argv = ["--reduced", "--steps", "3", "--seq", "16", "--batch", "2"]
    extra = (["--pipe-slices", "2", "--calibrate"] if engine == "fused_pipe"
             else [])
    args = train.parse_args(argv + ["--engine", engine] + extra)
    flat_args = train.parse_args(argv + ["--engine", "fused_flat"])
    out = train.run(args, device="cpu")
    flat = train.run(flat_args, device="cpu")
    assert np.isfinite(out["losses"]).all()
    assert ("[calibrate] cpu: stage" in capsys.readouterr().out) == (
        engine == "fused_pipe")
    s, e = train.setup(flat_args, "cpu"), train.setup(args, "cpu")
    step = steps.make_train_step(zoo.build(s.cfg, s.ctx), s.opt_cfg)
    model = zoo.build(e.cfg, e.ctx)
    params, opt = s.params, adamw.init(s.params)
    state = train.init_traffic(s.cfg, s.ctx, 1)
    for i, want in enumerate(flat["losses"]):
        batch = to_device(s.source.batch_at(i), "cpu")
        with torch.no_grad():
            got, _ = model.loss(params, batch, traffic=state)
        params, opt, m = step(params, opt, batch, state)
        state = m["traffic"]
        assert float(m["loss"]) == want
        np.testing.assert_allclose(float(got), want, rtol=2e-3)

    def f32_run(st):
        ctx = dataclasses.replace(st.ctx, compute_dtype=torch.float32)
        p = lm.init_params(st.cfg, ctx, torch.Generator().manual_seed(0),
                           dtype=torch.float32)
        o, tr = adamw.init(p), train.init_traffic(st.cfg, ctx, 1)
        f32_step = steps.make_train_step(zoo.build(st.cfg, ctx), st.opt_cfg)
        seen = []
        for i in range(3):
            p, o, m = f32_step(p, o, to_device(st.source.batch_at(i), "cpu"),
                               tr)
            tr = m["traffic"]
            seen.append((float(m["loss"]), float(m["grad_norm"])))
        return np.array(seen), p, tr

    (got, p_got, tr_got), (want, p_want, tr_want) = f32_run(e), f32_run(s)
    np.testing.assert_allclose(got, want, rtol=TOL)
    # the parameters in each leaf's norm: an element whose gradient is
    # within f32 rounding of AdamW's eps moves by a rounding-chosen amount
    for n, a, b in zip(adamw.paths(p_want), adamw.leaves(p_got),
                       adamw.leaves(p_want)):
        err = float((a - b).detach().norm())
        assert err <= TOL * float(b.detach().norm()), (n, err)
    for n, a, b in zip(tr_want._fields, tr_got, tr_want):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=TOL, atol=TOL, err_msg=n)


def test_pipe_geometry_plans_once_per_shape(monkeypatch):
    """The slice plan is static, as the reference's trace-time plan is: a
    second shuffle of the same shape and config runs no pipesim sweep (a
    sweep costs milliseconds of host time at full width)."""
    calls = []
    plan = dcomm.pipesim.plan_slices
    monkeypatch.setattr(dcomm.pipesim, "plan_slices",
                        lambda *a, **k: calls.append(1) or plan(*a, **k))
    p = _weights(7, 24)
    cfg = DcommConfig(engine="fused_pipe", capacity_factor=3.0, **PIPE)
    args = [_t(p[n]) for n in ("x", "wr", "w1", "w3", "w2")]
    dcomm.pipe_geometry.cache_clear()
    for _ in range(3):
        fusco.moe_shuffle_ffn(*args, ExpertPlacement(E, 1, 1), cfg, K)
    assert len(calls) == 1
