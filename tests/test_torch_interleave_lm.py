"""The port's interleaved micro-batch lanes through the models and the
entry points, against the JAX package: the reduced ``moe-ffn-stream`` and
``moe-tx-stream`` (2 layers, d 64, 8 experts, top-2) with
``make_context(moe_interleave=2)``, both layers in one streamed
``fused_pipe`` block at 2 slices, in float32 on the CPU.

Against the reference (``jax.value_and_grad(lm_loss)``, ``make_train_step``,
``prefill`` and ``decode_step`` on a (1, 1) mesh): ``lm_loss`` with every
gradient leaf and the traffic state (observed once a layer over both
lanes), the train step whose two accumulation micro-batches are the
stream's lanes (``steps.accum_fuses_into_stream``: one loss call, the joint
token-mean, the traffic threaded), and the prefill and three decode steps.
``accum_fuses_into_stream``'s truth table against the reference's.  Then
the port alone, as the reference's own cases (``tests/test_models_smoke.py``,
``test_serving.py``, ``test_serving_continuous.py``, ``test_traffic.py``):
``train.run`` and ``serve.run`` with ``--moe-interleave 2``, the waved
engine padding a wave to the lanes, the continuous engine admitting a lane
a row.  Capacity factor 8: no row dropped.  Tolerances: 1e-5 relative to
each leaf's max(1, |x|) for the loss, the gradients, the step and the
traffic EMAs, counts exactly, 1e-4 on logits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_adam import check_step
from repro.compat import make_mesh
from repro.configs import get_arch as jget_arch
from repro.core import traffic as jtraffic
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.models import zoo as jzoo
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core import traffic
from repro_torch.data import pipeline
from repro_torch.launch import serve, steps, train
from repro_torch.models import lm, zoo
from repro_torch.optim import adamw
from repro_torch.serving.engine import ContinuousServingEngine, ServingEngine

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

ARCHS = {"moe_ffn": "moe-ffn-stream", "moe_tx": "moe-tx-stream"}
LANES = 2
STREAM = dict(engine="fused_pipe", moe_stream=2, pipe_slices=2,
              capacity_factor=8.0)
TOL = 1e-5
TOL_MODEL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
COUNTS = ("last_expert_count", "steps")
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}


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
    for name in traffic.TrafficState._fields:
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.shape == w.shape, (what, name)
        if name in COUNTS:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")
        else:
            _close(g, w, f"{what} {name}")


def _jax_ctx(family, **kw):
    """The reference's context on a (1, 1) mesh in float32, without its
    rematerialisation (it changes what the backward keeps, not what it
    computes)."""
    mesh = make_mesh((1, 1), ("data", "model"))
    cfg = jget_arch(ARCHS[family]).reduced()
    return cfg, mesh, dataclasses.replace(
        jlm.make_context(cfg, mesh, multi_pod=False, **kw),
        compute_dtype=jnp.float32, remat=False)


def _port_ctx(family, **kw):
    cfg = get_arch(ARCHS[family]).reduced()
    return cfg, lm.make_context(cfg, "cpu", compute_dtype=torch.float32,
                                **kw)


def _batch(vocab, b=2, s=16, seed=0):
    """Row 0 has three positions without a label: the two micro-batches
    (one row each) hold unequal counts, so the joint token-mean differs
    from the mean of the per-micro means."""
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    toks = toks.astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


def _state(cfg):
    return traffic.init_traffic_state(cfg.moe.n_experts, 1,
                                      n_layers=cfg.n_layers)


@pytest.fixture(scope="module", params=list(ARCHS))
def jax_model(request):
    """JAX at ``moe_interleave=2``: loss, every gradient and the new
    traffic state from a cold one, and one ``make_train_step(accum=2)``
    (its micro-batches the stream's lanes) threading it, in one program."""
    family = request.param
    cfg, mesh, ctx = _jax_ctx(family, moe_interleave=LANES, **STREAM)
    bundle = jzoo.build(cfg, ctx)
    assert jsteps.accum_fuses_into_stream(bundle, LANES)
    params = jax.tree.map(np.asarray, jlm.init_params(
        cfg, jax.random.PRNGKey(1), ctx, dtype=jnp.float32))
    batch = _batch(cfg.vocab)
    jb = jax.tree.map(jnp.asarray, batch)
    tr0 = jtraffic.init_traffic_state(cfg.moe.n_experts, 1,
                                      n_layers=cfg.n_layers)
    value_and_grad = jax.value_and_grad(
        lambda p, b, tr: jlm.lm_loss(p, b, ctx, traffic=tr), has_aux=True)
    train_step = jsteps.make_train_step(bundle, jadamw.AdamWConfig(**OPT),
                                        accum=LANES)

    def both(p, b, tr):
        return value_and_grad(p, b, tr), train_step(p, jadamw.init(p), b, tr)

    with mesh:
        ((loss, m), grads), (new_params, opt, sm) = jax.jit(both).lower(
            params, jb, tr0).compile(FAST)(params, jb, tr0)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return dict(family=family, params=params, batch=batch, loss=float(loss),
                grads=to_np(grads), traffic=to_np(m["traffic"]),
                new_params=to_np(new_params), mu=to_np(opt.mu),
                nu=to_np(opt.nu), master=to_np(opt.master),
                step_loss=float(sm["loss"]), grad_norm=float(sm["grad_norm"]),
                step_traffic=to_np(sm["traffic"]))


def _port_model(want, interleave=LANES):
    cfg, ctx = _port_ctx(want["family"], moe_interleave=interleave, **STREAM)
    return (cfg, ctx, convert.params_from_jax(want["params"], device="cpu"),
            pipeline.to_device(want["batch"], "cpu"))


def test_lm_loss_grads_and_traffic_at_two_lanes_match_jax(jax_model):
    """The loss, every gradient leaf (each lane's deferred tails carry their
    cotangents home) and the traffic state: one observation a layer, every
    token of both lanes counted once."""
    cfg, ctx, params, batch = _port_model(jax_model)
    leaves = adamw.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = lm.lm_loss(params, batch, ctx, traffic=_state(cfg))
    _close(loss, jax_model["loss"], "loss")
    _check_state(metrics["traffic"], jax_model["traffic"], "traffic")
    tr = metrics["traffic"]
    assert tr.steps.tolist() == [1] * cfg.n_layers
    assert tr.last_expert_count.sum(-1).tolist() == (
        [2 * 16 * cfg.moe.top_k] * cfg.n_layers)
    grads = _flat(adamw.unflatten(params, torch.autograd.grad(loss, leaves)))
    want = _flat(jax_model["grads"])
    assert grads.keys() == want.keys()
    for k in want:
        _close(grads[k], want[k], k)


def test_accumulation_fused_into_the_lanes_matches_jax_step(jax_model):
    """``make_train_step(accum=2)`` at two lanes: one loss call over the
    whole batch with the traffic threaded, its loss the joint token-mean
    (the micro-batches hold unequal label counts, and the serial mean of
    per-micro means differs), the clip norm, params, AdamW state and
    traffic against the reference's step."""
    cfg, ctx, params, batch = _port_model(jax_model)
    model = zoo.build(cfg, ctx)
    assert steps.accum_fuses_into_stream(model, LANES)
    step = steps.make_train_step(model, adamw.AdamWConfig(**OPT), LANES)
    new, opt, metrics = step(params, steps.init_state(model, params), batch,
                             _state(cfg))
    _close(metrics["loss"], jax_model["step_loss"], "loss")
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               jax_model["grad_norm"], rtol=TOL)
    _check_state(metrics["traffic"], jax_model["step_traffic"], "traffic")
    cfg = adamw.AdamWConfig(**OPT)
    check_step(new, opt, jax_model, cfg, adamw.schedule(cfg, 1), _close)
    # the serial step (one lane) takes the mean of the per-micro means
    cfg, ctx, params, batch = _port_model(jax_model, interleave=1)
    serial = steps.value_and_grad(zoo.build(cfg, ctx), LANES)
    loss, _, _ = serial(params, batch)
    assert abs(float(loss) - jax_model["step_loss"]) > 1e-3


@pytest.mark.parametrize("family", list(ARCHS))
def test_prefill_and_decode_at_two_lanes_match_jax(family):
    """The prefill's logits and traffic state (moe_tx: its k/v cache, lane
    j's rows written at [j b/K, (j+1) b/K), read by the decode steps), then
    three decode steps fed the same tokens."""
    cfg_j, mesh, ctx_j = _jax_ctx(family, moe_interleave=LANES, **STREAM)
    params_np = jax.tree.map(np.asarray, jlm.init_params(
        cfg_j, jax.random.PRNGKey(2), ctx_j, dtype=jnp.float32))
    rng = np.random.default_rng(9)
    b, s, max_len = 4, 8, 12
    tokens = rng.integers(0, cfg_j.vocab, (b, s)).astype(np.int32)
    feeds = rng.integers(0, cfg_j.vocab, (3, b)).astype(np.int32)
    tr0 = jtraffic.init_traffic_state(cfg_j.moe.n_experts, 1,
                                      n_layers=cfg_j.n_layers)
    with mesh:
        pj = jax.tree.map(jnp.asarray, params_np)
        logits, state, tr = jax.jit(lambda p, t, tr: jlm.prefill(
            p, t, jnp.arange(s), ctx_j, max_len, traffic=tr))(
                pj, jnp.asarray(tokens), tr0)
        want = [np.asarray(logits)]
        decode = jax.jit(lambda p, st, t: jlm.decode_step(p, st, t, ctx_j,
                                                          max_len))
        for tok in feeds:
            logits, state = decode(pj, state, jnp.asarray(tok))
            want.append(np.asarray(logits))

    cfg, ctx = _port_ctx(family, moe_interleave=LANES, **STREAM)
    params = convert.params_from_jax(params_np, device="cpu")
    logits, st, new_tr = lm.prefill(
        params, torch.from_numpy(tokens).long(), torch.arange(s), ctx,
        max_len, traffic=_state(cfg))
    _check_state(new_tr, jax.tree.map(np.asarray, tr), "prefill traffic")
    assert new_tr.steps.tolist() == [1] * cfg.n_layers
    got = [logits]
    for tok in feeds:
        logits, st = lm.decode_step(params, st, torch.from_numpy(tok).long(),
                                    ctx, max_len)
        got.append(logits)
    for i, (a, w) in enumerate(zip(got, want, strict=True)):
        _close(a, w, f"logits {i}", TOL_MODEL)


def test_accum_fuses_into_stream_is_the_references():
    """Over every family, engine, lane count and accumulation: fused only
    for a moe_ffn or moe_tx stack on fused_pipe whose lanes equal
    ``accum`` > 1."""
    mesh = make_mesh((1, 1), ("data", "model"))
    for arch in ("qwen3-moe-30b-a3b", "moe-tx-stream", "moe-ffn-stream",
                 "qwen3-1.7b"):
        cfg_j, cfg = jget_arch(arch).reduced(), get_arch(arch).reduced()
        for engine in ("fused_flat", "fused_pipe"):
            for k in (1, 2):
                kw = dict(engine=engine, moe_interleave=k)
                ref = jzoo.build(cfg_j, jlm.make_context(
                    cfg_j, mesh, multi_pod=False, **kw))
                mine = zoo.build(cfg, lm.make_context(cfg, "cpu", **kw))
                assert mine.ctx.moe_interleave == k
                for accum in (1, 2, 3):
                    assert (steps.accum_fuses_into_stream(mine, accum)
                            == jsteps.accum_fuses_into_stream(ref, accum)), (
                        arch, engine, k, accum)


def test_train_run_fuses_the_accumulation_into_the_lanes(monkeypatch):
    """``train.run --moe-interleave 2 --accum 2`` through fused_pipe threads
    the traffic state through every step and hands each data rank its plain
    rows (``shard_batch`` at accum 1); through fused_flat the accumulation
    is serial (accum 2, no traffic; each micro-batch of 2 rows splits into
    the lanes, which the barriers ignore).  The first loss is ``lm_loss`` of the
    whole batch: the joint token-mean."""
    seen = []
    shard = train.shard_batch

    def recording(host, dp, d, accum=1, seq_migrate=False):
        seen.append(accum)
        return shard(host, dp, d, accum, seq_migrate)

    monkeypatch.setattr(train, "shard_batch", recording)
    base = ["--reduced", "--steps", "3", "--seq", "16", "--moe-interleave",
            "2", "--accum", "2"]
    for arch in ARCHS.values():
        argv = ["--arch", arch, "--engine", "fused_pipe", "--moe-stream",
                "2", "--batch", "2"] + base
        out = train.run(train.parse_args(argv), device="cpu")
        assert np.isfinite(out["losses"]).all()
        assert out["traffic"].steps.tolist() == [3] * out["cfg"].n_layers
        assert seen[-3:] == [1] * 3
        s = train.setup(train.parse_args(argv), device="cpu")
        with torch.no_grad():
            loss, _ = lm.lm_loss(s.params, pipeline.to_device(
                s.source.batch_at(0), "cpu"), s.ctx)
        assert float(loss) == out["losses"][0]
    out = train.run(train.parse_args(["--arch", ARCHS["moe_ffn"], "--engine",
                                      "fused_flat", "--batch", "4"] + base),
                    device="cpu")
    assert out["traffic"] is None and seen[-3:] == [2] * 3
    rows = train.data_rows(8, 2, 1)
    assert rows.tolist() == [4, 5, 6, 7]
    assert train.data_rows(8, 2, 1, accum=2).tolist() == [2, 3, 6, 7]


def test_serve_run_takes_the_lanes_and_refuses_what_they_do_not_divide():
    for arch in ARCHS.values():
        argv = ["--arch", arch, "--reduced", "--engine", "fused_pipe",
                "--moe-stream", "2", "--moe-interleave", "2", "--prompt-len",
                "8", "--gen", "3"]
        sv = serve.run(serve.parse_args(argv + ["--requests", "4"]),
                       device="cpu")
        assert sv["tokens"].shape == (4, 3)
        vocab = sv["cfg"].vocab
        assert bool(((sv["tokens"] >= 0) & (sv["tokens"] < vocab)).all())
        with pytest.raises(SystemExit):
            serve.parse_args(argv + ["--requests", "3"])


def _bundle(family):
    cfg, ctx = _port_ctx(family, moe_interleave=LANES, node_size=1, **STREAM)
    bundle = zoo.build(cfg, ctx)
    return bundle, bundle.init(torch.Generator().manual_seed(0),
                               torch.float32)


@pytest.mark.parametrize("family", list(ARCHS))
def test_waved_engine_pads_each_wave_to_the_lanes(family):
    """Five requests through waves of at most 3: the first wave of 3 is
    prefilled as 4 rows (a pad row fills the second lane), the second as
    2; results for the real requests only; the traffic state observed once
    a layer per wave, and each wave's counts those of its real tokens."""
    bundle, params = _bundle(family)
    cfg = bundle.cfg
    eng = ServingEngine(bundle, max_batch=3, max_len=48, track_traffic=True)
    assert eng.interleave == LANES
    rng = np.random.default_rng(0)
    for i in range(5):
        eng.submit(rng.integers(0, cfg.vocab, (8 + i,)), max_new=3)
    done1 = eng.run_wave(params)
    done2 = eng.run_wave(params)
    assert len(done1) == 3 and len(done2) == 2
    assert sorted(eng._prefill_exec) == [(2, 16), (4, 16)]
    for req in eng.finished:
        assert req.done and req.ttft_s is not None
        assert len(req.output) == req.max_new
        assert all(0 <= t < cfg.vocab for t in req.output)
    assert eng.traffic.steps.tolist() == [2] * cfg.n_layers
    for wave, load in zip((done1, done2), eng.wave_loads, strict=True):
        real = sum(len(r.prompt) for r in wave)
        assert load["expert_tokens"].sum() == real * cfg.moe.top_k * cfg.n_layers


@pytest.mark.parametrize("family", list(ARCHS))
def test_continuous_engine_admits_a_lane_a_row(family):
    """``admit_chunk`` is the lane count; six requests on bucket boundaries
    through a pool of 4 give the streams of the batch-1 waved oracle (each
    request alone, its lane beside a pad row); the admissions pair requests
    of one bucket, as left padding changes what moe_tx's attention reads;
    no callable is built after ``warmup()``; a pool the lanes do not
    divide is refused."""
    bundle, params = _bundle(family)
    cfg = bundle.cfg
    buckets = (16, 32)
    eng = ContinuousServingEngine(bundle, max_batch=4, max_len=40,
                                  buckets=buckets, track_traffic=True)
    assert eng.admit_chunk == LANES
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (16, 16, 32, 32, 16, 16)]
    max_new = [2 + i % 3 for i in range(len(prompts))]
    eng.warmup(params)
    built = eng.compile_count
    assert built == len(buckets) + 2
    for p, n in zip(prompts, max_new):
        eng.submit(p, max_new=n)
    eng.run(params)
    assert eng.compile_count == built
    got = {r.rid: r.output for r in eng.finished}
    for i, (p, n) in enumerate(zip(prompts, max_new)):
        alone = ServingEngine(bundle, max_batch=1, max_len=40,
                              buckets=buckets)
        alone.submit(p, max_new=n)
        assert got[i] == list(alone.run_wave(params)[0].output), i
    with pytest.raises(ValueError, match="multiple of the interleave"):
        ContinuousServingEngine(bundle, max_batch=3, max_len=40)
