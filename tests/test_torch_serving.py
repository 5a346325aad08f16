"""The port's serving engines and per-row decode against the JAX package:
``serving/engine.ContinuousServingEngine`` and ``ServingEngine``, and
``models/lm.decode_step`` over a slot pool with per-row lengths.

The reduced models run in float32 on the CPU (the kernels' plain versions)
from the same parameters (JAX's ``init_params``, converted leaf by leaf).
Per-row decode: logits, caches and lengths within 1e-4 (float32 sums in
another order across two layers and the vocabulary projection).  Engines:
the reference's exact greedy token lists per request, and the reference's
traffic statistics (counts exact, EMAs within 1e-5).  Counters, never
wall-clock ratios, are asserted.
"""

import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.compat import make_mesh
from repro.configs import get_arch as jget_arch
from repro.models import lm as jlm
from repro.models import zoo as jzoo
from repro.serving.engine import ContinuousServingEngine as JContinuous
from repro.serving.engine import ServingEngine as JWaved
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core import traffic
from repro_torch.models import lm, zoo
from repro_torch.serving.engine import (ContinuousServingEngine,
                                        ServingEngine, default_buckets)

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

ARCHS = {"moe": "qwen3-moe-30b-a3b", "moe_tx": "moe-tx-stream",
         "dense": "qwen3-1.7b", "moe_ffn": "moe-ffn-stream"}
TOL = 1e-4
TOL_EMA = 1e-5
BUCKETS = (16, 32)
MAX_LEN = 40
LENS = (16, 16, 32, 32, 16)      # on bucket boundaries; waves of 2 stay
                                 # bucket-homogeneous
CF = 8.0     # no capacity drops, so a wave of 2 routes each row as alone


def _jax_ctx(cfg, engine="fused_flat", **kw):
    mesh = make_mesh((1, 1), ("data", "model"))
    ctx = dataclasses.replace(
        jlm.make_context(cfg, mesh, multi_pod=False, engine=engine,
                         node_size=1, **kw), compute_dtype=jnp.float32)
    return mesh, ctx


def _port_bundle(family, engine, params_np, **kw):
    cfg = get_arch(ARCHS[family]).reduced()
    ctx = lm.make_context(cfg, "cpu", engine=engine, node_size=1,
                          compute_dtype=torch.float32, **kw)
    return zoo.build(cfg, ctx), convert.params_from_jax(params_np, device="cpu")


def serving_stream_oracle(bundle, params, prompts, *, max_new, buckets,
                          max_len, eos_id=None):
    """Batch-1 greedy token streams (the port's counterpart of
    ``tests/engine_harness.serving_stream_oracle``): each prompt alone
    through the waved engine (``max_batch=1``, the same buckets), the
    per-request ground truth any admission discipline must reproduce under
    greedy argmax for prompts on bucket boundaries."""
    streams = []
    for p, n in zip(prompts, max_new):
        eng = ServingEngine(bundle, max_batch=1, max_len=max_len,
                            eos_id=eos_id, buckets=tuple(buckets))
        eng.submit(p, max_new=n)
        streams.append(list(eng.run_wave(params)[0].output))
    return streams


# ----------------------------------------------------- per-row decode ----

@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("family", ["moe", "moe_tx"])
def test_per_row_decode_matches_jax(family, window):
    """A 4-slot pool from prefills at 8, 16 and 10 tokens, inserted with
    the reference's ``ContinuousServingEngine._insert_fn`` on the JAX side
    and the port's on its own, slot 2 left free at length 0; then three
    decode steps of the whole pool, both fed the same tokens.  window 4
    (shorter than every prompt) wraps each row's ring at its own step: the
    10-token row writes ring slot 2 first, the others slot 0."""
    cfg_j = dataclasses.replace(jget_arch(ARCHS[family]).reduced(),
                                window=window)
    cfg = dataclasses.replace(get_arch(ARCHS[family]).reduced(), window=window)
    mesh, ctx_j = _jax_ctx(cfg_j)
    params_j = jlm.init_params(cfg_j, jax.random.PRNGKey(0), ctx_j,
                               dtype=jnp.float32)
    rng = np.random.default_rng(7)
    prompts = {0: rng.integers(0, cfg.vocab, 8), 1: rng.integers(0, cfg.vocab, 16),
               3: rng.integers(0, cfg.vocab, 10)}
    max_len = 24
    feeds = rng.integers(0, cfg.vocab, (3, 4))
    with mesh:
        prefill = jax.jit(lambda p, t: jlm.prefill(
            p, t, jnp.arange(t.shape[1]), ctx_j, max_len))
        decode = jax.jit(lambda p, st, t: jlm.decode_step(p, st, t, ctx_j,
                                                          max_len))
        pool_j = jlm.init_decode_state(cfg_j, 4, max_len, jnp.float32, ctx_j,
                                       per_slot=True)
        for slot, p in prompts.items():
            _, new = prefill(params_j, jnp.asarray(p[None], jnp.int32))
            pool_j = JContinuous._insert_fn(pool_j, new,
                                            jnp.asarray([slot], jnp.int32))
        want = []
        for tok in feeds:
            logits, pool_j = decode(params_j, pool_j,
                                    jnp.asarray(tok, jnp.int32))
            want.append((np.asarray(logits), jax.tree.map(np.asarray, pool_j.kv),
                         np.asarray(pool_j.length)))

    ctx = lm.make_context(cfg, "cpu", engine="fused_flat", node_size=1,
                          compute_dtype=torch.float32)
    params = convert.params_from_jax(jax.tree.map(np.asarray, params_j),
                                     device="cpu")
    pool = lm.init_decode_state(cfg, 4, max_len, torch.float32, ctx,
                                per_slot=True)
    for slot, p in prompts.items():
        _, new = lm.prefill(params, torch.from_numpy(p[None]), torch.arange(len(p)),
                            ctx, max_len)
        pool = ContinuousServingEngine._insert_fn(pool, new, [slot])
    np.testing.assert_array_equal(pool.length.numpy(), [8, 16, 0, 10])
    for tok, (logits_j, kv_j, len_j) in zip(feeds, want):
        logits, pool = lm.decode_step(params, pool, torch.from_numpy(tok), ctx,
                                      max_len)
        assert bool(torch.isfinite(logits).all())      # the free slot too
        np.testing.assert_allclose(logits.numpy(), logits_j, rtol=TOL, atol=TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(pool.kv[name].numpy(), kv_j[name],
                                       rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(pool.length.numpy(), len_j)
    assert pool.length.dtype == torch.int32


# ---------------------------------------------------- engine vs engine ----

def _requests(cfg):
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, n) for n in LENS]
    return prompts, [2 + i % 3 for i in range(len(LENS))]


def _drive(eng, params, prompts, max_new, waved):
    for p, n in zip(prompts, max_new):
        eng.submit(p, max_new=n)
    if waved:
        while eng.queue:
            eng.run_wave(params)
    else:
        eng.warmup(params)
        eng.run(params)
    return {q.rid: q.output for q in eng.finished}


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) else None for k, v in d.items()}


@pytest.mark.parametrize("family,engine", [("moe", "fused_flat"),
                                           ("moe", "fused_hier"),
                                           ("moe_tx", "fused_flat"),
                                           ("moe_tx", "fused_hier"),
                                           ("dense", "fused_flat"),
                                           ("moe_ffn", "fused_flat"),
                                           ("moe_ffn", "fused_pipe")])
def test_engines_match_reference_engines(family, engine):
    """Five requests on buckets 16/32 through a pool of 2 (slots retire and
    refill) with ``max_new`` 2-4, traffic tracked (the MoE families) and a
    capacity that drops nothing (else a wave's rows share capacity): the
    continuous engine gives the reference continuous engine's token list
    per request and its traffic state; the waved engine (waves of 2) the
    reference waved engine's; both equal the port's batch-1 oracle.
    ``stats()`` has the reference's keys.  moe_ffn through ``fused_pipe``
    runs both layers in one streamed block (``--moe-stream 2``); the dense
    family tracks no traffic (the reference refuses it)."""
    cfg_j = jget_arch(ARCHS[family]).reduced()
    stream = dict(moe_stream=2) if engine == "fused_pipe" else {}
    mesh, ctx_j = _jax_ctx(cfg_j, engine, capacity_factor=CF, **stream)
    bundle_j = jzoo.build(cfg_j, ctx_j)
    params_j = jax.tree.map(lambda x: x.astype(jnp.float32),
                            bundle_j.init(jax.random.PRNGKey(0)))
    prompts, max_new = _requests(cfg_j)
    kw = dict(max_batch=2, max_len=MAX_LEN, buckets=BUCKETS,
              track_traffic=family != "dense")
    with mesh:
        jc = JContinuous(bundle_j, **kw)
        want_c = _drive(jc, params_j, prompts, max_new, waved=False)
        jw = JWaved(bundle_j, **kw)
        want_w = _drive(jw, params_j, prompts, max_new, waved=True)

    bundle, params = _port_bundle(family, engine,
                                  jax.tree.map(np.asarray, params_j),
                                  capacity_factor=CF, **stream)
    pc = ContinuousServingEngine(bundle, **kw)
    got_c = _drive(pc, params, prompts, max_new, waved=False)
    pw = ServingEngine(bundle, **kw)
    got_w = _drive(pw, params, prompts, max_new, waved=True)
    oracle = serving_stream_oracle(bundle, params, prompts, max_new=max_new,
                                   buckets=BUCKETS, max_len=MAX_LEN)
    assert got_c == want_c
    assert got_w == want_w
    assert [got_c[i] for i in range(len(LENS))] == oracle
    assert [got_w[i] for i in range(len(LENS))] == oracle
    if family == "dense":
        for port, ref in ((pc, jc), (pw, jw)):
            assert port.traffic is None and not port.wave_loads
            assert _keys(port.stats()) == _keys(ref.stats())
        return
    for port, ref in ((pc, jc), (pw, jw)):
        host = traffic.TrafficState(*(x.numpy() for x in port.traffic))
        ref_tr = jax.tree.map(np.asarray, ref.traffic)
        for name in traffic.TrafficState._fields:
            g, w = getattr(host, name), getattr(ref_tr, name)
            if name in ("last_expert_count", "steps"):
                np.testing.assert_array_equal(g, w, err_msg=name)
            else:
                np.testing.assert_allclose(g, w, rtol=TOL_EMA, atol=TOL_EMA,
                                           err_msg=name)
        assert len(port.wave_loads) == len(ref.wave_loads)
        for a, b in zip(port.wave_loads, ref.wave_loads):
            np.testing.assert_array_equal(a["expert_tokens"], b["expert_tokens"])
        st, ref_st = port.stats(), ref.stats()
        assert _keys(st) == _keys(ref_st)
        assert st["comm_path"]["per_layer"] == ref_st["comm_path"]["per_layer"]
        for k in ("dense_rows", "cond_rows"):
            np.testing.assert_allclose(st["comm_path"]["dedup"][k],
                                       ref_st["comm_path"]["dedup"][k],
                                       rtol=TOL_EMA)


# ------------------------------------------------ counters, lifecycle ----

def _moe_bundle(seed=0, **kw):
    cfg = get_arch(ARCHS["moe"]).reduced()
    ctx = lm.make_context(cfg, "cpu", engine="fused_flat", node_size=1,
                          compute_dtype=torch.float32, **kw)
    bundle = zoo.build(cfg, ctx)
    return bundle, bundle.init(torch.Generator().manual_seed(seed),
                               torch.float32)


def test_compile_count_stays_flat_after_warmup():
    """warmup builds one prefill per bucket, the insert and the pool decode;
    no admission pattern whose prompts fit the buckets builds more, and
    none of it touches the traffic state or the pool."""
    bundle, params = _moe_bundle()
    eng = ContinuousServingEngine(bundle, max_batch=3, max_len=48,
                                  buckets=(8, 16, 32), track_traffic=True)
    eng.warmup(params)
    n0 = eng.compile_count
    assert n0 == 3 + 2
    assert int(eng.traffic.steps.sum()) == 0
    assert not bool(eng._state.kv["k"].any()) and not bool(eng._state.length.any())
    r = np.random.default_rng(1)
    for i in range(9):                     # lengths 3 .. 31: every bucket
        eng.submit(r.integers(0, bundle.cfg.vocab, 3 + 3 * i), max_new=1 + i % 4)
    eng.run(params)
    assert eng.compile_count == n0
    for _ in range(3):
        eng.submit(r.integers(0, bundle.cfg.vocab, 30), max_new=2)
    eng.run(params)
    assert eng.compile_count == n0
    assert len(eng.finished) == 12
    st = eng.stats()
    assert st["compile_count"] == n0 and st["waves"] == 12
    assert int(eng.traffic.steps[0]) == 12        # one observation a prefill
    assert set(default_buckets(160)) == {16, 32, 64, 128, 160}


def test_lifecycle_emit_order_max_new_one_and_eos_refill():
    """A max_new = 1 request retires at its admission without a decode step;
    ``emit`` sees each request as it retires, in ``finished``'s order; eos
    mid-decode retires the slot early and the freed slot is refilled, every
    stream being the eos-free one cut at its first eos."""
    bundle, params = _moe_bundle()
    r = np.random.default_rng(3)
    prompts = [r.integers(0, bundle.cfg.vocab, 16) for _ in range(4)]

    def run(eos_id, max_new):
        emitted = []
        eng = ContinuousServingEngine(bundle, max_batch=2, max_len=48,
                                      buckets=(16,), eos_id=eos_id,
                                      emit=emitted.append)
        eng.warmup(params)
        for p, n in zip(prompts, max_new):
            eng.submit(p, max_new=n)
        first = eng.step(params)
        eng.run(params)
        assert [q.rid for q in emitted] == [q.rid for q in eng.finished]
        return eng, first, {q.rid: q.output for q in eng.finished}

    eng, first, _ = run(None, [1, 6, 6, 6])
    # request 0 retired in the first step's admission, and requests 1 and 2
    # filled both slots in the same admission round: 5 decode steps for
    # them, then 5 for request 3
    assert [q.rid for q in first] == [0]
    assert all(q is None for q in eng.slots) and eng.decode_steps == 10
    assert eng.stats()["mean_slot_occupancy"] <= 1.0

    _, _, base = run(None, [6] * 4)
    eos = base[0][2]
    _, _, cut = run(eos, [6] * 4)
    assert len(cut) == 4                       # freed slots were refilled
    assert len(cut[0]) == 3 and cut[0][-1] == eos
    for rid, full in base.items():
        idx = full.index(eos) if eos in full else len(full) - 1
        assert cut[rid] == full[:idx + 1]


# ------------------------------------------------------------- EP = 4 ----

EP, NODE = 4, 2


def _ep_run(bundle, params, prompts, max_new):
    eng = ContinuousServingEngine(bundle, max_batch=2, max_len=MAX_LEN,
                                  buckets=BUCKETS, track_traffic=True)
    eng.warmup(params)
    for p, n in zip(prompts, max_new):
        eng.submit(p, max_new=n)
    eng.run(params)
    return ({q.rid: q.output for q in eng.finished},
            {f: getattr(eng.traffic, f).numpy()
             for f in traffic.TrafficState._fields})


def _rank_main(rank, world, init_file, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        bundle, params = _moe_bundle(capacity_factor=8.0)
        cfg = bundle.cfg
        ctx = lm.make_context(cfg, "cpu", ep_group=dist.group.WORLD,
                              engine="fused_hier", node_size=NODE,
                              capacity_factor=8.0, compute_dtype=torch.float32,
                              explicit_tp=False,     # serving: whole weights
                              split_vocab=False)
        prompts, max_new = _requests(cfg)
        streams, tr = _ep_run(zoo.build(cfg, ctx),
                              lm.shard_params(params, ctx), prompts, max_new)
        np.savez(f"{out_dir}/rank{rank}.npz",
                 streams=np.array([streams[i] + [-1] * (4 - len(streams[i]))
                                   for i in range(len(LENS))]), **tr)
    finally:
        dist.destroy_process_group()


def test_ep4_continuous_matches_ep1(tmp_path):
    """The continuous engine over one spawned gloo group of four ranks,
    ``fused_hier`` with nodes of 2, traffic tracked: every rank gives EP =
    1's token streams and expert statistics, and all ranks hold the same
    lane statistics, whose assignment total is EP = 1's.  An engine is freed
    when its last reference goes: one that held itself in a reference cycle
    (through its prepared callables) kept its model's process groups alive
    into interpreter exit, after ``destroy_process_group``, where a rank
    could abort (``terminate called without an active exception``)."""
    mp.spawn(_rank_main, args=(EP, str(tmp_path / "rendezvous"), str(tmp_path)),
             nprocs=EP, join=True)
    bundle, params = _moe_bundle(capacity_factor=8.0)
    bundle = zoo.build(bundle.cfg, lm.make_context(
        bundle.cfg, "cpu", engine="fused_hier", node_size=1,
        capacity_factor=8.0, compute_dtype=torch.float32))
    prompts, max_new = _requests(bundle.cfg)
    gc.collect()
    gc.disable()
    try:
        streams, tr = _ep_run(bundle, params, prompts, max_new)
        left = [o for o in gc.get_objects()
                if isinstance(o, ContinuousServingEngine)]
    finally:
        gc.enable()
    assert not left
    want = np.array([streams[i] + [-1] * (4 - len(streams[i]))
                     for i in range(len(LENS))])
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(EP)]
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["streams"], want, err_msg=f"rank {r}")
        np.testing.assert_array_equal(got["last_expert_count"],
                                      tr["last_expert_count"])
        np.testing.assert_array_equal(got["steps"], tr["steps"])
        np.testing.assert_allclose(got["expert_ema"], tr["expert_ema"],
                                   rtol=TOL_EMA)
        np.testing.assert_allclose(got["lane_node_ema"].sum(axis=(1, 2)),
                                   tr["lane_node_ema"].sum(axis=(1, 2)),
                                   rtol=TOL_EMA)
        for f in ("lane_send_ema", "lane_node_ema", "lane_cond_ema"):
            np.testing.assert_array_equal(got[f], ranks[0][f])
    assert ranks[0]["lane_send_ema"].any()        # cross-node rows were sent
