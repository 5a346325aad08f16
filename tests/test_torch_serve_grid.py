"""Serving over a (data, model) grid against the JAX package: the port's
``lm.prefill`` / ``decode_step``, both serving engines and
``launch/serve.run`` on four gloo ranks of a (2, 2) grid
(``launch.mesh.make_host_mesh(2, 2)``), each rank against the reference on
a (2, 2) mesh of four forced host devices.

The reference runs in one subprocess (``conftest.run_devices``) while the
port's four ranks run (``mp.spawn``, a ``file://`` rendezvous under
``tmp_path``), both on the same float32 parameters of the reduced
qwen3-moe, drawn here from ``PRNGKey(0)`` by the reference's
``init_params`` (expert leaves over the grid's two EP lanes); each rank
takes its lane (and, under FSDP of the experts, its slice of their f dim)
through ``convert.params_from_jax`` and ``lm.shard_params``.  Each data
rank serves its block of the batch rows, so a grid run routes each data
shard's rows alone: where a capacity drops tokens that is another function
than one rank's, and the oracle is the reference on the same grid.

Tolerances: streams, ``last_expert_count``, ``steps`` and ``wave_loads``
exact; the traffic EMAs within 1e-5; logits within 1e-4 (float32 sums in
another order across two layers and the vocabulary projection).
"""

import concurrent.futures
import dataclasses
import datetime
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from conftest import run_devices
from repro.compat import make_mesh
from repro.configs import get_arch as jget_arch
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core import traffic
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lm, zoo
from repro_torch.serving.engine import ContinuousServingEngine, ServingEngine

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

ARCH = "qwen3-moe-30b-a3b"
SHAPE = (2, 2)
WORLD = SHAPE[0] * SHAPE[1]
TOL = 1e-4
TOL_EMA = 1e-5
BUCKETS = (16,)
MAX_LEN = 24
LENS = (16, 11, 16, 9, 13)       # one bucket: left-padded to 16
MAX_NEW = (3, 5, 2, 4, 3)
MAX_BATCH = 4                    # two slots a data rank
CF = 8.0                         # no token dropped on either side
CF_DROP = 1.0                    # tokens dropped: a grid is another function
# the engine cases: (name, engine, capacity factor, fsdp_experts, waved too)
CASES = (("flat", "fused_flat", CF, False, True),
         ("hier", "fused_hier", CF, False, True),
         ("drop", "fused_flat", CF_DROP, False, False),
         ("fsdp", "fused_hier", CF, True, False))
FEED = (5, 77, 200, 31)          # decode_step at B = 1: the tokens fed
SERVE = ["--arch", ARCH, "--reduced", "--requests", "4", "--prompt-len", "8",
         "--gen", "3"]
FIELDS = traffic.TrafficState._fields


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _nest(d: dict, prefix: str) -> dict:
    tree = {}
    for k, v in d.items():
        if not k.startswith(prefix):
            continue
        node = tree
        *path, leaf = k[len(prefix):].split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def _prompts(vocab: int):
    rng = np.random.default_rng(4)
    return [rng.integers(0, vocab, n) for n in LENS]


def _prefill_batch(prompts):
    """The first four prompts left-padded to 16: tokens and the pad mask."""
    toks = np.zeros((4, 16), np.int64)
    valid = np.zeros((4, 16), bool)
    for i, p in enumerate(prompts[:4]):
        toks[i, 16 - len(p):] = p
        valid[i, 16 - len(p):] = True
    return toks, valid


JAX_CODE = r"""
import os
os.environ["XLA_FLAGS"] += (" --xla_backend_optimization_level=0"
                            " --xla_llvm_disable_expensive_passes=true")
import dataclasses, json
import numpy as np, jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.configs import get_arch
from repro.core import traffic
from repro.models import lm, zoo
from repro.serving.engine import ContinuousServingEngine, ServingEngine

CASES, LENS, MAX_NEW, FEED = {cases!r}, {lens!r}, {max_new!r}, {feed!r}
MAX_LEN, BUCKETS, MAX_BATCH, CF_DROP = {max_len}, {buckets!r}, {max_batch}, {cf_drop}
d = np.load({data!r})


def nest(prefix):
    tree = {{}}
    for k in d.files:
        if not k.startswith(prefix):
            continue
        node = tree
        *path, leaf = k[len(prefix):].split("/")
        for part in path:
            node = node.setdefault(part, {{}})
        node[leaf] = jnp.asarray(d[k])
    return tree


def lanes(tree, ep):
    moe = tree["layers"]["moe"]
    new = {{w: moe[w].reshape(moe[w].shape[0], ep, -1, *moe[w].shape[3:])
           for w in ("w1", "w3", "w2")}}
    return {{**tree, "layers": {{**tree["layers"], "moe": {{**moe, **new}}}}}}


def keys(x):
    return {{k: keys(v) if isinstance(v, dict) else None for k, v in x.items()}}


cfg = get_arch("{arch}").reduced()
params = nest("p/")
prompts = [d["prompt%d" % i] for i in range(len(LENS))]
meshes = {{s: make_mesh(s, ("data", "model")) for s in ((2, 2), (1, 1))}}
out = {{}}


def ctx_of(shape, engine="fused_flat", cf=8.0, fsdp=False):
    c = lm.make_context(cfg, meshes[shape], multi_pod=False, engine=engine,
                        node_size=max(1, shape[1] // 2), capacity_factor=cf)
    return dataclasses.replace(c, compute_dtype=jnp.float32,
                               fsdp_experts=fsdp)


for name, engine, cf, fsdp, waved in CASES:
    bundle = zoo.build(cfg, ctx_of((2, 2), engine, cf, fsdp))
    with meshes[2, 2]:
        for kind in ("c", "w") if waved else ("c",):
            cls = ContinuousServingEngine if kind == "c" else ServingEngine
            eng = cls(bundle, max_batch=MAX_BATCH, max_len=MAX_LEN,
                      buckets=BUCKETS, track_traffic=True)
            for p, n in zip(prompts, MAX_NEW):
                eng.submit(p, max_new=n)
            if kind == "c":
                eng.warmup(params)
                eng.run(params)
            else:
                while eng.queue:
                    eng.run_wave(params)
            c = name + "/" + kind
            got = {{q.rid: q.output for q in eng.finished}}
            out[c + "/streams"] = np.array(
                [got[i] + [-1] * (8 - len(got[i])) for i in range(len(LENS))])
            for f in traffic.TrafficState._fields:
                out[c + "/t/" + f] = np.asarray(getattr(eng.traffic, f))
            out[c + "/loads"] = np.stack(
                [w["expert_tokens"] for w in eng.wave_loads])
            out[c + "/stats"] = np.array(json.dumps(keys(eng.stats())))

# prefill of four rows with traffic, on the grid and on one device
toks, valid = jnp.asarray(d["toks"]), jnp.asarray(d["valid"])
for shape, cf in (((2, 2), 8.0), ((2, 2), CF_DROP), ((1, 1), CF_DROP)):
    ctx = ctx_of(shape, cf=cf)
    tr = traffic.init_traffic_state(cfg.moe.n_experts, shape[1],
                                    n_layers=cfg.n_layers)
    with meshes[shape]:
        logits, _, tr = jax.jit(lambda p, t, s, m: zoo.build(cfg, ctx).prefill(
            p, {{"tokens": t}}, MAX_LEN, traffic=s, traffic_mask=m))(
                lanes(params, shape[1]), toks, tr, valid)
    c = "prefill/%dx%d/%g" % (shape[0], shape[1], cf)
    out[c + "/logits"] = np.asarray(logits)
    out[c + "/counts"] = np.asarray(tr.last_expert_count)

# decode_step at B = 1 on the grid: the row replicated over the data axis
for fsdp in (False, True):
    ctx = ctx_of((2, 2), "fused_hier", fsdp=fsdp)
    with meshes[2, 2]:
        st = lm.init_decode_state(cfg, 1, MAX_LEN, jnp.float32, ctx)
        step = jax.jit(lambda p, s, t: lm.decode_step(p, s, t, ctx, MAX_LEN))
        for i, t in enumerate(FEED):
            logits, st = step(params, st, jnp.asarray([t], jnp.int32))
            out["decode/%d/%d" % (fsdp, i)] = np.asarray(logits)

# serve's lock-step batch (its parameters and prompts), fused_hier
sp = nest("s/")
ctx = ctx_of((2, 2), "fused_hier", cf=2.0)
s_toks = jnp.asarray(d["s_toks"], jnp.int32)
gen = int(d["s_gen"])
max_len = s_toks.shape[1] + gen
with meshes[2, 2]:
    prefill = jax.jit(lambda p, t: lm.prefill(p, t, jnp.arange(t.shape[1]),
                                              ctx, max_len))
    decode = jax.jit(lambda p, s, t: lm.decode_step(p, s, t, ctx, max_len))
    logits, st = prefill(sp, s_toks)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    seqs = [tok]
    for _ in range(gen - 1):
        logits, st = decode(sp, st, tok)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        seqs.append(tok)
out["serve/tokens"] = np.asarray(jnp.stack(seqs, 1))
out["serve/logits"] = np.asarray(logits)
np.savez({out!r}, **out)
print("JAX_OK")
"""


def _count_reads(log: list):
    """``torch.Tensor.cpu`` wrapped to log each call (the engines' host
    reads); returns the original to restore."""
    orig = torch.Tensor.cpu

    def cpu(self, *a, **k):
        log.append(1)
        return orig(self, *a, **k)

    torch.Tensor.cpu = cpu
    return orig


def _keys(x):
    return {k: _keys(v) if isinstance(v, dict) else None for k, v in x.items()}


def _engine_run(bundle, params, prompts, kind: str, out: dict, c: str):
    cls = ContinuousServingEngine if kind == "c" else ServingEngine
    eng = cls(bundle, max_batch=MAX_BATCH, max_len=MAX_LEN, buckets=BUCKETS,
              track_traffic=True)
    for p, n in zip(prompts, MAX_NEW):
        eng.submit(p, max_new=n)
    reads = []
    if kind == "c":
        eng.warmup(params)
        built = eng.compile_count
        orig = _count_reads(reads)
        try:
            eng.run(params)
        finally:
            torch.Tensor.cpu = orig
        out[c + "/built"] = np.array([built, eng.compile_count])
        out[c + "/reads"] = np.array([len(reads), len(eng.wave_loads),
                                      eng.decode_steps])
        out[c + "/chunk"] = np.array(eng.admit_chunk)
    else:
        while eng.queue:
            eng.run_wave(params)
    got = {q.rid: q.output for q in eng.finished}
    out[c + "/streams"] = np.array(
        [got[i] + [-1] * (8 - len(got[i])) for i in range(len(LENS))])
    for f in FIELDS:
        out[c + "/t/" + f] = getattr(eng.traffic, f).numpy().copy()
    out[c + "/loads"] = np.stack([w["expert_tokens"] for w in eng.wave_loads])
    out[c + "/stats"] = np.array(json.dumps(_keys(eng.stats())))


def _rank_main(rank, world, init_file, data, out_dir):
    """One rank: each section's arrays, or the error it raised (every rank
    raises at the same point, so the others meet no collective alone)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=240))
    try:
        mesh = make_host_mesh(*SHAPE)
        d = np.load(data)
        cfg = get_arch(ARCH).reduced()
        whole = convert.params_from_jax(_nest(d, "p/"), device="cpu")
        prompts = [d[f"prompt{i}"] for i in range(len(LENS))]
        f32 = torch.float32
        out = {}

        def ctx_of(engine="fused_flat", cf=CF, fsdp=False):
            return lm.make_context(cfg, "cpu", mesh=mesh, engine=engine,
                                   node_size=1, capacity_factor=cf,
                                   compute_dtype=f32, fsdp_experts=fsdp,
                                   explicit_tp=False, split_vocab=False)

        def section(name, fn, *args):
            try:
                fn(*args)
            except Exception as e:      # kept for the test that reads it
                out[name + "/error"] = np.array(repr(e))

        def engines(name, engine, cf, fsdp, waved):
            ctx = ctx_of(engine, cf, fsdp)
            bundle, params = zoo.build(cfg, ctx), lm.shard_params(whole, ctx)
            out[name + "/expert_shape"] = np.array(
                params["layers"]["moe"]["w1"].shape)
            for kind in ("c", "w") if waved else ("c",):
                _engine_run(bundle, params, prompts, kind, out,
                            f"{name}/{kind}")

        def prefill(cf):
            ctx = ctx_of(cf=cf)
            params = lm.shard_params(whole, ctx)
            tr = traffic.init_traffic_state(cfg.moe.n_experts, 2,
                                            n_layers=cfg.n_layers)
            with torch.inference_mode():
                logits, state, tr = lm.prefill(
                    params, torch.from_numpy(d["toks"]), torch.arange(16),
                    ctx, MAX_LEN, traffic=tr,
                    traffic_mask=torch.from_numpy(d["valid"]))
            c = f"prefill/{cf:g}"
            out[c + "/logits"] = logits.numpy().copy()
            out[c + "/counts"] = tr.last_expert_count.numpy().copy()
            out[c + "/kv_rows"] = np.array(state.kv["k"].shape[1])
            try:
                lm.prefill(params, torch.from_numpy(d["toks"][:3]),
                           torch.arange(16), ctx, MAX_LEN)
                out[c + "/odd_raises"] = np.array(False)
            except ValueError:
                out[c + "/odd_raises"] = np.array(True)

        def decode(fsdp):
            ctx = ctx_of("fused_hier", fsdp=fsdp)
            params = lm.shard_params(whole, ctx)
            st = lm.init_decode_state(cfg, 1, MAX_LEN, f32, ctx)
            with torch.inference_mode():
                for i, t in enumerate(FEED):
                    logits, st = lm.decode_step(params, st, torch.tensor([t]),
                                                ctx, MAX_LEN)
                    out[f"decode/{int(fsdp)}/{i}"] = logits.numpy().copy()

        def serve_run():
            # serve.run's lock-step batch on the grid, the context's compute
            # dtype float32 (its parameters stay bf16 values), so that the
            # greedy tokens are one function's on both sides
            make, seen = lm.make_context, []

            def f32_context(*a, **k):
                ctx = make(*a, **{**k, "compute_dtype": f32})
                seen.append((ctx.dcfg.node_size, ctx.fsdp_experts))
                return ctx

            lm.make_context = f32_context
            try:
                sv = serve.run(serve.parse_args(SERVE), device="cpu",
                               mesh=mesh)
                # the reference's node size at a model group of four
                serve.setup(serve.parse_args(SERVE), "cpu",
                            make_host_mesh(1, 4))
                try:
                    # two lanes x two data ranks do not divide two requests
                    serve.setup(serve.parse_args(SERVE[:3] + [
                        "--requests", "2", "--moe-interleave", "2"]), "cpu",
                        mesh)
                    out["serve/odd_raises"] = np.array(False)
                except ValueError:
                    out["serve/odd_raises"] = np.array(True)
            finally:
                lm.make_context = make
            out["serve/tokens"] = sv["tokens"].numpy().copy()
            out["serve/logits"] = sv["logits"].numpy().copy()
            out["serve/contexts"] = np.array(seen)

        for case in CASES:
            section(case[0], engines, *case)
        for cf in (CF, CF_DROP):
            section(f"prefill/{cf:g}", prefill, cf)
        for fsdp in (False, True):
            section(f"decode/{int(fsdp)}", decode, fsdp)
        section("serve", serve_run)
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """The reference's arrays and each rank's, from one subprocess and one
    spawn of four ranks running at once."""
    tmp = tmp_path_factory.mktemp("serve_grid")
    cfg_j = jget_arch(ARCH).reduced()
    mesh = make_mesh((1, 1), ("data", "model"))
    ctx_j = jlm.make_context(cfg_j, mesh, multi_pod=False, node_size=1)
    ctx_j = dataclasses.replace(ctx_j, placement=dataclasses.replace(
        ctx_j.placement, ep=SHAPE[1], node_size=1))
    params = jax.tree.map(np.asarray, jlm.init_params(
        cfg_j, jax.random.PRNGKey(0), ctx_j, dtype=jnp.float32))
    prompts = _prompts(cfg_j.vocab)
    toks, valid = _prefill_batch(prompts)
    # serve.run's parameters and prompts, drawn by its setup at one rank
    s = serve.setup(serve.parse_args(SERVE), "cpu")
    s_params = {k: v.float().numpy() for k, v in _flat(s.params).items()}
    moe = {k: v for k, v in s_params.items() if k.startswith("layers/moe/w")}
    for k, v in moe.items():     # the grid's two EP lanes, lane-major
        s_params[k] = v.reshape(v.shape[0], SHAPE[1], -1, *v.shape[3:])
    data = str(tmp / "data.npz")
    np.savez(data, toks=toks, valid=valid, s_toks=s.tokens.numpy(),
             s_gen=s.max_len - s.tokens.shape[1],
             **{f"prompt{i}": p for i, p in enumerate(prompts)},
             **{"p/" + k: v for k, v in _flat(params).items()},
             **{"s/" + k: v for k, v in s_params.items()})
    code = JAX_CODE.format(
        cases=CASES, lens=LENS, max_new=MAX_NEW, feed=FEED, max_len=MAX_LEN,
        buckets=BUCKETS, max_batch=MAX_BATCH, cf_drop=CF_DROP, data=data,
        arch=ARCH, out=str(tmp / "jax.npz"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(run_devices, code, WORLD, 600)
        mp.spawn(_rank_main, args=(WORLD, str(tmp / "rendezvous"), data,
                                   str(tmp)), nprocs=WORLD, join=True)
        assert "JAX_OK" in jax_run.result()
    want = dict(np.load(tmp / "jax.npz"))
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    return want, ranks


def _ok(got: dict, section: str) -> None:
    """Fail with the error a rank's section raised, if it raised one."""
    assert section + "/error" not in got, str(got[section + "/error"])


def _rows(r: int, b: int) -> slice:
    """Data rank r // model's block of a batch of b."""
    k = b // SHAPE[0]
    d = r // SHAPE[1]
    return slice(d * k, (d + 1) * k)


ENGINE_RUNS = [(name, kind) for name, _, _, _, waved in CASES
               for kind in (("c", "w") if waved else ("c",))]


@pytest.mark.parametrize("name,kind", ENGINE_RUNS)
def test_engines_give_the_reference_grid_streams_and_traffic(grid, name,
                                                             kind):
    """Both engines (c: continuous, pool of 4 split 2 a data rank, chunks
    of 2; w: waved, waves of 4 and 1 padded to 2) through fused_flat and
    fused_hier, with FSDP of the experts (fsdp) and where tokens drop
    (drop): every rank gives the reference's (2, 2) token streams per
    request, its counts, steps and wave loads exactly, its EMAs within
    1e-5 and its ``stats()`` keys; all ranks hold the same traffic bits."""
    want, ranks = grid
    c = f"{name}/{kind}"
    for r, got in enumerate(ranks):
        _ok(got, name)
        np.testing.assert_array_equal(got[c + "/streams"],
                                      want[c + "/streams"], err_msg=f"{r}")
        for f in FIELDS:
            g, w = got[c + "/t/" + f], want[c + "/t/" + f]
            if f in ("last_expert_count", "steps"):
                np.testing.assert_array_equal(g, w, err_msg=f"{r} {f}")
            else:
                np.testing.assert_allclose(g, w, rtol=TOL_EMA, atol=TOL_EMA,
                                           err_msg=f"{r} {f}")
            np.testing.assert_array_equal(g, ranks[0][c + "/t/" + f])
        np.testing.assert_array_equal(got[c + "/loads"], want[c + "/loads"])
        assert str(got[c + "/stats"]) == str(want[c + "/stats"])


def test_a_grid_that_drops_tokens_is_the_reference_grid_not_one_rank(grid):
    """At capacity factor 1 the reference's (2, 2) prefill logits differ
    from its one-device ones (each data shard routes its rows alone), and
    every rank's rows of the port's equal its (2, 2) ones within 1e-4, as
    they do at capacity factor 8."""
    want, ranks = grid
    drop = f"{CF_DROP:g}"
    apart = np.abs(want[f"prefill/2x2/{drop}/logits"]
                   - want[f"prefill/1x1/{drop}/logits"]).max()
    assert apart > 1e-2
    for r, got in enumerate(ranks):
        for cf in (f"{CF:g}", drop):
            _ok(got, f"prefill/{cf}")
            np.testing.assert_allclose(
                got[f"prefill/{cf}/logits"],
                want[f"prefill/2x2/{cf}/logits"][_rows(r, 4)],
                rtol=TOL, atol=TOL, err_msg=f"rank {r} cf {cf}")


def test_prefill_counts_each_row_once_over_the_grid(grid):
    """Each rank prefills its data rank's two rows of the four (its logits
    and caches hold two), and the traffic counts, summed over the grid,
    are the reference's: each row counted once, not once a data rank."""
    want, ranks = grid
    for r, got in enumerate(ranks):
        for cf in (CF, CF_DROP):
            c = f"prefill/{cf:g}"
            _ok(got, c)
            counts = want[f"prefill/2x2/{cf:g}/counts"]
            assert got[c + "/counts"].sum() == counts.sum() == 4 * 16 * 2 * 2 - (
                2 * 2 * (16 - np.array(LENS[:4])).sum())
            np.testing.assert_array_equal(got[c + "/counts"], counts)
            assert got[c + "/logits"].shape[0] == 2
            assert int(got[c + "/kv_rows"]) == 2


def test_prefill_refuses_a_batch_the_data_ranks_do_not_split(grid):
    _, ranks = grid
    for got in ranks:
        _ok(got, f"prefill/{CF:g}")
        _ok(got, "serve")
        assert bool(got[f"prefill/{CF:g}/odd_raises"])
        assert bool(got["serve/odd_raises"])


@pytest.mark.parametrize("fsdp", [0, 1])
def test_decode_step_at_one_row_replicates_it_over_the_data_ranks(grid,
                                                                   fsdp):
    """``decode_step`` from an empty state at B = 1, which the two data
    ranks do not split: each computes the row (with FSDP, gathering the
    expert weights over the data group at every layer), its logits within
    1e-4 of the reference's at every step."""
    want, ranks = grid
    for r, got in enumerate(ranks):
        _ok(got, f"decode/{fsdp}")
        for i in range(len(FEED)):
            np.testing.assert_allclose(got[f"decode/{fsdp}/{i}"],
                                       want[f"decode/{fsdp}/{i}"], rtol=TOL,
                                       atol=TOL, err_msg=f"rank {r} step {i}")


def test_continuous_engine_on_the_grid_builds_nothing_after_warmup(grid):
    """The continuous engine's admission chunk is the two data ranks' one
    row each, ``compile_count`` stays flat after ``warmup()``, and the host
    reads the card once per admission and once per decode step; with FSDP
    each rank holds its half of its lane's expert f dim."""
    _, ranks = grid
    for got in ranks:
        for name, *_ in CASES:
            _ok(got, name)
            built, after = got[f"{name}/c/built"]
            assert built == after
            reads, admissions, steps = got[f"{name}/c/reads"]
            assert reads == admissions + steps and admissions > 0
            assert int(got[f"{name}/c/chunk"]) == SHAPE[0]
        assert got["fsdp/expert_shape"][-1] * 2 == got["flat/expert_shape"][-1]
        assert got["flat/expert_shape"][1] == 1


def test_serve_run_on_the_grid_gives_the_reference_lock_step_tokens(grid):
    """``serve.run(args, device="cpu", mesh=make_host_mesh(2, 2))``: every
    rank returns the whole batch's tokens, those of the reference's
    lock-step prefill and decode on a (2, 2) mesh, and its last logits
    within 1e-4; its context takes the reference's node size,
    max(1, model // 2) (1 on (2, 2), 2 on (1, 4)), and the reference's FSDP
    rule (off at the reduced size)."""
    want, ranks = grid
    for r, got in enumerate(ranks):
        _ok(got, "serve")
        np.testing.assert_array_equal(got["serve/tokens"],
                                      want["serve/tokens"], err_msg=f"{r}")
        np.testing.assert_allclose(got["serve/logits"], want["serve/logits"],
                                   rtol=TOL, atol=TOL)
        assert got["serve/contexts"].tolist()[:2] == [[1, 0], [2, 0]]
