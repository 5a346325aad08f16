"""``parallel/pipeline`` and ``parallel/compress`` of the port against the
JAX package.

- ``pipeline_apply`` over four gloo ranks (one spawn, a ``file://``
  rendezvous) against the reference's under ``shard_map`` on four forced
  host devices (one subprocess), each side's forward and ``jax.grad`` /
  autograd of ``sum(out * c)``: the reference test's sizes (4 stages, 6
  microbatches of 2 x 8, ``tanh(x @ w)``), a 2-leaf dict stage
  (``tanh(x @ w + b)``) with 2 microbatches, fewer than the stages, and a
  2-stage group (``dist.new_group([0, 1])`` against a mesh of the first
  two devices).  The outputs on every rank within 1e-6, each stage's
  ``dw`` and every rank's ``dx`` within 1e-5, f32.  Two mutations miss:
  the output cotangent summed over the group (every ``dw`` 4x) and the
  input's cotangent not summed (ranks 1-3 get no ``dx``).
- ``quantize``, ``dequantize``, ``compress_grads`` and
  ``decompress_grads`` against ``repro.parallel.compress`` in this process,
  leaves matched by path (the port keeps insertion order, ``tree_flatten``
  sorts keys): q, the scales and the error state bit for bit, f32 and bf16,
  sizes that the block does and does not divide; the reference's error
  bound as a hypothesis property.
"""

import concurrent.futures
import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from hypothesis import given, settings
from hypothesis import strategies as st

from conftest import run_devices
from xla_prelude import PRELUDE
from repro.parallel import compress as jcompress
from repro_torch.optim import adamw
from repro_torch.parallel import compress, pipeline

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

WORLD = 4
TOL_OUT = 1e-6
TOL_GRAD = 1e-5
# (name, stages, n_micro, mb, d, leaves of the stage)
CASES = (("tanh4", 4, 6, 2, 8, ("w",)),
         ("dict4", 4, 2, 2, 8, ("w", "b")),
         ("tanh2", 2, 3, 2, 8, ("w",)))
MUTATIONS = ("cotangent_summed", "dx_unsummed")

JAX_CODE = """
import numpy as np, jax, jax.numpy as jnp
from repro.compat import make_mesh
from jax.sharding import Mesh
from repro.parallel.pipeline import pipeline_apply

d = dict(np.load({data!r}))
out = {{}}
for name, stages, leaves in {cases!r}:
    mesh = (make_mesh((4,), ("pod",)) if stages == 4
            else Mesh(np.array(jax.devices()[:stages]), ("pod",)))
    p = {{k: jnp.asarray(d[f"{{name}}/{{k}}"]) for k in leaves}}
    x, c = jnp.asarray(d[f"{{name}}/x"]), jnp.asarray(d[f"{{name}}/c"])
    stage = ((lambda p, x: jnp.tanh(x @ p["w"] + p["b"])) if "b" in leaves
             else (lambda p, x: jnp.tanh(x @ p["w"])))
    run = jax.jit(lambda p, x: pipeline_apply(stage, p, x, mesh=mesh,
                                              axis="pod"))
    y, vjp = jax.vjp(run, p, x)      # the grads of sum(y * c)
    dp, dx = vjp(c)
    ref = x
    for s in range(stages):
        ref = stage({{k: v[s] for k, v in p.items()}}, ref)
    assert float(jnp.max(jnp.abs(y - ref))) < 1e-5
    out[f"{{name}}/out"] = np.asarray(y)
    out[f"{{name}}/dx"] = np.asarray(dx)
    for k in leaves:
        out[f"{{name}}/d{{k}}"] = np.asarray(dp[k])
np.savez({out!r}, **out)
print("JAX_OK")
"""


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    f32 = lambda *s, scale=1.0: (rng.normal(0, 1, s) * scale).astype(np.float32)
    d = {}
    for name, stages, n_micro, mb, dim, leaves in CASES:
        d[f"{name}/w"] = f32(stages, dim, dim, scale=0.3)
        if "b" in leaves:
            d[f"{name}/b"] = f32(stages, dim, scale=0.3)
        d[f"{name}/x"] = f32(n_micro, mb, dim)
        d[f"{name}/c"] = f32(n_micro, mb, dim)
    return d


def _stage(p, x):
    y = x @ p["w"]
    return torch.tanh(y + p["b"] if "b" in p else y)


def _run_case(d, name, leaves, group) -> dict:
    """This rank's output, its stage's gradients and ``dx`` of one case."""
    stages = dist.get_world_size(group)
    tree = {k: torch.from_numpy(d[f"{name}/{k}"]) for k in leaves}
    p = {k: v.clone().requires_grad_() for k, v in pipeline.stage_slice(
        tree, dist.get_rank(group)).items()}
    assert all(v.shape[0] == stages for v in tree.values())
    x = torch.from_numpy(d[f"{name}/x"]).requires_grad_()
    y = pipeline.pipeline_apply(_stage, p, x, group=group)
    (y * torch.from_numpy(d[f"{name}/c"])).sum().backward()
    out = {f"{name}/out": y.detach().numpy(), f"{name}/dx": x.grad.numpy()}
    out.update({f"{name}/d{k}": v.grad.numpy() for k, v in p.items()})
    return out


def _mutated(name: str):
    """A wrong backward: the output cotangents summed over the group onto
    the last stage (a reduce to the broadcast's source), or the input's
    cotangent left on each rank."""
    last = pipeline.last_stage_cotangent
    if name == "cotangent_summed":
        return "last_stage_cotangent", lambda g, group: last(
            pipeline.summed_cotangent(g, group), group)
    return "summed_cotangent", lambda g, group: g


def _rank_main(rank, world, init_file, data, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        d = dict(np.load(data))
        pair = dist.new_group([0, 1])       # collective: every rank
        out = {}
        for name, stages, _, _, _, leaves in CASES:
            if stages == world:
                out.update(_run_case(d, name, leaves, dist.group.WORLD))
            elif rank < stages:
                out.update(_run_case(d, name, leaves, pair))
        for m in MUTATIONS:
            attr, wrong = _mutated(m)
            right = getattr(pipeline, attr)
            setattr(pipeline, attr, wrong)
            try:
                got = _run_case(d, "tanh4", ("w",), dist.group.WORLD)
            finally:
                setattr(pipeline, attr, right)
            out.update({f"{m}/{k}": v for k, v in got.items()})
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def pipe_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    data = tmp / "data.npz"
    np.savez(data, **_inputs())
    code = PRELUDE + JAX_CODE.format(
        data=str(data), out=str(tmp / "jax.npz"),
        cases=tuple((n, s, leaves) for n, s, _, _, _, leaves in CASES))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(run_devices, code, WORLD, 300)
        mp.spawn(_rank_main, args=(WORLD, str(tmp / "rendezvous"), str(data),
                                   str(tmp)), nprocs=WORLD, join=True)
        assert "JAX_OK" in jax_run.result()
    return (dict(np.load(tmp / "jax.npz")),
            [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)])


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - b).max())


def _under(got: dict, prefix: str) -> dict:
    """The arrays saved under ``prefix/``, without it."""
    return {k[len(prefix) + 1:]: v for k, v in got.items()
            if k.startswith(prefix + "/")}


def _grad_misses(want, got, name, leaves, rank) -> list[str]:
    """The gradients of ``rank`` (its stage's, its ``dx``) that miss the
    reference's beyond ``TOL_GRAD``."""
    miss = [f"d{k}" for k in leaves
            if _err(got[f"{name}/d{k}"], want[f"{name}/d{k}"][rank]) > TOL_GRAD]
    if _err(got[f"{name}/dx"], want[f"{name}/dx"]) > TOL_GRAD:
        miss.append("dx")
    return miss


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_pipeline_output_on_every_rank_matches_shard_map(pipe_run, case):
    want, ranks = pipe_run
    name, stages = case[0], case[1]
    for r in range(stages):
        assert _err(ranks[r][f"{name}/out"], want[f"{name}/out"]) <= TOL_OUT, r


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_pipeline_grads_match_jax_grad_rank_by_rank(pipe_run, case):
    """Each stage's parameter gradients and every rank's ``dx``: the
    replicated output counted once, the replicated input's gradient
    summed."""
    want, ranks = pipe_run
    name, stages, leaves = case[0], case[1], case[5]
    for r in range(stages):
        assert _grad_misses(want, ranks[r], name, leaves, r) == [], r


def test_pipeline_output_cotangent_summed_gives_four_times_dw(pipe_run):
    want, ranks = pipe_run
    for r, got in enumerate(ranks):
        g = got["cotangent_summed/tanh4/dw"]
        assert _err(g, 4 * want["tanh4/dw"][r]) <= 4 * TOL_GRAD, r
        assert "dw" in _grad_misses(want, _under(got, "cotangent_summed"),
                                    "tanh4", ("w",), r), r


def test_pipeline_dx_not_summed_leaves_ranks_1_to_3_at_zero(pipe_run):
    want, ranks = pipe_run
    for r, got in enumerate(ranks):
        dx = got["dx_unsummed/tanh4/dx"]
        if r == 0:
            assert _err(dx, want["tanh4/dx"]) <= TOL_GRAD
            continue
        assert not dx.any(), r
        assert _err(dx, want["tanh4/dx"]) > TOL_GRAD, r


def test_stage_slice_is_the_leading_dim():
    tree = {"a": torch.arange(12.).reshape(3, 4), "b": {"c": torch.ones(3, 2)}}
    s = pipeline.stage_slice(tree, 1)
    assert torch.equal(s["a"], tree["a"][1]) and s["b"]["c"].shape == (2,)


def test_pipeline_of_one_rank_is_the_stage():
    """``group`` None: one stage, no collective; the output and gradients
    of the stage on the whole batch (one product, sums in another order)."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(0, 0.3, (8, 8)).astype(np.float32))
    x = torch.from_numpy(rng.normal(0, 1, (5, 2, 8)).astype(np.float32))
    wp, xp = w.clone().requires_grad_(), x.clone().requires_grad_()
    y = pipeline.pipeline_apply(_stage, {"w": wp}, xp, group=None)
    y.sum().backward()
    ws, xs = w.clone().requires_grad_(), x.clone().requires_grad_()
    ref = torch.tanh(xs @ ws)
    ref.sum().backward()
    for got, want in ((y, ref), (wp.grad, ws.grad), (xp.grad, xs.grad)):
        assert _err(got.detach(), want.detach().numpy()) <= TOL_OUT


# ------------------------------------------------------------ compression

def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _pair(x: np.ndarray, dtype: str):
    """``x`` as a jnp and a torch array of ``dtype``."""
    if dtype == "bf16":
        return (jnp.asarray(x, jnp.bfloat16),
                torch.from_numpy(x).to(torch.bfloat16))
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("dtype", ("f32", "bf16"))
@pytest.mark.parametrize("n,block", ((1024, 256), (300, 64), (1000, 256),
                                     (12295, 256), (64, 64), (5, 256)))
def test_quantize_bit_equal_to_the_reference(n, block, dtype):
    x = (np.random.default_rng(n).normal(0, 3, (n,))).astype(np.float32)
    xj, xt = _pair(x, dtype)
    qj, sj = jcompress.quantize(xj, block)
    qt, sc = compress.quantize(xt, block)
    assert qt.dtype == torch.int8 and sc.dtype == torch.float32
    assert np.array_equal(np.asarray(qj), qt.numpy())
    assert np.array_equal(_bits(sj), _bits(sc.numpy()))
    dj = jcompress.dequantize(qj, sj, xj.shape, block)
    dt = compress.dequantize(qt, sc, xt.shape, block)
    assert dt.shape == (n,)
    assert np.array_equal(_bits(dj), _bits(dt.numpy()))


def _jax_paths(tree) -> list[str]:
    return ["/".join(str(k.key) for k in p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


SHAPES = {"w": (5, 7), "a/b": (3,), "a/c": (300,)}


def test_compress_grads_error_feedback_bit_equal_over_20_steps():
    """A 3-leaf dict whose insertion order is not the sorted one, 20 steps
    of error feedback: each leaf's q, scales and error state bit for bit,
    matched by path, every step."""
    rng = np.random.default_rng(0)

    def trees(arrs):
        j = {"w": jnp.asarray(arrs["w"]),
             "a": {"c": jnp.asarray(arrs["a/c"]), "b": jnp.asarray(arrs["a/b"])}}
        t = {"w": torch.from_numpy(arrs["w"]),
             "a": {"c": torch.from_numpy(arrs["a/c"]),
                   "b": torch.from_numpy(arrs["a/b"])}}
        return j, t

    zeros = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    gj, gt = trees(zeros)
    efj, eft = jcompress.init_error(gj), compress.init_error(gt)
    for step in range(20):
        gj, gt = trees({k: rng.normal(0, 1, s).astype(np.float32)
                        for k, s in SHAPES.items()})
        qsj, _, efj = jcompress.compress_grads(gj, efj, block=64)
        qst, treedef, eft = compress.compress_grads(gt, eft, block=64)
        pj, pt = _jax_paths(gj), adamw.paths(treedef)
        assert pt == ["w", "a/c", "a/b"] and sorted(pj) == sorted(pt)
        by_path = dict(zip(pj, qsj))
        err_j = dict(zip(_jax_paths(efj.error), jax.tree.leaves(efj.error)))
        for path, (q, s), e in zip(pt, qst, adamw.leaves(eft.error)):
            qj, sj = by_path[path]
            assert np.array_equal(np.asarray(qj), q.numpy()), (step, path)
            assert np.array_equal(_bits(sj), _bits(s.numpy())), (step, path)
            assert np.array_equal(_bits(err_j[path]), _bits(e.numpy())), (
                step, path)


def test_decompress_grads_keeps_each_like_leaf_dtype():
    rng = np.random.default_rng(1)
    arrs = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in SHAPES.items()}
    gt = {"w": torch.from_numpy(arrs["w"]).to(torch.bfloat16),
          "a": {"c": torch.from_numpy(arrs["a/c"]),
                "b": torch.from_numpy(arrs["a/b"]).to(torch.bfloat16)}}
    gj = {"w": jnp.asarray(arrs["w"], jnp.bfloat16),
          "a": {"c": jnp.asarray(arrs["a/c"]),
                "b": jnp.asarray(arrs["a/b"], jnp.bfloat16)}}
    qst, treedef, _ = compress.compress_grads(gt, compress.init_error(gt))
    out = compress.decompress_grads(qst, treedef, adamw.leaves(gt))
    qsj, tdj, _ = jcompress.compress_grads(gj, jcompress.init_error(gj))
    outj = jcompress.decompress_grads(qsj, tdj, jax.tree.leaves(gj))
    want = dict(zip(_jax_paths(outj), jax.tree.leaves(outj)))
    for path, got, like in zip(adamw.paths(out), adamw.leaves(out),
                               adamw.leaves(gt)):
        assert got.dtype == like.dtype and got.shape == like.shape, path
        assert np.array_equal(np.asarray(want[path].astype(jnp.float32)),
                              got.float().numpy()), path


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 1000))
def test_quantize_error_bound(seed):
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.normal(0, 3, (300,)).astype(np.float32))
    q, s = compress.quantize(x, block=64)
    deq = compress.dequantize(q, s, x.shape, block=64)
    # per-block max error <= scale/2 = max|block|/254
    err = (deq - x).abs().numpy()
    bound = x.abs().max().item() / 127.0
    assert err.max() <= bound + 1e-6


def test_error_feedback_reduces_bias():
    """With EF, the running sum of dequantised grads tracks the true sum."""
    r = np.random.default_rng(0)
    g = {"w": torch.from_numpy(r.normal(0, 1, (128,)).astype(np.float32))}
    ef = compress.init_error(g)
    total_true = np.zeros(128)
    total_deq = np.zeros(128)
    for _ in range(20):
        gi = {"w": torch.from_numpy(r.normal(0, 1, (128,)).astype(np.float32))}
        qs, treedef, ef = compress.compress_grads(gi, ef, block=64)
        deq = compress.decompress_grads(qs, treedef, adamw.leaves(gi))
        total_true += gi["w"].numpy()
        total_deq += deq["w"].numpy()
    assert np.abs(total_true - total_deq).max() < 0.15 * np.abs(total_true).max()
