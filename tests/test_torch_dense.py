"""The port's ``dense`` family against the JAX package: reduced
``qwen3-1.7b`` (2 layers, d 64, 4 / 2 heads of 16: group size 2, qk-norm,
the SwiGLU MLP of d_ff 128) in float32 on the CPU.

The same parameters (seeded numpy arrays in the reference's tree) and the
same batch (labels with a few -1) go through ``lm_loss`` and its gradient
on both sides (``jax.value_and_grad(repro.models.lm.lm_loss)``) and through
one train step (JAX's ``make_train_step``); the prefill's logits and cache
and three decode steps, lock-step and over a slot pool with per-row
lengths (the reference's ``ContinuousServingEngine._insert_fn`` on its
side), each side fed the same tokens; ``convert`` of the reference's dense
tree.  Then what the port refuses for the family, and the entry points on the
CPU.

Tolerances: 1e-5 relative to each leaf's max(1, |x|) for the loss, the
gradients and the step (float32 sums in another order across two layers
and the vocabulary projection), the updated params and master besides
with the slack their AdamW step allows (``torch_adam``: a gradient that
all but cancels is divided by eps); 1e-4 on logits and caches (the same,
over prefill and three decode steps).
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
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import lm as jlm
from repro.models import zoo as jzoo
from repro.optim import adamw as jadamw
from repro.parallel.sharding import param_specs as jparam_specs
from repro.serving.engine import ContinuousServingEngine as JContinuous
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.data import pipeline
from repro_torch.launch import serve, steps, train
from repro_torch.models import lm, zoo
from repro_torch.optim import adamw
from repro_torch.parallel import sharding
from repro_torch.serving.engine import ContinuousServingEngine

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

ARCH = "qwen3-1.7b"
CFG = get_arch(ARCH).reduced()
TOL = 1e-5
TOL_SERVE = 1e-4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
# the JAX oracles compiled without LLVM's optimisation passes: the same HLO,
# less compile time
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


def _nest(flat: dict) -> dict:
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def _close(got, want, what="", tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, dtype=np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _params(seed=0):
    """Seeded numpy parameters in the reference's tree (the keys and shapes
    of the port's ``init_params``): norms near 1, weights scaled by their
    fan-in, the embedding unit normal."""
    shapes = _flat(lm.init_params(CFG, lm.make_context(CFG, "cpu"),
                                  torch.Generator().manual_seed(0),
                                  dtype=torch.float32))
    rng = np.random.default_rng(seed)
    tree = {}
    for k, v in shapes.items():
        shape = tuple(v.shape)
        if k.endswith(("norm", "ln1", "ln2")):
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
    labels[0, :3] = -1                      # no label: out of the denominator
    return {"tokens": toks[:, :-1], "labels": labels}


def _jax_ctx():
    """The reference's dense context on a (1, 1) mesh in float32 (its
    Megatron blocks over a model axis of one), without rematerialisation
    (which changes what the backward keeps, not what it computes)."""
    mesh = make_mesh((1, 1), ("data", "model"))
    cfg = jget_arch(ARCH).reduced()
    return cfg, mesh, dataclasses.replace(
        jlm.make_context(cfg, mesh, multi_pod=False),
        compute_dtype=jnp.float32, remat=False)


@pytest.fixture(scope="module")
def jax_side():
    """JAX: loss, every gradient and one train step of the seeded
    parameters, in one compiled program."""
    cfg, mesh, ctx = _jax_ctx()
    params = jax.tree.map(jnp.asarray, _params())
    batch = _batch()
    jb = jax.tree.map(jnp.asarray, batch)
    value_and_grad = jax.value_and_grad(lambda p, b: jlm.lm_loss(p, b, ctx),
                                        has_aux=True)
    train_step = jmake_train_step(jzoo.build(cfg, ctx),
                                  jadamw.AdamWConfig(**OPT))

    def both(p, b):
        return value_and_grad(p, b), train_step(p, jadamw.init(p), b)

    with mesh:
        ((loss, _), grads), (new_params, opt, m) = jax.jit(both).lower(
            params, jb).compile(FAST)(params, jb)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return dict(params=to_np(params), batch=batch, loss=float(loss),
                grads=to_np(grads), new_params=to_np(new_params),
                mu=to_np(opt.mu), nu=to_np(opt.nu), master=to_np(opt.master),
                step_loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))


def _port(want):
    ctx = lm.make_context(CFG, "cpu", compute_dtype=torch.float32)
    params = convert.params_from_jax(want["params"], device="cpu")
    return ctx, params, pipeline.to_device(want["batch"], "cpu")


def test_dense_lm_loss_and_every_grad_leaf_match_jax(jax_side):
    ctx, params, batch = _port(jax_side)
    leaves = adamw.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = lm.lm_loss(params, batch, ctx)
    assert metrics["tokens"] == 2 * 16 - 3 and "traffic" not in metrics
    np.testing.assert_allclose(float(loss.detach()), jax_side["loss"],
                               rtol=TOL, atol=TOL)
    grads = _flat(adamw.unflatten(params, torch.autograd.grad(loss, leaves)))
    want = _flat(jax_side["grads"])
    assert grads.keys() == want.keys()
    assert {k for k in want if "/mlp/" in k} == {
        "layers/mlp/w_gate", "layers/mlp/w_up", "layers/mlp/w_down"}
    for k in want:
        _close(grads[k], want[k], what=k)


def test_dense_train_step_matches_jax_step(jax_side):
    """One step: loss, clip norm, updated params, mu, nu and master."""
    ctx, params, batch = _port(jax_side)
    model = zoo.build(CFG, ctx)
    step = steps.make_train_step(model, adamw.AdamWConfig(**OPT))
    params, opt, metrics = step(params, steps.init_state(model, params), batch)
    assert opt.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), jax_side["step_loss"],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               jax_side["grad_norm"], rtol=TOL)
    cfg = adamw.AdamWConfig(**OPT)
    check_step(params, opt, jax_side, cfg, adamw.schedule(cfg, 1), _close)


def test_dense_prefill_and_decode_lock_step_and_per_row_match_jax():
    """Lock-step: the prefill of 3 prompts of 8 tokens (logits, the whole
    cache, the length), then three decode steps fed the same tokens.  Per
    row: a 4-slot pool filled from prefills at 8, 16 and 10 tokens, slot 2
    left free at length 0, then three decode steps of the whole pool."""
    _, mesh, ctx_j = _jax_ctx()
    params_np = _params(1)
    params_j = jax.tree.map(jnp.asarray, params_np)
    rng = np.random.default_rng(7)
    max_len = 24
    lock = rng.integers(0, CFG.vocab, (3, 8)).astype(np.int32)
    prompts = {0: rng.integers(0, CFG.vocab, 8), 1: rng.integers(0, CFG.vocab, 16),
               3: rng.integers(0, CFG.vocab, 10)}
    feeds = rng.integers(0, CFG.vocab, (3, 4))
    with mesh:
        prefill = jax.jit(lambda p, t: jlm.prefill(
            p, t, jnp.arange(t.shape[1]), ctx_j, max_len))
        decode = jax.jit(lambda p, st, t: jlm.decode_step(p, st, t, ctx_j,
                                                          max_len))
        logits, state = prefill(params_j, jnp.asarray(lock))
        want_lock = [(np.asarray(logits), jax.tree.map(np.asarray, state.kv))]
        for tok in feeds[:, :3]:
            logits, state = decode(params_j, state, jnp.asarray(tok, jnp.int32))
            want_lock.append((np.asarray(logits),
                              jax.tree.map(np.asarray, state.kv)))
        pool = jlm.init_decode_state(ctx_j.cfg, 4, max_len, jnp.float32, ctx_j,
                                     per_slot=True)
        for slot, p in prompts.items():
            _, new = prefill(params_j, jnp.asarray(p[None], jnp.int32))
            pool = JContinuous._insert_fn(pool, new,
                                          jnp.asarray([slot], jnp.int32))
        want_pool = []
        for tok in feeds:
            logits, pool = decode(params_j, pool, jnp.asarray(tok, jnp.int32))
            want_pool.append((np.asarray(logits),
                              jax.tree.map(np.asarray, pool.kv),
                              np.asarray(pool.length)))

    ctx = lm.make_context(CFG, "cpu", compute_dtype=torch.float32)
    params = convert.params_from_jax(params_np, device="cpu")
    logits, state = lm.prefill(params, torch.from_numpy(lock).long(),
                               torch.arange(8), ctx, max_len)
    assert state.length.dim() == 0 and int(state.length) == 8
    # the decode writes the cache in place: keep a copy of each step's
    snap = lambda kv: {k: v.clone() for k, v in kv.items()}
    got = [(logits, snap(state.kv))]
    for tok in feeds[:, :3]:
        logits, state = lm.decode_step(params, state, torch.from_numpy(tok),
                                       ctx, max_len)
        got.append((logits, snap(state.kv)))
    for (lg, kv), (lg_j, kv_j) in zip(got, want_lock, strict=True):
        _close(lg, lg_j, "lock-step logits", TOL_SERVE)
        for name in ("k", "v"):
            assert kv[name].shape == kv_j[name].shape
            _close(kv[name], kv_j[name], f"lock-step cache {name}", TOL_SERVE)
    assert int(state.length) == 11

    pool = lm.init_decode_state(CFG, 4, max_len, torch.float32, ctx,
                                per_slot=True)
    for slot, p in prompts.items():
        _, new = lm.prefill(params, torch.from_numpy(p[None]),
                            torch.arange(len(p)), ctx, max_len)
        pool = ContinuousServingEngine._insert_fn(pool, new, [slot])
    np.testing.assert_array_equal(pool.length.numpy(), [8, 16, 0, 10])
    for tok, (lg_j, kv_j, len_j) in zip(feeds, want_pool, strict=True):
        logits, pool = lm.decode_step(params, pool, torch.from_numpy(tok), ctx,
                                      max_len)
        assert bool(torch.isfinite(logits).all())      # the free slot too
        _close(logits, lg_j, "per-row logits", TOL_SERVE)
        for name in ("k", "v"):
            _close(pool.kv[name], kv_j[name], f"per-row cache {name}",
                   TOL_SERVE)
        np.testing.assert_array_equal(pool.length.numpy(), len_j)


def test_convert_takes_the_jax_dense_tree():
    """The reference's own dense init converts leaf for leaf (the ``mlp``
    leaves, no ``moe``), and the port's init builds the same keys and
    shapes."""
    cfg_j, mesh, ctx_j = _jax_ctx()
    tree = jax.tree.map(np.asarray, jlm.init_params(
        cfg_j, jax.random.PRNGKey(1), ctx_j, dtype=jnp.float32))
    assert "moe" not in tree["layers"] and "mlp" in tree["layers"]
    params = convert.params_from_jax(tree, device="cpu")
    flat_j, flat_t = _flat(tree), _flat(params)
    assert flat_t.keys() == flat_j.keys()
    for key, leaf in flat_j.items():
        np.testing.assert_array_equal(flat_t[key].numpy(), leaf, err_msg=key)
    own = _flat(lm.init_params(CFG, lm.make_context(CFG, "cpu"),
                               torch.Generator().manual_seed(0)))
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: v.shape for k, v in flat_j.items()}
    assert lm.param_counts(CFG) == (sum(v.size for v in flat_j.values()), 0)
    # the full width, reckoned from the config
    assert lm.param_counts(get_arch(ARCH)) == (2_031_739_904, 0)


class _Grid:
    """A stand-in (data, model) grid of ``data`` x ``model`` ranks."""

    def __init__(self, data, model):
        self.data, self.model, self.ep_group = data, model, None


def test_dense_refuses_a_group_and_traffic(monkeypatch):
    """The dense family has no placement and no dcomm config; over a model
    group (an EP group, or that of a grid with a data group of one or two)
    its context builds, with Megatron TP over the model group
    (``lm.tensor_parallel``, off with ``explicit_tp=False``), and each TP
    leaf's spec is the reference's "model" entry (``wk`` / ``wv`` whole;
    the embed and head split on the reference's dim in training over the
    group, ``lm.vocab_parallel``, with or without TP); a traffic state
    raises as the reference's does."""
    ctx = lm.make_context(CFG, "cpu")
    assert ctx.placement is None and ctx.dcfg is None
    assert train.init_traffic(CFG, ctx, 1) is None
    monkeypatch.setattr(lm, "group_size", lambda g: 4 if g == "ep" else 1)
    alone = lm.make_context(CFG, "cpu", ep_group="ep")
    assert alone.mesh is None and lm.tensor_parallel(alone)
    rep = lm.make_context(CFG, "cpu", ep_group="ep", explicit_tp=False)
    assert not lm.tensor_parallel(rep) and lm.vocab_parallel(rep)
    assert not lm.vocab_parallel(dataclasses.replace(rep, split_vocab=False))
    for data in (1, 2):
        grid = _Grid(data, 4)
        grid.ep_group = "ep"
        tp = lm.make_context(CFG, "cpu", mesh=grid)
        assert tp.mesh is grid and tp.tp_eligible() and lm.tensor_parallel(tp)
        assert not lm.tensor_parallel(dataclasses.replace(tp,
                                                          explicit_tp=False))
    monkeypatch.undo()
    for grid in (_Grid(2, 1), _Grid(1, 1)):
        built = lm.make_context(CFG, "cpu", mesh=grid)
        assert built.mesh is grid and not lm.tensor_parallel(built)
    params = lm.init_params(CFG, ctx, torch.Generator().manual_seed(0))
    cut = _flat(lm.shard_params(params, ctx))
    assert all(cut[k] is v for k, v in _flat(params).items())
    jtree = {k: jnp.zeros(v.shape) for k, v in _flat(params).items()}
    want = _flat(jparam_specs(_nest(jtree), multi_pod=False, model_size=2))
    for path, spec in want.items():
        nd = cut[path].dim()
        dims = tuple(spec) + (None,) * (nd - len(spec))
        model = [i - nd for i, a in enumerate(dims)
                 if a in ("model", ("model",))]
        mine = sharding.param_spec(path, tuple(cut[path].shape),
                                   tensor_parallel=True, model_size=2)
        if path.split("/")[0] in ("embed", "lm_head"):
            # split over the model group in training, as the reference's
            # (the tree here is the one-rank context's, whole)
            assert mine == sharding.Spec(model=model[0]), path
        elif path.endswith(("wk", "wv")):
            assert model and mine == sharding.REPLICATED, path
        else:
            assert mine == (sharding.Spec(model=model[0]) if model
                            else sharding.REPLICATED), path
    batch = pipeline.to_device(_batch(), "cpu")
    with pytest.raises(ValueError, match="traffic"):
        lm.lm_loss(params, batch, ctx, traffic=object())


def test_dense_entry_points_on_the_cpu_ignore_the_engine_flags():
    """``train.run`` and ``serve.run`` (lock-step and continuous) of the
    reduced model on the CPU: finite losses, in-vocabulary tokens, no
    traffic; the engine flags change nothing for a family without MoE."""
    base = ["--arch", ARCH, "--reduced"]
    engine = ["--engine", "fused_pipe", "--moe-stream", "2", "--pipe-slices",
              "4"]
    tr = ["--steps", "3", "--seq", "16", "--batch", "2"]
    runs = [train.run(train.parse_args(base + e + tr), device="cpu")
            for e in ([], engine)]
    assert runs[0]["losses"] == runs[1]["losses"]
    assert np.isfinite(runs[0]["losses"]).all() and runs[0]["traffic"] is None
    sv = ["--requests", "3", "--prompt-len", "8", "--gen", "4"]
    outs = [serve.run(serve.parse_args(base + e + sv), device="cpu")
            for e in ([], engine)]
    assert torch.equal(outs[0]["tokens"], outs[1]["tokens"])
    assert bool(((outs[0]["tokens"] >= 0)
                 & (outs[0]["tokens"] < CFG.vocab)).all())
    cont = serve.run(serve.parse_args(base + sv + ["--continuous"]),
                     device="cpu")
    assert sorted(len(r.output) for r in cont["done"]) == [4, 4, 4]
    assert cont["engine"].traffic is None
