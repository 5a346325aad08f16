"""The port's ``ssm`` family against the JAX package: ``layers/ssm.py``
(Mamba2's chunked SSD, its decode step, the causal conv and the mixer) and
reduced ``mamba2-2.7b`` (2 layers, d 64, d_inner 128 in 16 SSM heads of 8,
d_state 16, chunk 8) in float32 on the CPU.

The same inputs and parameters (seeded numpy) go through the reference's
functions and the port's.  Through ``models/lm``: ``lm_loss`` and every
gradient leaf against ``jax.value_and_grad``, one AdamW step against the
reference's ``make_train_step``, the prefill's logits and whole decode
state (the SSD states and conv inputs, the length) then four decode steps,
each side fed the same tokens; the continuous engine's greedy streams
against the reference's ``ContinuousServingEngine`` on the same requests;
``convert`` of the reference's own tree; what the family refuses; and, for
both families, one train step over a data group of two gloo ranks against
the one-rank step on the whole batch.

The family-generic parts (``FamilyCase`` and the ``check_*`` functions)
serve ``tests/test_torch_hybrid.py`` too.

Tolerances: the layer functions 1e-5 x max(1, |ref|) (float32 sums in
another order: the inter-chunk recurrence is a loop here, an associative
scan there); the loss and each gradient leaf 1e-4 relative to max(1, the
leaf's max); the step's mu and nu likewise, its params and master besides
with the slack their AdamW step allows (``torch_adam``); logits and the
decode state 1e-4.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_adam import check_step
from repro.compat import make_mesh
from repro.configs import get_arch as jget_arch
from repro.launch.steps import make_train_step as jmake_train_step
from repro.layers import ssm as jssm
from repro.models import lm as jlm
from repro.models import zoo as jzoo
from repro.optim import adamw as jadamw
from repro.serving.engine import ContinuousServingEngine as JContinuous
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.data import pipeline
from repro_torch.launch import steps
from repro_torch.layers import ssm
from repro_torch.models import lm, zoo
from repro_torch.optim import adamw
from repro_torch.serving.engine import ContinuousServingEngine

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

TOL_LAYER = 1e-5
TOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
# the JAX oracles compiled without LLVM's optimisation passes: the same HLO,
# less compile time
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def close(got, want, what="", tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, dtype=np.float32)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def jit(fn, *args):
    """``fn(*args)`` compiled once (the oracles' ops are many and small)."""
    return jax.jit(fn).lower(*args).compile(FAST)(*args)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def nest(flat_tree: dict) -> dict:
    tree = {}
    for k, v in flat_tree.items():
        node = tree
        *path, leaf = k.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def seeded(shapes: dict, seed: int) -> dict:
    """Seeded numpy leaves of ``shapes`` (path -> shape): norms and the D
    skip near 1, log-decays and dt biases near 0, conv taps at 0.5, the
    embedding unit normal, weights scaled by their fan-in."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in shapes.items():
        n = rng.standard_normal(shape)
        if k.endswith(("norm", "ln1", "ln2", "d_skip")):
            a = 1 + 0.1 * n
        elif k.endswith(("a_log", "dt_bias")):
            a = 0.1 * n
        elif k.endswith("conv_w"):
            a = 0.5 * n
        elif k == "embed":
            a = n
        else:
            a = n * shape[-2] ** -0.5
        out[k] = a.astype(np.float32)
    return out


# ------------------------------------------------------- layer functions ----

B, S, H, P, G, N = 2, 32, 4, 8, 2, 16


def _ssd_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    a_log = -np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    b = (0.3 * rng.standard_normal((B, S, G, N))).astype(np.float32)
    c = (0.3 * rng.standard_normal((B, S, G, N))).astype(np.float32)
    st = (0.3 * rng.standard_normal((B, H, P, N))).astype(np.float32)
    return x, a_log, b, c, st


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_ssd_chunked_matches_reference(chunk, init):
    x, a_log, b, c, st = _ssd_inputs()
    st = st if init else None
    args = [jnp.asarray(a) for a in (x, a_log, b, c)]
    fn = lambda *a: jssm.ssd_chunked(*a[:4], chunk, *a[4:])
    if st is not None:
        args.append(jnp.asarray(st))
    y_j, f_j = jit(fn, *args)
    y, f = ssm.ssd_chunked(t(x), t(a_log), t(b), t(c), chunk,
                           None if st is None else t(st))
    close(y, y_j, "y", TOL_LAYER)
    close(f, f_j, "final state", TOL_LAYER)


def test_ssd_decode_step_and_conv_match_reference():
    x, a_log, b, c, st = _ssd_inputs(1)
    got = ssm.ssd_decode_step(t(st), t(x[:, 0]), t(a_log[:, 0]), t(b[:, 0]),
                              t(c[:, 0]))
    want = jssm.ssd_decode_step(jnp.asarray(st), jnp.asarray(x[:, 0]),
                                jnp.asarray(a_log[:, 0]), jnp.asarray(b[:, 0]),
                                jnp.asarray(c[:, 0]))
    for g, w, what in zip(got, want, ("state", "y")):
        close(g, w, what, TOL_LAYER)
    rng = np.random.default_rng(2)
    xs = rng.standard_normal((B, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    prev = rng.standard_normal((B, 3, 12)).astype(np.float32)
    for p in (None, prev):
        got = ssm.causal_conv1d(t(xs), t(w), None if p is None else t(p))
        want = jssm.causal_conv1d(jnp.asarray(xs), jnp.asarray(w),
                                  None if p is None else jnp.asarray(p))
        for g, w_, what in zip(got, want, ("y", "new prev")):
            close(g, w_, f"conv {what} prev {p is not None}", TOL_LAYER)


MIXER = dict(d_inner=32, n_heads=4, head_dim=8, d_state=16, n_groups=2,
             chunk=8)


def mixer_params(d: int, seed: int, args=MIXER) -> dict:
    """Seeded numpy leaves of one layer's Mamba2 mixer of model width d."""
    din, h = args["d_inner"], args["n_heads"]
    conv_dim = din + 2 * args["n_groups"] * args["d_state"]
    return seeded({"in_proj_zx": (d, din + conv_dim), "in_proj_dt": (d, h),
                   "conv_w": (4, conv_dim), "dt_bias": (h,), "a_log": (h,),
                   "d_skip": (h,), "norm": (din,), "out_proj": (din, d)},
                  seed)


def test_mamba2_mixer_full_and_single_step_match_reference():
    """The mixer over 16 tokens from zeros and from a state, then one
    token from the state it leaves (groups of 2 heads over 4)."""
    d = 16
    params = mixer_params(d, 3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: t(v) for k, v in params.items()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 16, d)).astype(np.float32)
    conv_dim = MIXER["d_inner"] + 2 * MIXER["n_groups"] * MIXER["d_state"]
    st = (0.3 * rng.standard_normal((B, 4, 8, 16)).astype(np.float32),
          rng.standard_normal((B, 3, conv_dim)).astype(np.float32))
    mixer = lambda x_, p_, *st_, **kw: jssm.mamba2_mixer(
        x_, p_, state=jssm.SsmState(*st_) if st_ else None, **MIXER, **kw)
    for state in (None, st):
        y_j, s_j = jit(mixer, jnp.asarray(x), jp,
                       *(() if state is None else map(jnp.asarray, state)))
        y, s_t = ssm.mamba2_mixer(
            t(x), tp, state=None if state is None else ssm.SsmState(
                *(t(a) for a in state)), **MIXER)
        close(y, y_j, "y", TOL_LAYER)
        close(s_t.ssd, s_j.ssd, "ssd state", TOL_LAYER)
        close(s_t.conv, s_j.conv, "conv inputs", TOL_LAYER)
    x1 = x[:, :1]
    y_j, s2_j = jit(lambda *a: mixer(*a, single_step=True), jnp.asarray(x1),
                    jp, *s_j)
    y, s2 = ssm.mamba2_mixer(t(x1), tp, state=s_t, single_step=True, **MIXER)
    close(y, y_j, "single-step y", TOL_LAYER)
    close(s2.ssd, s2_j.ssd, "single-step ssd", TOL_LAYER)
    close(s2.conv, s2_j.conv, "single-step conv", TOL_LAYER)


# ----------------------------------------------- the family through lm ------

@dataclasses.dataclass
class FamilyCase:
    """A reduced config, its seeded parameters (the port's tree, numpy) and
    the reference's float32 context on a (1, 1) mesh, no remat."""
    arch: str

    def __post_init__(self):
        self.cfg = get_arch(self.arch).reduced()
        self.cfg_j = jget_arch(self.arch).reduced()
        self.mesh = make_mesh((1, 1), ("data", "model"))
        self.ctx_j = dataclasses.replace(
            jlm.make_context(self.cfg_j, self.mesh, multi_pod=False),
            compute_dtype=jnp.float32, remat=False)

    def params(self, seed: int = 0) -> dict:
        shapes = {k: tuple(v.shape) for k, v in flat(lm.init_params(
            self.cfg, self.ctx(), torch.Generator().manual_seed(0),
            dtype=torch.float32)).items()}
        return nest(seeded(shapes, seed))

    def ctx(self, **kw):
        return lm.make_context(self.cfg, "cpu", compute_dtype=torch.float32,
                               **kw)

    def batch(self, b=2, s=16, seed=0) -> dict:
        toks = np.random.default_rng(seed).integers(0, self.cfg.vocab,
                                                    (b, s + 1))
        toks = toks.astype(np.int32)
        labels = toks[:, 1:].copy()
        labels[0, :3] = -1                  # no label: out of the denominator
        return {"tokens": toks[:, :-1], "labels": labels}


def jax_train_side(case: FamilyCase) -> dict:
    """JAX: loss, every gradient and one train step of the seeded
    parameters, in one compiled program."""
    params = jax.tree.map(jnp.asarray, case.params())
    batch = case.batch()
    jb = jax.tree.map(jnp.asarray, batch)
    value_and_grad = jax.value_and_grad(
        lambda p, b: jlm.lm_loss(p, b, case.ctx_j), has_aux=True)
    train_step = jmake_train_step(jzoo.build(case.cfg_j, case.ctx_j),
                                  jadamw.AdamWConfig(**OPT))

    def both(p, b):
        return value_and_grad(p, b), train_step(p, jadamw.init(p), b)

    with case.mesh:
        ((loss, _), grads), (new_params, opt, m) = jax.jit(both).lower(
            params, jb).compile(FAST)(params, jb)
    to_np = lambda x: jax.tree.map(np.asarray, x)
    return dict(params=to_np(params), batch=batch, loss=float(loss),
                grads=to_np(grads), new_params=to_np(new_params),
                mu=to_np(opt.mu), nu=to_np(opt.nu), master=to_np(opt.master),
                step_loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))


def check_loss_and_grads(case: FamilyCase, want: dict) -> None:
    ctx = case.ctx()
    params = convert.params_from_jax(want["params"], device="cpu")
    leaves = adamw.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = lm.lm_loss(params, pipeline.to_device(want["batch"], "cpu"),
                               ctx)
    assert metrics["tokens"] == 2 * 16 - 3 and "traffic" not in metrics
    close(loss, want["loss"], "loss")
    grads = flat(adamw.unflatten(params, torch.autograd.grad(loss, leaves)))
    ref = flat(want["grads"])
    assert grads.keys() == ref.keys()
    assert any("/ssm/" in k for k in ref)
    for k in ref:
        close(grads[k], ref[k], k)


def check_train_step(case: FamilyCase, want: dict) -> None:
    """One step: loss, clip norm, updated params, mu, nu and master."""
    model = zoo.build(case.cfg, case.ctx())
    params = convert.params_from_jax(want["params"], device="cpu")
    opt_cfg = adamw.AdamWConfig(**OPT)
    step = steps.make_train_step(model, opt_cfg)
    params, opt, metrics = step(params, steps.init_state(model, params),
                                pipeline.to_device(want["batch"], "cpu"))
    assert opt.step == 1
    close(metrics["loss"], want["step_loss"], "step loss")
    close(metrics["grad_norm"], want["grad_norm"], "grad norm")
    check_step(params, opt, want, opt_cfg, adamw.schedule(opt_cfg, 1), close)


def _state_np(state) -> dict:
    """A decode state's leaves by name, numpy (either side's)."""
    leaves = {"length": state.length}
    for part in ("kv", "ssm"):
        leaves.update({f"{part}/{k}": v
                       for k, v in (getattr(state, part) or {}).items()})
    # the port writes its state in place: copy each step's
    return {k: v.numpy().copy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in leaves.items()}


def check_prefill_and_decode(case: FamilyCase, prompt=16, max_len=24,
                             steps_=4) -> None:
    """The prefill of 3 prompts of ``prompt`` tokens (logits, the whole
    decode state), then ``steps_`` decode steps fed the same tokens, each
    state again; then a prefill and a loss whose length the chunk does not
    divide raise."""
    params_np = case.params(1)
    params_j = jax.tree.map(jnp.asarray, params_np)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, case.cfg.vocab, (3, prompt)).astype(np.int32)
    feeds = rng.integers(0, case.cfg.vocab, (steps_, 3)).astype(np.int32)
    ctx_j = case.ctx_j
    with case.mesh:
        prefill = jax.jit(lambda p, x: jlm.prefill(
            p, x, jnp.arange(x.shape[1]), ctx_j, max_len))
        decode = jax.jit(lambda p, st, x: jlm.decode_step(p, st, x, ctx_j,
                                                          max_len))
        logits, state = prefill(params_j, jnp.asarray(toks))
        want = [(np.asarray(logits), _state_np(state))]
        for tok in feeds:
            logits, state = decode(params_j, state, jnp.asarray(tok))
            want.append((np.asarray(logits), _state_np(state)))

    ctx = case.ctx()
    params = convert.params_from_jax(params_np, device="cpu")
    logits, state = lm.prefill(params, t(toks).long(), torch.arange(prompt),
                               ctx, max_len)
    got = [(logits, _state_np(state))]
    for tok in feeds:
        logits, state = lm.decode_step(params, state, t(tok).long(), ctx,
                                       max_len)
        got.append((logits, _state_np(state)))
    for i, ((lg, st), (lg_j, st_j)) in enumerate(zip(got, want, strict=True)):
        close(lg, lg_j, f"logits after {i} decode steps")
        assert st.keys() == st_j.keys()
        assert any(k.startswith("ssm/") for k in st)
        for k in st_j:
            assert st[k].shape == st_j[k].shape, k
            close(st[k], st_j[k], f"state {k} after {i} decode steps")
    odd = t(toks[:, :prompt - 4]).long()
    with pytest.raises(ValueError, match="chunks of"):
        lm.prefill(params, odd, torch.arange(prompt - 4), ctx, max_len)
    with pytest.raises(ValueError, match="chunks of"):
        lm.lm_loss(params, {"tokens": odd, "labels": odd}, ctx)


def check_continuous_streams(case: FamilyCase) -> None:
    """Five requests of 12-32 tokens left-padded into one bucket of 32
    through a pool of 2 (slots retire and refill), ``max_new`` 2-4: the port's
    continuous engine gives the reference engine's greedy token list per
    request, from the reference's own float32 parameters."""
    bundle_j = jzoo.build(case.cfg_j, case.ctx_j)
    params_j = jax.tree.map(lambda x: x.astype(jnp.float32),
                            bundle_j.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, case.cfg.vocab, n) for n in (16, 12, 32, 24, 16)]
    max_new = [2 + i % 3 for i in range(len(prompts))]
    kw = dict(max_batch=2, max_len=40, buckets=(32,))

    def drive(eng, params):
        for p, n in zip(prompts, max_new):
            eng.submit(p, max_new=n)
        eng.warmup(params)
        eng.run(params)
        return {q.rid: q.output for q in eng.finished}

    with case.mesh:
        want = drive(JContinuous(bundle_j, **kw), params_j)
    got = drive(ContinuousServingEngine(zoo.build(case.cfg, case.ctx()), **kw),
                convert.params_from_jax(jax.tree.map(np.asarray, params_j),
                                        device="cpu"))
    assert got == want
    assert sorted(map(len, got.values())) == sorted(max_new)


def check_convert(case: FamilyCase, full_counts: tuple) -> dict:
    """The reference's own init converts leaf for leaf, and the port's init
    builds the same keys and shapes; ``param_counts`` is their size and, at
    full width, ``full_counts``.  Returns the reference's tree (numpy)."""
    tree = jax.tree.map(np.asarray, jlm.init_params(
        case.cfg_j, jax.random.PRNGKey(1), case.ctx_j, dtype=jnp.float32))
    params = convert.params_from_jax(tree, device="cpu")
    flat_j, flat_t = flat(tree), flat(params)
    assert flat_t.keys() == flat_j.keys()
    for key, leaf in flat_j.items():
        np.testing.assert_array_equal(flat_t[key].numpy(), leaf, err_msg=key)
    own = flat(lm.init_params(case.cfg, case.ctx(),
                              torch.Generator().manual_seed(0)))
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: v.shape for k, v in flat_j.items()}
    assert lm.param_counts(case.cfg) == (sum(v.size for v in flat_j.values()),
                                         0)
    assert lm.param_counts(get_arch(case.arch)) == full_counts
    return tree


def check_refusals(case: FamilyCase, monkeypatch) -> None:
    """Over a model group of 2 (an EP group, or a grid's model group)
    ``make_context`` builds, its Mamba2 mixers split by SSM head
    (``lm.ssm_group``, the leaves' dims of ``sharding.SSM_DIM``); over a
    (pod, model) axis it raises, naming the queue item; over a data group
    of 2 (model group 1) it builds."""
    monkeypatch.setattr(lm, "group_size", lambda g: 2 if g == "model" else 1)
    for kw in (dict(ep_group="model"),
               dict(mesh=type("Grid", (), dict(data=1, model=2,
                                               ep_group="model"))())):
        ctx = case.ctx(**kw)
        assert lm.ssm_group(ctx) == "model"
        dim = lm.model_dim(ctx)
        assert dim("layers/ssm/in_proj_zx") == -1
        assert dim("layers/ssm/out_proj") == -2
        assert (lm.island_group(ctx) == "model") == (case.cfg.family
                                                     == "hybrid")
    with pytest.raises(NotImplementedError,
                       match="queue 1 item 8, TP and the vocab split over"):
        case.ctx(ep_group="model", multi_pod=True)
    monkeypatch.undo()
    grid = type("Grid", (), dict(data=2, model=1, ep_group=None))()
    ctx = case.ctx(mesh=grid)
    assert ctx.placement is None and not lm.tensor_parallel(ctx)
    assert not lm.vocab_parallel(ctx)
    with pytest.raises(ValueError, match="traffic"):
        lm.lm_loss({}, {"tokens": torch.zeros((1, 8), dtype=torch.long)},
                   case.ctx(), traffic=object())


MAMBA = FamilyCase("mamba2-2.7b")


@pytest.fixture(scope="module")
def mamba_train():
    return jax_train_side(MAMBA)


def test_mamba2_lm_loss_and_every_grad_leaf_match_jax(mamba_train):
    check_loss_and_grads(MAMBA, mamba_train)


def test_mamba2_train_step_matches_jax_step(mamba_train):
    check_train_step(MAMBA, mamba_train)


def test_mamba2_prefill_state_and_decode_steps_match_jax():
    check_prefill_and_decode(MAMBA)


def test_mamba2_continuous_streams_match_reference_engine():
    check_continuous_streams(MAMBA)


def test_mamba2_convert_and_param_counts():
    tree = check_convert(MAMBA, (2_830_951_936, 0))
    assert set(tree["layers"]) == {"ln1", "ssm"}


def test_mamba2_refusals(monkeypatch):
    check_refusals(MAMBA, monkeypatch)


def test_configs_and_buckets():
    """Both configs copy the reference's (reduced too, whose rule the tests
    build both sides from); the engine's default buckets are multiples of
    the SSD chunk, and other buckets are refused."""
    for name in ("mamba2-2.7b", "hymba-1.5b"):
        for mk in (lambda c: c, lambda c: c.reduced()):
            port = dataclasses.asdict(mk(get_arch(name)))
            ref = dataclasses.asdict(mk(jget_arch(name)))
            assert port == {k: ref[k] for k in port}, name
            assert mk(get_arch(name)).sub_quadratic
    bundle = zoo.build(MAMBA.cfg, MAMBA.ctx())
    assert ContinuousServingEngine(bundle, max_len=11).buckets == (8,)
    assert ContinuousServingEngine(bundle, max_len=40).buckets == (16, 32, 40)
    with pytest.raises(ValueError, match="multiples of 8"):
        ContinuousServingEngine(bundle, max_len=40, buckets=(12, 32))


# one rank of the (2, 1) grid, in a fresh interpreter that imports no JAX:
# the seeded parameters and the global batch come from the test's npz
RANK = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.data import pipeline
from repro_torch.launch import steps, train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lm, zoo
from repro_torch.optim import adamw

rank, d = int(sys.argv[1]), sys.argv[2]       # then the archs
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{d}/rendezvous",
                        rank=rank, world_size=2)
mesh = make_host_mesh(2, 1)
for arch in sys.argv[3:]:
    src = np.load(f"{d}/{arch}.npz")
    tree = {}
    for k in src.files:
        *path, leaf = k.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = src[k]
    batch, opt = tree.pop("batch"), tree.pop("opt")
    cfg = get_arch(arch).reduced()
    model = zoo.build(cfg, lm.make_context(cfg, "cpu", mesh=mesh,
                                           compute_dtype=torch.float32))
    params = convert.params_from_jax(tree, device="cpu")
    step = steps.make_train_step(model, adamw.AdamWConfig(
        lr=float(opt["lr"]), warmup_steps=int(opt["warmup_steps"]),
        total_steps=int(opt["total_steps"])))
    local = train.shard_batch(batch, 2, mesh.data_index)[0]
    params, _, m = step(params, steps.init_state(model, params),
                        pipeline.to_device(local, "cpu"))
    np.savez(f"{d}/{arch}.rank{rank}.npz", loss=float(m["loss"]),
             norm=float(m["grad_norm"]),
             **{p.replace("/", "."): v.detach().numpy()
                for p, v in zip(adamw.paths(params), adamw.leaves(params))})
dist.destroy_process_group()
"""


def test_train_step_over_a_data_group(tmp_path):
    """One train step of each family on a (2, 1) grid of two gloo ranks
    (fresh processes, a ``file://`` rendezvous), each on its two rows of a
    batch of four (ZeRO-1 state over the data group): both ranks hold the
    one-rank step's loss, clip norm and params within 1e-5 (float32
    gradients summed over two ranks in another order)."""
    cases = (MAMBA, FamilyCase("hymba-1.5b"))
    inputs = {}
    for case in cases:
        inputs[case.arch] = case.params(3), case.batch(b=4)
        flat_in = dict(flat(inputs[case.arch][0]),
                       **{f"batch/{k}": v
                          for k, v in inputs[case.arch][1].items()},
                       **{f"opt/{k}": np.asarray(v) for k, v in OPT.items()})
        np.savez(tmp_path / f"{case.arch}.npz",
                 **{k.replace("/", "."): v for k, v in flat_in.items()})
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [SRC, os.environ.get("PYTHONPATH", "")])}
    ranks = [subprocess.Popen([sys.executable, "-c", RANK, str(r),
                               str(tmp_path), *inputs], env=env,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        errs = [p.communicate(timeout=120)[1] for p in ranks]
    finally:                     # a rank left waiting on a failed one
        for p in ranks:
            p.kill()
    assert all(p.returncode == 0 for p in ranks), errs
    for case in cases:
        params_np, batch = inputs[case.arch]
        model = zoo.build(case.cfg, case.ctx())
        params = convert.params_from_jax(params_np, device="cpu")
        step = steps.make_train_step(model, adamw.AdamWConfig(**OPT))
        params, _, m = step(params, steps.init_state(model, params),
                            pipeline.to_device(batch, "cpu"))
        for r in range(2):
            got = np.load(tmp_path / f"{case.arch}.rank{r}.npz")
            what = f"{case.arch} rank {r}"
            close(got["loss"], float(m["loss"]), f"{what} loss", 1e-5)
            close(got["norm"], float(m["grad_norm"]), f"{what} clip norm",
                  1e-5)
            for k, v in flat(params).items():
                close(got[k.replace("/", ".")], v.detach().numpy(),
                      f"{what} {k}", 1e-5)
