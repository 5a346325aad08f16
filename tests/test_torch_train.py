"""The port's training path against the JAX package: reduced
``qwen3-moe-30b-a3b`` in float32 at EP = 1, fused_flat.

The same parameters (JAX's ``init_params``, converted leaf by leaf) and the
same batch (labels with a few -1) go through ``lm_loss`` and its gradient
on both sides, and through one train step (JAX's ``make_train_step``, jit):
loss, every gradient leaf, and the updated parameters with AdamW's mu, nu
and master.  Then ``adamw.update``/``schedule`` over three steps of a small
tree with clipping active, the data sources' batches, and ``launch/train.py``.

Tolerance 1e-5 relative to each leaf's largest magnitude (float32 sums in
another order across two layers and the vocabulary projection); the loss to
1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_adam import check_step, close_updated, step_slack
from repro.compat import make_mesh
from repro.configs import get_arch as jget_arch
from repro.data import pipeline as jpipeline
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import lm as jlm
from repro.models import zoo
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.data import pipeline
from repro_torch.core import traffic as traffic_lib
from repro_torch.launch import steps, train
from repro_torch.models import lm
from repro_torch.models import zoo as tzoo
from repro_torch.optim import adamw

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

ARCH = "qwen3-moe-30b-a3b"
TOL = 1e-5
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


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


def _batch(vocab, b=2, s=16, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1                      # no label: out of the denominator
    return {"tokens": toks[:, :-1], "labels": labels}


@pytest.fixture(scope="module")
def jax_side():
    """JAX: params, batch, (loss, grads) and one train step, all float32."""
    cfg = jget_arch(ARCH).reduced()
    mesh = make_mesh((1, 1), ("data", "model"))
    ctx = dataclasses.replace(
        jlm.make_context(cfg, mesh, multi_pod=False, engine="fused_flat"),
        compute_dtype=jnp.float32)
    params = jlm.init_params(cfg, jax.random.PRNGKey(0), ctx, dtype=jnp.float32)
    batch = _batch(cfg.vocab)
    jb = jax.tree.map(jnp.asarray, batch)
    with mesh:
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: jlm.lm_loss(p, b, ctx), has_aux=True))(params, jb)
        step = jax.jit(jmake_train_step(zoo.build(cfg, ctx),
                                        jadamw.AdamWConfig(**OPT)))
        new_params, opt, metrics = step(params, jadamw.init(params), jb)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return dict(params=to_np(params), batch=batch, loss=float(loss),
                grads=to_np(grads), new_params=to_np(new_params),
                mu=to_np(opt.mu), nu=to_np(opt.nu), master=to_np(opt.master),
                step_loss=float(metrics["loss"]),
                grad_norm=float(metrics["grad_norm"]))


def _port(jax_side):
    cfg = get_arch(ARCH).reduced()
    ctx = lm.make_context(cfg, "cpu", compute_dtype=torch.float32)
    params = convert.params_from_jax(jax_side["params"], device="cpu")
    return ctx, params, pipeline.to_device(jax_side["batch"], "cpu")


def test_lm_loss_and_every_grad_leaf_match_jax(jax_side):
    ctx, params, batch = _port(jax_side)
    leaves = adamw.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = lm.lm_loss(params, batch, ctx)
    assert metrics["tokens"] == 2 * 16 - 3
    np.testing.assert_allclose(float(loss.detach()), jax_side["loss"], rtol=TOL,
                               atol=TOL)
    grads = _flat(adamw.unflatten(params, torch.autograd.grad(loss, leaves)))
    want = _flat(jax_side["grads"])
    assert grads.keys() == want.keys()
    for k in want:
        _close(grads[k], want[k], what=k)


def test_train_step_matches_jax_step(jax_side):
    """One step: loss, grad norm, updated params, mu, nu and master."""
    ctx, params, batch = _port(jax_side)
    step = steps.make_train_step(tzoo.build(ctx.cfg, ctx),
                                 adamw.AdamWConfig(**OPT))
    params, opt, metrics = step(params, adamw.init(params), batch)
    assert opt.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), jax_side["step_loss"],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               jax_side["grad_norm"], rtol=TOL)
    cfg = adamw.AdamWConfig(**OPT)
    check_step(params, opt, jax_side, cfg, adamw.schedule(cfg, 1), _close)


def _slack(jax_side) -> dict:
    """Each leaf's room for its one AdamW step (``torch_adam``)."""
    cfg = adamw.AdamWConfig(**OPT)
    mu, nu = _flat(jax_side["mu"]), _flat(jax_side["nu"])
    return {k: step_slack(mu[k], nu[k], 1, adamw.schedule(cfg, 1), cfg)
            for k in mu}


def test_update_room_refuses_a_flipped_step_and_a_dropped_bias_correction(
        jax_side):
    """The room ``torch_adam`` gives an updated leaf still refuses the
    reference's step taken with its sign flipped, and taken without the
    bias corrections of m and v, on every leaf."""
    cfg = adamw.AdamWConfig(**OPT)
    lr, slack = adamw.schedule(cfg, 1), _slack(jax_side)
    p0, mu = _flat(jax_side["params"]), _flat(jax_side["mu"])
    nu, want = _flat(jax_side["nu"]), _flat(jax_side["new_params"])
    b1c, b2c = 1 - cfg.b1, 1 - cfg.b2
    for k in want:
        w = p0[k].astype(np.float64)
        direction = (mu[k] / b1c) / (np.sqrt(nu[k] / b2c) + cfg.eps)
        flipped = w - lr * (-direction + cfg.weight_decay * w)
        unbiased = w - lr * (mu[k] / (np.sqrt(nu[k]) + cfg.eps)
                             + cfg.weight_decay * w)
        close_updated(w - lr * (direction + cfg.weight_decay * w), want[k],
                      slack[k], k)
        for wrong in (flipped, unbiased):
            with pytest.raises(AssertionError):
                close_updated(wrong, want[k], slack[k], k)


def test_accumulated_step_is_the_mean_of_the_micro_batch_grads(jax_side):
    """accum 2: the gradients of the two halves, summed in float32 and
    halved, are what AdamW gets."""
    ctx, params, batch = _port(jax_side)
    model = tzoo.build(ctx.cfg, ctx)
    leaves = adamw.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    halves = [{k: v[i:i + 1] for k, v in batch.items()} for i in (0, 1)]
    gs = [torch.autograd.grad(model.loss(params, h)[0], leaves) for h in halves]
    mean = adamw.unflatten(params, [(a + b) / 2 for a, b in zip(*gs)])
    want_p = adamw.tree_map(lambda p: p.detach().clone(), params)
    want_p, want_opt, _ = adamw.update(mean, adamw.init(want_p), want_p,
                                       adamw.AdamWConfig(**OPT))
    step = steps.make_train_step(model, adamw.AdamWConfig(**OPT), accum=2)
    got_p, got_opt, metrics = step(params, adamw.init(params), batch)
    assert np.isfinite(float(metrics["loss"]))
    cfg = adamw.AdamWConfig(**OPT)
    for a, b, m, v in zip(adamw.leaves(got_p), adamw.leaves(want_p),
                          adamw.leaves(want_opt.mu), adamw.leaves(want_opt.nu)):
        close_updated(a.detach().numpy(), b.detach().numpy(), step_slack(
            m.numpy(), v.numpy(), 1, adamw.schedule(cfg, 1), cfg))
    for a, b in zip(adamw.leaves(got_opt.nu), adamw.leaves(want_opt.nu)):
        _close(a, b.detach().numpy())


def test_adamw_update_and_schedule_match_jax_over_three_steps():
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((4, 6)).astype(np.float32),
            "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}
    grads = [{"a": 3 * rng.standard_normal((4, 6)).astype(np.float32),
              "b": {"c": 3 * rng.standard_normal((5,)).astype(np.float32)}}
             for _ in range(3)]
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=1.0)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    jp = jax.tree.map(jnp.asarray, tree)
    js = jadamw.init(jp)
    tp = {"a": torch.from_numpy(tree["a"].copy()),
          "b": {"c": torch.from_numpy(tree["b"]["c"].copy())}}
    ts = adamw.init(tp)
    slack = [0.0] * len(adamw.leaves(tp))
    for i, g in enumerate(grads, 1):
        jp, js, jm = jadamw.update(jax.tree.map(jnp.asarray, g), js, jp, jcfg)
        tp, ts, tm = adamw.update(adamw.tree_map(torch.from_numpy, g), ts, tp,
                                  tcfg)
        assert float(jm["grad_norm"]) > tcfg.clip_norm      # clipping active
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=TOL)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
        slack = [s + step_slack(np.asarray(m), np.asarray(v), i, tm["lr"],
                                tcfg)
                 for s, m, v in zip(slack, jax.tree.leaves(js.mu),
                                    jax.tree.leaves(js.nu))]
        for got, want in ((ts.mu, js.mu), (ts.nu, js.nu)):
            for a, b in zip(adamw.leaves(got), jax.tree.leaves(want)):
                _close(a, np.asarray(b))
        for got, want in ((tp, jp), (ts.master, js.master)):
            for a, b, s in zip(adamw.leaves(got), jax.tree.leaves(want),
                               slack):
                close_updated(a.numpy(), np.asarray(b), s)
    for step in range(8):
        np.testing.assert_allclose(adamw.schedule(tcfg, step),
                                   float(jadamw.schedule(jcfg, jnp.int32(step))),
                                   rtol=1e-6, atol=1e-12)


def test_adamw_keeps_bf16_params_as_the_cast_of_the_f32_master():
    p = {"w": torch.randn(3, 5, generator=torch.Generator().manual_seed(0)
                          ).to(torch.bfloat16)}
    s = adamw.init(p)
    p, s, _ = adamw.update({"w": torch.ones(3, 5, dtype=torch.bfloat16)}, s, p,
                           adamw.AdamWConfig(lr=1e-1, warmup_steps=0))
    assert p["w"].dtype == torch.bfloat16 and s.master["w"].dtype == torch.float32
    assert torch.equal(p["w"], s.master["w"].to(torch.bfloat16))


@pytest.mark.parametrize("name", ["SyntheticLM", "ZipfNgramLM"])
def test_data_sources_are_copies_of_the_reference(name):
    mine = getattr(pipeline, name)(97, 12, 3, seed=5)
    ref = getattr(jpipeline, name)(97, 12, 3, seed=5)
    for step in (0, 1, 7):
        a, b = mine.batch_at(step), ref.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    batch = pipeline.to_device(mine.batch_at(7), "cpu")
    assert batch["tokens"].dtype == torch.int64
    np.testing.assert_array_equal(batch["labels"].numpy(),
                                  ref.batch_at(7)["labels"])


def test_train_run_on_the_cpu_gives_finite_losses_from_lm_loss():
    argv = ["--reduced", "--steps", "3", "--seq", "16", "--batch", "2"]
    out = train.run(train.parse_args(argv), device="cpu")
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert out["ms_per_step"] > 0 and out["peak_mem_gib"] is None
    s = train.setup(train.parse_args(argv), device="cpu")
    batch = pipeline.to_device(s.source.batch_at(0), "cpu")
    with torch.no_grad():
        loss, _ = lm.lm_loss(s.params, batch, s.ctx)
    assert float(loss) == out["losses"][0]
    assert out["losses"][1] != out["losses"][0]


def test_training_raises_on_what_is_not_ported():
    """What training still refuses: the encdec family over a (pod, model)
    axis (at ``make_context``, which takes it over a data group) and in
    ``train.main``, whose data sources yield tokens only, the traffic
    state under serial accumulation, and ``train.run`` without a card."""
    seamless = get_arch("seamless-m4t-large-v2").reduced()
    grid = type("Grid", (), dict(data=2, model=1, ep_group=None))()
    assert lm.data_size(lm.make_context(seamless, "cpu", mesh=grid)) == 2
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        lm.make_context(seamless, "cpu", multi_pod=True)
    with pytest.raises(ValueError, match="tokens only"):
        train.main(["--arch", "seamless-m4t-large-v2", "--reduced"],
                   device="cpu")
    cfg = get_arch(ARCH).reduced()
    ctx = lm.make_context(cfg, "cpu", compute_dtype=torch.float32)
    step = steps.make_train_step(tzoo.build(cfg, ctx), adamw.AdamWConfig(),
                                 accum=2)
    state = traffic_lib.init_traffic_state(cfg.moe.n_experts, 1,
                                           n_layers=cfg.n_layers)
    with pytest.raises(NotImplementedError, match="accumulation"):
        step({}, None, {}, traffic=state)
    if not torch.cuda.is_available():       # train.run runs on the card
        with pytest.raises(RuntimeError, match="CUDA"):
            train.run(train.parse_args(["--reduced"]))
