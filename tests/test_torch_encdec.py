"""The port's ``encdec`` family (``models/encdec_model.py``) against the JAX
package: reduced ``seamless-m4t-large-v2`` (2 encoder + 2 decoder layers,
d 64, 4 / 2 heads of 16, d_ff 128) in float32 on the CPU.

The same parameters (seeded numpy in the reference's tree) and batch go
through both sides: ``encdec_loss`` and every gradient leaf against
``jax.value_and_grad``, one AdamW step against the reference's
``make_train_step``; the prefill of 16 frames (the encoder, each layer's
cross K/V, the first decoder token) and its whole state (the self-attention
cache, the cross K/V, the length), then three decode steps fed the same
tokens; ``serve.run`` against the reference's bundle on the same weights
and batch; ``convert``; what the family takes and refuses.  (``attention_block``'s
bidirectional and cross modes are held in ``tests/test_torch_vlm.py``.)

Tolerances: the loss, each gradient leaf, logits and the decode state 1e-4
relative to max(1, the leaf's max); the step as ``tests/test_torch_ssm.py``
holds it (``torch_adam``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ssm import (FAST, OPT, close, flat, nest, seeded, t)
from test_torch_vlm import batch_tensors, check_group_refusals
from torch_adam import check_step
from repro.compat import make_mesh
from repro.configs import get_arch as jget_arch
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import encdec_model as jencdec
from repro.models import lm as jlm
from repro.models import zoo as jzoo
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.launch import serve, steps, train
from repro_torch.models import encdec_model, lm, zoo
from repro_torch.optim import adamw
from repro_torch.serving.engine import (ContinuousServingEngine,
                                        ServingEngine)

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

ARCH = "seamless-m4t-large-v2"
CFG = get_arch(ARCH).reduced()
CFG_J = jget_arch(ARCH).reduced()
MESH = make_mesh((1, 1), ("data", "model"))
CTX_J = dataclasses.replace(jlm.make_context(CFG_J, MESH, multi_pod=False),
                            compute_dtype=jnp.float32, remat=False)


def ctx(**kw):
    return lm.make_context(CFG, "cpu", compute_dtype=torch.float32, **kw)


def params_np(seed: int) -> dict:
    shapes = {k: tuple(v.shape) for k, v in flat(encdec_model.init_params(
        CFG, ctx(), torch.Generator().manual_seed(0),
        dtype=torch.float32)).items()}
    return nest(seeded(shapes, seed))


def batch(b=2, s_enc=16, s_dec=8, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, CFG.vocab, (b, s_dec + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1                      # no label: out of the denominator
    return {"frames": rng.standard_normal((b, s_enc, CFG.d_model)
                                          ).astype(np.float32),
            "tokens": toks[:, :-1], "labels": labels}


@pytest.fixture(scope="module")
def encdec_train():
    """JAX: loss, every gradient and one train step of the seeded
    parameters, in one compiled program."""
    params = jax.tree.map(jnp.asarray, params_np(0))
    b = batch()
    jb = jax.tree.map(jnp.asarray, b)
    value_and_grad = jax.value_and_grad(
        lambda p, x: jencdec.encdec_loss(p, x, CTX_J), has_aux=True)
    train_step = jmake_train_step(jzoo.build(CFG_J, CTX_J),
                                  jadamw.AdamWConfig(**OPT))

    def both(p, x):
        return value_and_grad(p, x), train_step(p, jadamw.init(p), x)

    with MESH:
        ((loss, _), grads), (new_params, opt, m) = jax.jit(both).lower(
            params, jb).compile(FAST)(params, jb)
    to_np = lambda x: jax.tree.map(np.asarray, x)
    return dict(params=to_np(params), batch=b, loss=float(loss),
                grads=to_np(grads), new_params=to_np(new_params),
                mu=to_np(opt.mu), nu=to_np(opt.nu), master=to_np(opt.master),
                step_loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))


def test_encdec_loss_and_every_grad_leaf_match_jax(encdec_train):
    want = encdec_train
    params = convert.params_from_jax(want["params"], device="cpu")
    leaves = adamw.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = zoo.build(CFG, ctx()).loss(params,
                                               batch_tensors(want["batch"]))
    assert metrics["tokens"] == 2 * 8 - 3
    close(loss, want["loss"], "loss")
    grads = flat(adamw.unflatten(params, torch.autograd.grad(loss, leaves)))
    ref = flat(want["grads"])
    assert grads.keys() == ref.keys()
    for k in ref:
        close(grads[k], ref[k], k)


def test_encdec_train_step_matches_jax_step(encdec_train):
    """One step: loss, clip norm, updated params, mu, nu and master."""
    want = encdec_train
    model = zoo.build(CFG, ctx())
    params = convert.params_from_jax(want["params"], device="cpu")
    opt_cfg = adamw.AdamWConfig(**OPT)
    step = steps.make_train_step(model, opt_cfg)
    params, opt, metrics = step(params, steps.init_state(model, params),
                                batch_tensors(want["batch"]))
    assert opt.step == 1
    close(metrics["loss"], want["step_loss"], "step loss")
    close(metrics["grad_norm"], want["grad_norm"], "grad norm")
    check_step(params, opt, want, opt_cfg, adamw.schedule(opt_cfg, 1), close)


def _state_np(state) -> dict:
    out = {"length": np.asarray(state.length).copy(),
           "cross_k": np.asarray(state.cross_k).copy(),
           "cross_v": np.asarray(state.cross_v).copy()}
    out.update({f"self_kv/{k}": np.asarray(v).copy()
                for k, v in state.self_kv.items()})
    return out


def test_encdec_prefill_and_decode_match_jax():
    """The bundle's prefill of 3 rows of 16 frames and their BOS tokens
    (logits, the self cache, the cross K/V, the length), then three decode
    steps fed the same tokens, the state after each."""
    p_np = params_np(1)
    p_j = jax.tree.map(jnp.asarray, p_np)
    rng = np.random.default_rng(7)
    frames = rng.standard_normal((3, 16, CFG.d_model)).astype(np.float32)
    feeds = rng.integers(0, CFG.vocab, (4, 3)).astype(np.int32)
    max_len = 24
    bundle_j = jzoo.build(CFG_J, CTX_J)
    with MESH:
        prefill = jax.jit(lambda p, b: bundle_j.prefill(p, b, max_len))
        decode = jax.jit(lambda p, st, x: bundle_j.decode_step(p, st, x,
                                                               max_len))
        logits, state = prefill(p_j, {"frames": jnp.asarray(frames),
                                      "tokens": jnp.asarray(feeds[0])})
        want = [(np.asarray(logits), _state_np(state))]
        for tok in feeds[1:]:
            logits, state = decode(p_j, state, jnp.asarray(tok))
            want.append((np.asarray(logits), _state_np(state)))
    bundle = zoo.build(CFG, ctx())
    params = convert.params_from_jax(p_np, device="cpu")
    logits, state = bundle.prefill(params, {"frames": t(frames),
                                            "tokens": t(feeds[0]).long()},
                                   max_len)
    got = [(logits, _state_np(state))]
    for tok in feeds[1:]:
        logits, state = bundle.decode_step(params, state, t(tok).long(),
                                           max_len)
        got.append((logits, _state_np(state)))
    for i, ((lg, st), (lg_j, st_j)) in enumerate(zip(got, want, strict=True)):
        close(lg, lg_j, f"logits after {i} decode steps")
        assert st.keys() == st_j.keys()
        for k in st_j:
            assert st[k].shape == st_j[k].shape, k
            close(st[k], st_j[k], f"state {k} after {i} decode steps")


def test_encdec_serve_run_matches_reference_bundle(monkeypatch):
    """``serve.run --reduced`` (3 requests of 8 frames and a BOS token, 4
    tokens; the context's compute dtype patched to float32) against the
    reference's bundle, prefill then greedy decode, on the weights and
    batch ``serve.setup`` draws (bf16 values, upcast)."""
    make = lm.make_context
    monkeypatch.setattr(lm, "make_context", lambda *a, **k: make(
        *a, **{**k, "compute_dtype": torch.float32}))
    args = serve.parse_args(["--arch", ARCH, "--reduced", "--requests", "3",
                             "--prompt-len", "8", "--gen", "4"])
    out = serve.run(args, device="cpu")
    s = serve.setup(args, "cpu")
    assert s.batch["frames"].shape == (3, 8, CFG.d_model)
    assert torch.equal(s.batch["tokens"], s.tokens[:, 0])
    bundle_j = jzoo.build(CFG_J, CTX_J)
    params_j = jax.tree.map(lambda v: jnp.asarray(v.float().numpy()),
                            s.params)
    batch_j = {k: jnp.asarray(v.numpy()) for k, v in s.batch.items()}
    with MESH:
        logits, state = jax.jit(lambda p, b: bundle_j.prefill(p, b, 12))(
            params_j, batch_j)
        decode = jax.jit(lambda p, st, x: bundle_j.decode_step(p, st, x, 12))
        toks = [np.asarray(jnp.argmax(logits, -1))]
        for _ in range(3):
            logits, state = decode(params_j, state, jnp.asarray(toks[-1]))
            toks.append(np.asarray(jnp.argmax(logits, -1)))
    np.testing.assert_array_equal(out["tokens"].numpy(), np.stack(toks, 1))
    close(out["logits"], logits, "last logits")


def test_convert_takes_the_encdec_tree():
    """The reference's own init converts leaf for leaf onto the port's
    keys and shapes; ``encdec_model.param_count`` is its size, and
    2,034,784,256 at full width."""
    tree = jax.tree.map(np.asarray, jencdec.init_params(
        CFG_J, jax.random.PRNGKey(1), CTX_J, dtype=jnp.float32))
    params = convert.params_from_jax(tree, device="cpu")
    flat_j, flat_t = flat(tree), flat(params)
    assert set(flat_j) == convert.KEYS["encdec"] == set(flat_t)
    for key, leaf in flat_j.items():
        np.testing.assert_array_equal(flat_t[key].numpy(), leaf, err_msg=key)
    own = flat(encdec_model.init_params(CFG, ctx(),
                                        torch.Generator().manual_seed(0)))
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: v.shape for k, v in flat_j.items()}
    assert encdec_model.param_count(CFG) == sum(v.size for v in
                                                flat_j.values())
    assert encdec_model.param_count(get_arch(ARCH)) == 2_034_784_256


def test_encdec_refusals(monkeypatch):
    """A model group and a data group of 2 are taken; a (pod, model)
    axis, ``--continuous`` (the reference's serve refuses it too), both
    engines (the reference's continuous engine too) and ``train.main``
    refuse the family, each naming why."""
    check_group_refusals(CFG, monkeypatch)
    with pytest.raises(SystemExit):
        serve.parse_args(["--arch", ARCH, "--continuous"])
    bundle = zoo.build(CFG, ctx())
    for eng in (ServingEngine, ContinuousServingEngine):
        with pytest.raises(ValueError, match="frame embeddings"):
            eng(bundle, max_batch=2, max_len=16)
    with pytest.raises(ValueError, match="tokens only"):
        train.main(["--arch", ARCH, "--reduced"], device="cpu")
    c = ctx()
    assert c.placement is None and c.dcfg is None
