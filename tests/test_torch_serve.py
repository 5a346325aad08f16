"""The port's lock-step serving path as a whole against the JAX package:
``qwen3-moe-30b-a3b`` reduced, float32, fused_flat, one EP lane.

The same parameters (JAX's ``init_params``, converted leaf by leaf) and the
same prompts go through both prefills; then four greedy decode steps, each
side fed the same tokens.  Tolerance 1e-4 on logits (float32 sums in
another order across two layers and the vocabulary projection).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import make_mesh
from repro.configs import get_arch as jget_arch
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.launch import serve
from repro_torch.models import lm

ARCH = "qwen3-moe-30b-a3b"
TOL = 1e-4


def _jax_side(cfg, tokens, max_len, steps):
    mesh = make_mesh((1, 1), ("data", "model"))
    ctx = dataclasses.replace(
        jlm.make_context(cfg, mesh, multi_pod=False, engine="fused_flat"),
        compute_dtype=jnp.float32)
    params = jlm.init_params(cfg, jax.random.PRNGKey(0), ctx, dtype=jnp.float32)
    s = tokens.shape[1]
    with mesh:
        prefill = jax.jit(lambda p, t: jlm.prefill(p, t, jnp.arange(s), ctx,
                                                   max_len))
        decode = jax.jit(lambda p, st, t: jlm.decode_step(p, st, t, ctx,
                                                          max_len))
        logits, state = prefill(params, jnp.asarray(tokens))
        first = (np.asarray(logits), jax.tree.map(np.asarray, state.kv),
                 int(state.length))
        steps_out = []
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        for _ in range(steps):
            logits, state = decode(params, state, tok)
            steps_out.append((np.asarray(tok), np.asarray(logits)))
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
    return jax.tree.map(np.asarray, params), first, steps_out


@pytest.mark.parametrize("window", [None, 4])
def test_reduced_serve_path_matches_jax(window):
    """window=4 (shorter than the prompt) exercises the ring cache: the
    prefill's rolled extraction and the decode's wrap-around."""
    cfg_j = dataclasses.replace(jget_arch(ARCH).reduced(), window=window)
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), window=window)
    b, s, steps = 3, 8, 4
    max_len = s + steps + 1
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (b, s)).astype(np.int32)
    params_np, (logits_j, kv_j, len_j), steps_j = _jax_side(
        cfg_j, tokens, max_len, steps)

    ctx = lm.make_context(cfg, "cpu", compute_dtype=torch.float32)
    params = convert.params_from_jax(params_np, device="cpu")
    logits, state = lm.prefill(params, torch.from_numpy(tokens).long(),
                               torch.arange(s), ctx, max_len)
    np.testing.assert_allclose(logits.numpy(), logits_j, rtol=TOL, atol=TOL)
    assert state.length == len_j == s
    for name in ("k", "v"):
        assert state.kv[name].shape == kv_j[name].shape
        np.testing.assert_allclose(state.kv[name].numpy(), kv_j[name],
                                   rtol=TOL, atol=TOL)
    for tok_j, step_logits_j in steps_j:
        tok = logits.argmax(-1)
        np.testing.assert_array_equal(tok.numpy(), tok_j)     # greedy tokens
        logits, state = lm.decode_step(params, state, tok, ctx, max_len)
        np.testing.assert_allclose(logits.numpy(), step_logits_j, rtol=TOL,
                                   atol=TOL)
    assert state.length == s + steps


def test_port_params_have_the_reference_tree_and_layouts():
    cfg_j = jget_arch(ARCH).reduced()
    mesh = make_mesh((1, 1), ("data", "model"))
    ctx_j = jlm.make_context(cfg_j, mesh, multi_pod=False, engine="fused_flat")
    shapes_j = jax.eval_shape(
        lambda: jlm.init_params(cfg_j, jax.random.PRNGKey(0), ctx_j))
    ctx = lm.make_context(get_arch(ARCH).reduced(), "cpu")
    params = lm.init_params(ctx.cfg, ctx, torch.Generator().manual_seed(0))
    flat_j = {jax.tree_util.keystr(p): tuple(l.shape) for p, l in
              jax.tree_util.tree_flatten_with_path(shapes_j)[0]}
    flat_t = {}

    def walk(t, path):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + f"[{k!r}]")
            else:
                flat_t[path + f"[{k!r}]"] = tuple(v.shape)
    walk(params, "")
    assert flat_t == flat_j


def test_configs_are_copies_of_the_reference():
    for name in ("qwen3-moe-30b-a3b", "qwen3-1.7b"):
        for mk in (lambda c: c, lambda c: c.reduced()):
            ref = dataclasses.asdict(mk(jget_arch(name)))
            port = dataclasses.asdict(mk(get_arch(name)))
            assert port == {k: ref[k] for k in port}, name


def test_convert_rejects_other_trees_and_serve_flags():
    with pytest.raises(ValueError, match="moe-family"):
        convert.params_from_jax({"embed": np.zeros((4, 2), np.float32)})
    a = serve.parse_args(["--layers", "4", "--requests", "8"])
    assert (a.arch, a.engine, a.layers, a.prompt_len, a.gen) == (
        ARCH, "fused_flat", 4, 64, 16)
    with pytest.raises(SystemExit):
        serve.parse_args(["--engine", "fused_hier"])
    with pytest.raises(NotImplementedError, match="moe only"):
        lm.make_context(get_arch("qwen3-1.7b"), "cpu")
