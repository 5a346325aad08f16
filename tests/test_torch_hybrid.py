"""The port's ``hybrid`` family against the JAX package:
``layers/hybrid.hymba_mixer`` (Hymba's parallel attention and SSM heads),
the windowed ``decode_attention``, and reduced ``hymba-1.5b`` (2 layers:
layer 0 global, layer 1 a 16-token window; d 64, 4 / 2 heads of 16, the
SSM branch in 16 heads of 8) in float32 on the CPU.

The same inputs and parameters (seeded numpy) go through the reference's
functions and the port's: the mixer on a global layer, on a windowed layer
whose window binds (S 32), and a decode step of each from a cache whose
rows sit at their own lengths.  Through ``models/lm``, as
``tests/test_torch_ssm.py`` holds the ssm family (its ``check_*``
functions): the loss and every gradient leaf, one AdamW step, the prefill
(24 tokens: the window binds) and its whole decode state then four decode
steps, the continuous engine's streams, ``convert``, the refusals; then a
checkpoint of reduced hymba saved by the port and restored by the
reference (and back), bit for bit.  (The step over a data group is
``tests/test_torch_ssm.py``'s, for both families.)

Tolerances: as ``tests/test_torch_ssm.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ssm import (MIXER, FamilyCase, check_continuous_streams,
                            check_convert, check_loss_and_grads,
                            check_prefill_and_decode, check_refusals,
                            check_train_step, close, flat, jax_train_side,
                            jit, mixer_params, seeded, t, TOL_LAYER)
from repro.checkpoint import checkpointer as jckpt
from repro.layers import attention as jattn
from repro.layers import hybrid as jhybrid
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.checkpoint import checkpointer
from repro_torch.layers import attention, hybrid
from repro_torch.optim import adamw

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

HYBRID = FamilyCase("hymba-1.5b")
D, HQ, HKV, HD, WINDOW = 32, 4, 2, 8, 16
SSM_ARGS = dict(MIXER, d_inner=2 * D, n_heads=2 * D // 8, n_groups=1)


def _layer_params(seed: int) -> dict:
    """One Hymba layer's seeded leaves (numpy, nested)."""
    tree = seeded({"wq": (D, HQ * HD), "wk": (D, HKV * HD),
                   "wv": (D, HKV * HD), "wo": (HQ * HD, D),
                   "attn_out_norm": (D,), "ssm_out_norm": (D,)}, seed)
    return {"attn": {k: tree[k] for k in ("wq", "wk", "wv", "wo")},
            "ssm": mixer_params(D, seed + 1, SSM_ARGS),
            "attn_out_norm": tree["attn_out_norm"],
            "ssm_out_norm": tree["ssm_out_norm"]}


def _to(tree, fn):
    return {k: _to(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("is_global", [True, False])
def test_hymba_mixer_prefill_and_step_match_reference(is_global):
    """32 tokens through the mixer (a windowed layer's window of 16 binds),
    then one decode step of each row from a 40-slot cache at lengths 20 and
    33 (the windowed layer masks the slots older than 16) and a state."""
    params = _layer_params(5)
    jp, tp = _to(params, jnp.asarray), _to(params, t)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 32, D)).astype(np.float32)
    common = dict(n_heads=HQ, n_kv=HKV, head_dim=HD, rope_theta=1e4)

    def mixer(x_, p_, pos):
        return jhybrid.hymba_mixer(x_, p_, positions=pos, window=WINDOW,
                                   is_global=is_global, ssm_args=SSM_ARGS,
                                   **common)[::2]

    y_j, st_j = jit(mixer, jnp.asarray(x), jp, jnp.arange(32))
    window = None if is_global else WINDOW
    y, (k, v), st = hybrid.hymba_mixer(t(x), tp, positions=torch.arange(32),
                                       window=window, ssm_args=SSM_ARGS,
                                       **common)
    close(y, y_j, "y", TOL_LAYER)
    close(st.ssd, st_j.ssd, "ssd state", TOL_LAYER)
    close(st.conv, st_j.conv, "conv inputs", TOL_LAYER)
    # the prefill's cache entries are the RoPE'd k and v of the reference's
    # second projection
    q_j, k_j, v_j = jattn.gqa_project(jnp.asarray(x), jp["attn"]["wq"],
                                      jp["attn"]["wk"], jp["attn"]["wv"], HQ,
                                      HKV, HD)
    from repro.layers.common import apply_rope
    close(k, apply_rope(k_j, jnp.arange(32), 1e4), "k", TOL_LAYER)
    close(v, v_j, "v", TOL_LAYER)

    lengths = np.array([20, 33], np.int32)
    kc = rng.standard_normal((2, 40, HKV, HD)).astype(np.float32)
    vc = rng.standard_normal((2, 40, HKV, HD)).astype(np.float32)
    x1 = x[:, :1]

    def step(x_, p_, kc_, vc_, len_, ssd, conv):
        cache = jattn.KVCache(kc_, vc_, len_, 40)
        y_, c_, s_ = jhybrid.hymba_mixer(
            x_, p_, positions=len_[:, None], window=WINDOW,
            is_global=is_global, ssm_args=SSM_ARGS, attn_cache=cache,
            ssm_state=jhybrid.SsmState(ssd, conv), single_step=True, **common)
        return y_, c_.k, c_.v, s_.ssd, s_.conv

    want = jit(step, jnp.asarray(x1), jp, jnp.asarray(kc), jnp.asarray(vc),
               jnp.asarray(lengths), st_j.ssd, st_j.conv)
    cache = attention.KVCache(t(kc), t(vc), t(lengths), 40)
    y, cache, st2 = hybrid.hymba_mixer(
        t(x1), tp, positions=t(lengths).long()[:, None], window=window,
        ssm_args=SSM_ARGS, attn_cache=cache, ssm_state=st, single_step=True,
        **common)
    for got, w, what in zip((y, cache.k, cache.v, st2.ssd, st2.conv), want,
                            ("y", "cache k", "cache v", "ssd", "conv")):
        close(got, w, f"step {what}", TOL_LAYER)


@pytest.mark.parametrize("window", [None, 10, 30])
def test_windowed_decode_attention_matches_reference(window):
    """Rows at lengths 0 (a free slot), 5, 23 and 57 of a 24-slot ring
    (the last wrapped twice): ``window_len`` masks the slots older than
    it, as the reference's."""
    rng = np.random.default_rng(8)
    q = rng.standard_normal((4, 1, HQ, HD)).astype(np.float32)
    kc = rng.standard_normal((4, 24, HKV, HD)).astype(np.float32)
    vc = rng.standard_normal((4, 24, HKV, HD)).astype(np.float32)
    lengths = np.array([0, 5, 23, 57], np.int32)
    want = jattn.decode_attention(
        jnp.asarray(q), jattn.KVCache(jnp.asarray(kc), jnp.asarray(vc),
                                      jnp.asarray(lengths), 64),
        window_len=window)
    got = attention.decode_attention(
        t(q), attention.KVCache(t(kc), t(vc), t(lengths), 64),
        window_len=window)
    close(got, want, f"window {window}", TOL_LAYER)


@pytest.fixture(scope="module")
def hymba_train():
    return jax_train_side(HYBRID)


def test_hymba_lm_loss_and_every_grad_leaf_match_jax(hymba_train):
    check_loss_and_grads(HYBRID, hymba_train)


def test_hymba_train_step_matches_jax_step(hymba_train):
    check_train_step(HYBRID, hymba_train)


def test_hymba_prefill_state_and_decode_steps_match_jax():
    """24 tokens (layer 1's window of 16 binds in the prefill and in every
    decode step), a cache of every position in both layers."""
    check_prefill_and_decode(HYBRID, prompt=24, max_len=32)


def test_hymba_continuous_streams_match_reference_engine():
    check_continuous_streams(HYBRID)


def test_hymba_convert_and_param_counts():
    tree = check_convert(HYBRID, (1_640_871_296, 0))
    assert set(tree["layers"]) == {"ln1", "ln2", "attn", "mlp", "ssm",
                                   "attn_out_norm", "ssm_out_norm"}


def test_hymba_refusals(monkeypatch):
    check_refusals(HYBRID, monkeypatch)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def test_hymba_checkpoint_saved_by_the_port_restores_in_the_reference(tmp_path):
    """The reference's bf16 hymba tree and its AdamW state: the port's save
    restores in the reference bit for bit (its leaves in the reference's
    flattening order), and restores in the port."""
    tree = jlm.init_params(HYBRID.cfg_j, jax.random.PRNGKey(2), HYBRID.ctx_j,
                           dtype=jnp.bfloat16)
    jstate = (tree, jadamw.init(tree))
    params = convert.params_from_jax(jax.tree.map(np.asarray, tree),
                                     device="cpu")
    port = (params, adamw.init(params))
    checkpointer.wait(checkpointer.save(str(tmp_path), port, 3))
    got, step = jckpt.restore(str(tmp_path), jax.tree.map(jnp.zeros_like,
                                                          jstate))
    assert step == 3
    want = jax.tree.leaves(jstate)
    assert len(jax.tree.leaves(got)) == len(want)
    for i, (a, b) in enumerate(zip(jax.tree.leaves(got), want)):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f"leaf {i}")
    like = (adamw.tree_map(torch.zeros_like, params),
            adamw.init(adamw.tree_map(torch.zeros_like, params)))
    back, step = checkpointer.restore(str(tmp_path), like)
    assert step == 3
    for path, a in flat(back[0]).items():
        np.testing.assert_array_equal(_bits(a), _bits(flat(params)[path]),
                                      err_msg=path)
