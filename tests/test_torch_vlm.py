"""The port's ``vlm`` family against the JAX package: ``layers/common.
apply_mrope``, ``layers/attention.attention_block`` in each of its modes,
and reduced ``qwen2-vl-7b`` (2 layers, d 64, 4 / 2 heads of 16, M-RoPE
sections (2, 3, 3)) in float32 on the CPU.

The same inputs and parameters (seeded numpy) go through the reference's
functions and the port's.  The positions are a Qwen2-VL layout scaled to
the reduced size (``zoo.vl_positions``: 3 text tokens, one image frame of
3 x 3 patches sharing one temporal id, then text at the image's largest id
+ 1: the temporal row that masks attention is flat across the image) and
3 x arange.  Through ``models/lm``: the loss and every gradient leaf of
patch embeddings (``embed`` unreached: its gradient all zeros, as
``jax.grad`` gives) through ``steps.value_and_grad``, one AdamW step
against the reference's ``make_train_step`` (``embed`` decayed), the
prefill's logits and cache then three decode steps at both layouts;
``serve.run`` against the reference's bundle on the same weights and
batch; ``convert``; what the family takes and refuses.

Tolerances: the layer functions 1e-5 x max(1, |ref|); the loss, each
gradient leaf, logits and caches 1e-4 relative to max(1, the leaf's max);
the step as ``tests/test_torch_ssm.py`` holds it (``torch_adam``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ssm import (OPT, TOL_LAYER, FamilyCase, check_convert, close,
                            flat, jax_train_side, seeded, t)
from torch_adam import check_step
from repro.layers import attention as jattn
from repro.layers import common as jcommon
from repro.models import lm as jlm
from repro.models import zoo as jzoo
from repro_torch import convert
from repro_torch.launch import serve, steps, train
from repro_torch.layers import attention, common
from repro_torch.models import lm, zoo
from repro_torch.optim import adamw
from repro_torch.serving.engine import (ContinuousServingEngine,
                                        ServingEngine)

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

D, HQ, HKV, HD, THETA = 32, 4, 2, 16, 1e6
SECTIONS = (2, 3, 3)
LAYOUTS = {"image": zoo.vl_positions(3, (3, 3), 4).numpy().astype(np.int32),
           "arange": np.stack([np.arange(16, dtype=np.int32)] * 3)}


def batch_tensors(batch: dict) -> dict:
    """A numpy batch as torch tensors: floats float32, ints int64."""
    return {k: torch.from_numpy(np.asarray(v)).float() if
            np.asarray(v).dtype.kind == "f" else
            torch.from_numpy(np.asarray(v)).long() for k, v in batch.items()}


def test_apply_mrope_matches_reference():
    """(B, S, H, hd) rotated at the image layout (its rows differ) and at
    the per-row (3, B, S) positions of a decode pool."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, HQ, HD)).astype(np.float32)
    pool = np.stack([np.stack([LAYOUTS["image"][r], 5 + np.arange(16)])
                     for r in range(3)]).astype(np.int32)      # (3, 2, 16)
    for pos in (LAYOUTS["image"], pool):
        want = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos), SECTIONS,
                                   THETA)
        got = common.apply_mrope(t(x), t(pos), SECTIONS, THETA)
        close(got, want, f"positions {pos.shape}", TOL_LAYER)


def _block_params(qk_norm: bool) -> dict:
    shapes = {"wq": (D, HQ * HD), "wk": (D, HKV * HD), "wv": (D, HKV * HD),
              "wo": (HQ * HD, D)}
    if qk_norm:
        shapes.update(q_norm=(HD,), k_norm=(HD,))
    return seeded(shapes, 3)


@pytest.mark.parametrize("mode", ["causal-mrope", "causal-rope-window",
                                  "bidirectional", "cross-12-20",
                                  "cross-20-12"])
def test_attention_block_matches_reference(mode):
    """The sub-block on one rank: causal under M-RoPE (mask positions the
    image layout's temporal row) with qk-norm, causal RoPE in a window,
    bidirectional (the encoder's), and cross-attention over (k, v) of
    another length, Sq < Sk and Sq > Sk (the decoder's)."""
    params = _block_params(qk_norm=mode == "causal-mrope")
    rng = np.random.default_rng(4)
    sq = int(mode.split("-")[1]) if mode.startswith("cross") else 16
    sk = int(mode.split("-")[2]) if mode.startswith("cross") else sq
    x = rng.standard_normal((2, sq, D)).astype(np.float32)
    kv = [rng.standard_normal((2, sk, HKV, HD)).astype(np.float32)
          for _ in range(2)]
    kw = dict(n_heads=HQ, n_kv=HKV, head_dim=HD, rope_theta=THETA,
              causal=mode.startswith("causal"), qk_norm=mode == "causal-mrope",
              window=5 if mode.endswith("window") else None)
    if mode == "causal-mrope":
        pos, kw["mrope_sections"] = LAYOUTS["image"], SECTIONS
    else:
        pos = np.arange(sq, dtype=np.int32) + 3
    cross = mode.startswith("cross")
    want = jattn.attention_block(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()},
        positions=jnp.asarray(pos),
        kv_override=tuple(map(jnp.asarray, kv)) if cross else None, **kw)
    got = attention.attention_block(
        t(x), {k: t(v) for k, v in params.items()}, positions=t(pos),
        kv_override=tuple(map(t, kv)) if cross else None, **kw)
    close(got, want, mode, TOL_LAYER)


# ----------------------------------------------- the family through lm ------

class VlmCase(FamilyCase):
    """Reduced qwen2-vl-7b, its batches patch embeddings at a layout."""

    def batch(self, b=2, s=16, seed=0, layout="image") -> dict:
        rng = np.random.default_rng(seed)
        labels = rng.integers(0, self.cfg.vocab, (b, s)).astype(np.int32)
        labels[0, :3] = -1                  # no label: out of the denominator
        return {"embeds": rng.standard_normal((b, s, self.cfg.d_model)
                                              ).astype(np.float32),
                "positions": LAYOUTS[layout], "labels": labels}


VLM = VlmCase("qwen2-vl-7b")


@pytest.fixture(scope="module")
def vlm_train():
    return jax_train_side(VLM)


def test_vlm_loss_and_every_grad_leaf_match_jax(vlm_train):
    """Through ``steps.value_and_grad``: ``embed`` is not in the graph
    under embeddings, and its gradient is zeros, as jax.grad's."""
    want = vlm_train
    model = zoo.build(VLM.cfg, VLM.ctx())
    params = lm_params(want["params"])
    loss, metrics, grads = steps.value_and_grad(model)(
        params, batch_tensors(want["batch"]))
    assert metrics["tokens"] == 2 * 16 - 3
    close(loss, want["loss"], "loss")
    grads = flat(adamw.unflatten(params, grads))
    ref = flat(want["grads"])
    assert grads.keys() == ref.keys()
    assert not grads["embed"].any() and not np.asarray(ref["embed"]).any()
    for k in ref:
        close(grads[k], ref[k], k)


def lm_params(tree) -> dict:
    return convert.params_from_jax(tree, device="cpu")


def test_vlm_train_step_matches_jax_step(vlm_train):
    """One step: loss, clip norm, every updated leaf (``embed`` by its
    weight decay alone), mu, nu and master."""
    want = vlm_train
    model = zoo.build(VLM.cfg, VLM.ctx())
    params = lm_params(want["params"])
    embed0 = params["embed"].clone()
    opt_cfg = adamw.AdamWConfig(**OPT)
    step = steps.make_train_step(model, opt_cfg)
    params, opt, metrics = step(params, steps.init_state(model, params),
                                batch_tensors(want["batch"]))
    close(metrics["loss"], want["step_loss"], "step loss")
    close(metrics["grad_norm"], want["grad_norm"], "grad norm")
    check_step(params, opt, want, opt_cfg, adamw.schedule(opt_cfg, 1), close)
    assert not torch.equal(params["embed"], embed0)


def _state_np(state) -> dict:
    return {"length": np.asarray(state.length).copy(),
            **{f"kv/{k}": np.asarray(v).copy() for k, v in state.kv.items()}}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_vlm_prefill_and_decode_match_jax(layout):
    """Prefill of 3 rows of 16 patch embeddings at the layout (logits, the
    M-RoPE'd cache), then three decode steps fed the same tokens (each at
    its position broadcast to the three rows), the state after each."""
    params_np = VLM.params(1)
    params_j = jax.tree.map(jnp.asarray, params_np)
    rng = np.random.default_rng(7)
    emb = rng.standard_normal((3, 16, VLM.cfg.d_model)).astype(np.float32)
    pos = LAYOUTS[layout]
    feeds = rng.integers(0, VLM.cfg.vocab, (3, 3)).astype(np.int32)
    ctx_j, max_len = VLM.ctx_j, 24
    with VLM.mesh:
        prefill = jax.jit(lambda p, x, q: jlm.prefill(p, x, q, ctx_j,
                                                      max_len))
        decode = jax.jit(lambda p, st, x: jlm.decode_step(p, st, x, ctx_j,
                                                          max_len))
        logits, state = prefill(params_j, jnp.asarray(emb), jnp.asarray(pos))
        want = [(np.asarray(logits), _state_np(state))]
        for tok in feeds:
            logits, state = decode(params_j, state, jnp.asarray(tok))
            want.append((np.asarray(logits), _state_np(state)))
    ctx = VLM.ctx()
    params = lm_params(params_np)
    logits, state = lm.prefill(params, t(emb), t(pos), ctx, max_len)
    got = [(logits, _state_np(state))]
    for tok in feeds:
        logits, state = lm.decode_step(params, state, t(tok).long(), ctx,
                                       max_len)
        got.append((logits, _state_np(state)))
    for i, ((lg, st), (lg_j, st_j)) in enumerate(zip(got, want, strict=True)):
        close(lg, lg_j, f"logits after {i} decode steps")
        assert st.keys() == st_j.keys()
        for k in st_j:
            close(st[k], st_j[k], f"state {k} after {i} decode steps")


def test_vlm_serve_run_matches_reference_bundle(monkeypatch):
    """``serve.run --reduced`` (3 requests of 8 patch embeddings at 3 x
    arange, 4 tokens; the context's compute dtype patched to float32)
    against the reference's bundle, prefill then greedy decode, on the
    weights and batch ``serve.setup`` draws (bf16 values, upcast)."""
    make = lm.make_context
    monkeypatch.setattr(lm, "make_context", lambda *a, **k: make(
        *a, **{**k, "compute_dtype": torch.float32}))
    args = serve.parse_args(["--arch", "qwen2-vl-7b", "--reduced",
                             "--requests", "3", "--prompt-len", "8",
                             "--gen", "4"])
    out = serve.run(args, device="cpu")
    s = serve.setup(args, "cpu")
    assert set(s.batch) == {"embeds", "positions"} and s.tokens is None
    assert s.batch["embeds"].shape == (3, 8, VLM.cfg.d_model)
    np.testing.assert_array_equal(s.positions.numpy(),
                                  np.stack([np.arange(8)] * 3))
    bundle_j = jzoo.build(VLM.cfg_j, VLM.ctx_j)
    params_j = jax.tree.map(lambda v: jnp.asarray(v.float().numpy()),
                            s.params)
    batch_j = {k: jnp.asarray(v.numpy()) for k, v in s.batch.items()}
    with VLM.mesh:
        logits, state = jax.jit(lambda p, b: bundle_j.prefill(p, b, 12))(
            params_j, batch_j)
        decode = jax.jit(lambda p, st, x: bundle_j.decode_step(p, st, x, 12))
        toks = [np.asarray(jnp.argmax(logits, -1))]
        for _ in range(3):
            logits, state = decode(params_j, state, jnp.asarray(toks[-1]))
            toks.append(np.asarray(jnp.argmax(logits, -1)))
    np.testing.assert_array_equal(out["tokens"].numpy(), np.stack(toks, 1))
    close(out["logits"], logits, "last logits")


def test_convert_maps_the_vlm_tree_as_the_dense_one():
    """The reference's vlm tree has the dense family's keys (no q/k norm)
    and converts leaf for leaf; 7,615,487,488 parameters at full width."""
    tree = check_convert(VLM, (7_615_487_488, 0))
    assert set(flat(tree)) == convert.KEYS["dense"] == convert.KEYS["vlm"]


def test_vlm_refusals(monkeypatch):
    """A model group and a data group of 2 are taken (the attention
    head-parallel over the model group, the vocab pair split over it);
    a (pod, model) axis, ``--continuous``, both engines and ``train.main``
    refuse the family, each naming why; tensor parallelism stays off for
    it."""
    check_group_refusals(VLM.cfg, monkeypatch)
    with pytest.raises(SystemExit):
        serve.parse_args(["--arch", "qwen2-vl-7b", "--continuous"])
    bundle = zoo.build(VLM.cfg, VLM.ctx())
    for eng in (ServingEngine, ContinuousServingEngine):
        with pytest.raises(ValueError, match="patch embeddings"):
            eng(bundle, max_batch=2, max_len=16)
    with pytest.raises(ValueError, match="tokens only"):
        train.main(["--arch", "qwen2-vl-7b", "--reduced"], device="cpu")
    assert not VLM.ctx().tp_eligible()


def check_group_refusals(cfg, monkeypatch) -> None:
    """``make_context`` of ``cfg`` takes a model group of 2 (its attention
    the island over it, the vocab pair split over it in training, whole in
    serving, no TP) and a data group of 2 (no island); over a (pod, model)
    axis it raises, naming the queue item."""
    monkeypatch.setattr(lm, "group_size", lambda g: 2 if g == "model" else 1)
    model = lm.make_context(cfg, "cpu", ep_group="model")
    assert lm.island_group(model) == "model" and lm.vocab_parallel(model)
    assert not lm.tensor_parallel(model)
    serving = lm.make_context(cfg, "cpu", ep_group="model", explicit_tp=False,
                              split_vocab=False)
    assert lm.island_group(serving) == "model"
    assert not lm.vocab_parallel(serving)
    data = lm.make_context(cfg, "cpu", mesh=type(
        "Grid", (), dict(data=2, model=1, ep_group=None))())
    assert lm.data_size(data) == 2 and lm.island_group(data) is None
    with pytest.raises(NotImplementedError,
                       match="queue 1 item 8, TP and the vocab split over"):
        lm.make_context(cfg, "cpu", ep_group="model", multi_pod=True,
                        node_size=1)
    monkeypatch.undo()
