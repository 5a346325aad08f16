"""The port's attention-separated ``moe_tx`` stream against the JAX package:
``fusco.tx_attention``, ``fusco.tx_layer_stream`` (per-layer barriers with
``fused_flat``, and the streamed K = 1 schedule of ``fused_pipe``),
``layers/moe.stream_tx_layers`` and the reduced ``moe-tx-stream`` serve
path (``fused_flat``, and ``fused_pipe`` in stream blocks of 2).

EP = 1 runs in-process; EP = 4 runs four gloo ranks, each holding its stripe
of the sequence and its lane's experts, compared rank by rank with the JAX
stream under ``jax.vmap(..., axis_name="model")`` (the emulated EP axis of
``tests/test_torch_moe.py``): this checks the k/v all-gather and the shifted
query positions of each stripe.  float32; tolerance 1e-5 for one block
stack, 1e-4 for the whole model (sums in another order across layers and
the vocabulary projection).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.compat import make_mesh
from repro.configs import get_arch as jget_arch
from repro.core import fusco as jfusco
from repro.core.dcomm import DcommConfig as JDcommConfig
from repro.core.routing import ExpertPlacement as JPlacement
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core import dcomm, fusco
from repro_torch.core.dcomm import DcommConfig
from repro_torch.core.routing import ExpertPlacement
from repro_torch.layers.moe import stream_tx_layers
from repro_torch.models import lm

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

ARCH = "moe-tx-stream"
CFG = get_arch(ARCH).reduced()        # d 64, 4/2 heads, hd 16, 8 experts top-2
N, D, HQ, HKV, HD = CFG.n_layers, CFG.d_model, CFG.n_heads, CFG.n_kv_heads, CFG.hd
E, K, F = CFG.moe.n_experts, CFG.moe.top_k, CFG.moe.d_ff_expert
HEADS = dict(n_heads=HQ, n_kv=HKV, head_dim=HD, rope_theta=CFG.rope_theta)
CF = 8.0          # no capacity drops: the dense oracle applies
TOL = 1e-5
TOL_MODEL = 1e-4


def _params(seed):
    """Stacked block weights, ALL experts: the JAX layout of
    ``tx_dense_reference`` (w1/w3 (N, E, d, f), w2 (N, E, f, d))."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    w = lambda *s: (rng.standard_normal(s) * s[-2] ** -0.5).astype(f32)
    return {"ln1": (1 + 0.1 * rng.standard_normal((N, D))).astype(f32),
            "wq": w(N, D, HQ * HD), "wk": w(N, D, HKV * HD),
            "wv": w(N, D, HKV * HD), "wo": w(N, HQ * HD, D),
            "ln2": (1 + 0.1 * rng.standard_normal((N, D))).astype(f32),
            "router": w(N, D, E), "w1": w(N, E, D, F), "w3": w(N, E, D, F),
            "w2": w(N, E, F, D)}


def _lanes(p, ep):
    """Expert weights split into ``ep`` lanes: (ep, N, E_local, ...)."""
    return {k: np.moveaxis(p[k].reshape(N, ep, E // ep, *p[k].shape[2:]), 1, 0)
            for k in ("w1", "w3", "w2")}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _jax_stream(ep, p, x, cf=CF, engine="fused_flat", slices=0):
    """JAX ``tx_layer_stream`` on ``ep`` emulated lanes: per-layer barriers
    for ``fused_flat``, the streamed schedule for ``fused_pipe``.  x: (b, S,
    d) -> h (ep, b, S/ep, d) and the gathered k/v stacks of each lane (ep,
    N, b, S, Hkv, hd)."""
    b, s, _ = x.shape
    placement = JPlacement(n_experts=E, ep=ep, node_size=max(1, ep // 2))
    cfg = JDcommConfig(engine=engine, ep_axis="model",
                       node_size=placement.node_size, capacity_factor=cf,
                       pipe_slices=slices)
    rep = {k: jnp.asarray(v) for k, v in p.items() if k not in ("w1", "w3", "w2")}
    lanes = _lanes(p, ep)
    xl = x.reshape(b, ep, s // ep, D).transpose(1, 0, 2, 3)

    def fn(xs, w1, w3, w2):
        return jfusco.tx_layer_stream(
            xs, jnp.arange(s), {**rep, "w1": w1, "w3": w3, "w2": w2},
            placement, cfg, K, **HEADS, stream=engine == "fused_pipe",
            return_kv=True)

    h, (k, v) = jax.jit(jax.vmap(fn, axis_name="model"))(
        jnp.asarray(xl), *(jnp.asarray(lanes[w]) for w in ("w1", "w3", "w2")))
    return np.asarray(h), np.asarray(k), np.asarray(v)


def _x(seed, b, s):
    return np.random.default_rng(seed).standard_normal((b, s, D)).astype(np.float32)


@pytest.mark.parametrize("offset", [0, 4])
def test_tx_attention_ep1_matches_jax(offset):
    """One lane: k/v are the stripe's own; RoPE and the mask read the
    absolute positions, here offset from 0."""
    p = _params(0)
    x = _x(1, 2, 8)
    lp = {k: v[0] for k, v in p.items()}
    pos = np.arange(offset, offset + 8)
    want, (kj, vj) = jfusco.tx_attention(
        jnp.asarray(x), jax.tree.map(jnp.asarray, lp), jnp.asarray(pos),
        jnp.asarray(pos), **HEADS, return_kv=True)
    got, (kt, vt) = fusco.tx_attention(
        torch.from_numpy(x), _t(lp), torch.from_numpy(pos),
        torch.from_numpy(pos), **HEADS, return_kv=True)
    for a, b_ in ((got, want), (kt, kj), (vt, vj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=TOL, atol=TOL)


def test_tx_layer_stream_ep1_matches_jax_and_dense():
    p = _params(3)
    x = _x(4, 2, 8)
    h_j, k_j, v_j = _jax_stream(1, p, x)
    placement = ExpertPlacement(n_experts=E, ep=1, node_size=1)
    cfg = DcommConfig(engine="fused_flat", capacity_factor=CF)
    h, (k, v) = fusco.tx_layer_stream(
        torch.from_numpy(x), torch.arange(8), _t(p), placement, cfg, K,
        **HEADS, return_kv=True)
    np.testing.assert_allclose(h.numpy(), h_j[0], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(k.numpy(), k_j[0], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(v.numpy(), v_j[0], rtol=TOL, atol=TOL)
    dense = fusco.tx_dense_reference(torch.from_numpy(x), torch.arange(8),
                                     _t(p), K, **HEADS)
    dense_j = jfusco.tx_dense_reference(jnp.asarray(x), jnp.arange(8),
                                        jax.tree.map(jnp.asarray, p), K, **HEADS)
    np.testing.assert_allclose(dense.numpy(), np.asarray(dense_j), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(h.numpy(), dense.numpy(), rtol=TOL, atol=TOL)


def _plain_rank(rank, world, d: dict) -> dict:
    """One EP rank's stripe and its lane's experts through the tx stream,
    directly and through ``layers/moe.stream_tx_layers``."""
    x = torch.from_numpy(d.pop("x"))
    s_l = x.shape[1] // world
    stripe = x[:, rank * s_l:(rank + 1) * s_l]
    positions = torch.arange(x.shape[1])
    placement = ExpertPlacement(n_experts=E, ep=world,
                                node_size=max(1, world // 2))
    cfg = DcommConfig(engine="fused_flat", capacity_factor=CF)
    p = _t(d)
    lane = {w: p[w].reshape(N, world, E // world, *p[w].shape[2:])
            for w in ("w1", "w3", "w2")}
    group = dist.group.WORLD
    h, (k, v) = fusco.tx_layer_stream(
        stripe, positions, {**p, **{w: lane[w][:, rank] for w in lane}},
        placement, cfg, K, **HEADS, return_kv=True,
        group=group)
    y = stream_tx_layers(
        stripe, {"router": p["router"],
                 **{w: t[:, rank:rank + 1] for w, t in lane.items()}},
        {w: p[w] for w in ("wq", "wk", "wv", "wo")}, p["ln1"], p["ln2"],
        placement=placement, dcfg=cfg, top_k=K, positions=positions,
        **HEADS, group=group)
    return {"h": h.numpy(), "k": k.numpy(), "v": v.numpy(), "y": y.numpy()}


def _streamed_rank(rank, world, d: dict) -> dict:
    """One EP rank's stripe through the streamed fused_pipe schedule at
    S = 1 and 4, through ``stream_tx_layers``."""
    x = torch.from_numpy(d.pop("x"))
    s_l = x.shape[1] // world
    placement = ExpertPlacement(n_experts=E, ep=world,
                                node_size=max(1, world // 2))
    p = _t(d)
    lane = {w: p[w].reshape(N, world, E // world, *p[w].shape[2:])
            for w in ("w1", "w3", "w2")}
    out = {}
    for slices in (1, 4):
        h, (k, v) = stream_tx_layers(
            x[:, rank * s_l:(rank + 1) * s_l],
            {"router": p["router"],
             **{w: t[:, rank:rank + 1] for w, t in lane.items()}},
            {w: p[w] for w in ("wq", "wk", "wv", "wo")}, p["ln1"], p["ln2"],
            placement=placement,
            dcfg=DcommConfig(engine="fused_pipe", capacity_factor=CF,
                             pipe_slices=slices),
            top_k=K, positions=torch.arange(x.shape[1]), **HEADS,
            return_kv=True, group=dist.group.WORLD)
        out.update({f"h{slices}": h.numpy(), f"k{slices}": k.numpy(),
                    f"v{slices}": v.numpy()})
    return out


def _rank_main(rank, world, init_file, data, out_dir):
    """One EP rank of the module's spawn: ``data``'s "plain/" inputs through
    :func:`_plain_rank`, its "streamed/" inputs through
    :func:`_streamed_rank`."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        d = dict(np.load(data))
        cut = lambda prefix: {k[len(prefix):]: v for k, v in d.items()
                              if k.startswith(prefix)}
        out = {"plain/" + k: v for k, v in _plain_rank(
            rank, world, cut("plain/")).items()}
        out.update({"streamed/" + k: v for k, v in _streamed_rank(
            rank, world, cut("streamed/")).items()})
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


EP4, EP4_B, EP4_S = 4, 2, 16


@pytest.fixture(scope="module")
def ep4_ranks(tmp_path_factory):
    """One spawn of four gloo ranks for both EP = 4 tests: their inputs
    (the plain stream's and the streamed one's) and each rank's arrays."""
    tmp = tmp_path_factory.mktemp("tx_ep4")
    inputs = {"plain": (_params(5), _x(6, EP4_B, EP4_S)),
              "streamed": (_params(9), _x(10, EP4_B, EP4_S))}
    np.savez(tmp / "data.npz", **{f"{n}/{k}": v for n, (p, x) in inputs.items()
                                  for k, v in {**p, "x": x}.items()})
    mp.spawn(_rank_main, args=(EP4, str(tmp / "rendezvous"),
                               str(tmp / "data.npz"), str(tmp)),
             nprocs=EP4, join=True)
    return inputs, [np.load(tmp / f"rank{r}.npz") for r in range(EP4)]


def test_tx_layer_stream_ep4_gloo_matches_jax_rank_by_rank(ep4_ranks):
    ep, b, s = EP4, EP4_B, EP4_S
    inputs, ranks = ep4_ranks
    p, x = inputs["plain"]
    h_j, k_j, v_j = _jax_stream(ep, p, x)
    for r in range(ep):
        got = ranks[r]
        for name, want in (("h", h_j[r]), ("y", h_j[r]), ("k", k_j[r]),
                           ("v", v_j[r])):
            np.testing.assert_allclose(got["plain/" + name], want, rtol=TOL,
                                       atol=TOL, err_msg=f"rank {r} {name}")
    dense = jfusco.tx_dense_reference(jnp.asarray(x), jnp.arange(s),
                                      jax.tree.map(jnp.asarray, p), K, **HEADS)
    joined = h_j.transpose(1, 0, 2, 3).reshape(b, s, D)
    np.testing.assert_allclose(joined, np.asarray(dense), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("slices", [1, 4])
def test_streamed_tx_layer_stream_ep1_matches_jax(slices):
    """fused_pipe's streamed schedule: each layer's tail combine lands in the
    next layer's prologue (the last in the epilogue)."""
    p = _params(7)
    x = _x(8, 2, 8)
    h_j, k_j, v_j = _jax_stream(1, p, x, engine="fused_pipe", slices=slices)
    placement = ExpertPlacement(n_experts=E, ep=1, node_size=1)
    cfg = DcommConfig(engine="fused_pipe", capacity_factor=CF,
                      pipe_slices=slices)
    h, (k, v) = fusco.tx_layer_stream(
        torch.from_numpy(x), torch.arange(8), _t(p), placement, cfg, K,
        **HEADS, return_kv=True)
    for got, want in ((h, h_j[0]), (k, k_j[0]), (v, v_j[0])):
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    dense = fusco.tx_dense_reference(torch.from_numpy(x), torch.arange(8),
                                     _t(p), K, **HEADS)
    np.testing.assert_allclose(h.numpy(), dense.numpy(), rtol=TOL, atol=TOL)


def test_streamed_tx_layer_stream_ep4_gloo_matches_jax_rank_by_rank(
        ep4_ranks):
    inputs, got = ep4_ranks
    p, x = inputs["streamed"]
    for slices in (1, 4):
        h_j, k_j, v_j = _jax_stream(EP4, p, x, engine="fused_pipe",
                                    slices=slices)
        for r in range(EP4):
            for name, want in (("h", h_j[r]), ("k", k_j[r]), ("v", v_j[r])):
                np.testing.assert_allclose(
                    got[r][f"streamed/{name}{slices}"], want, rtol=TOL,
                    atol=TOL, err_msg=f"S {slices} rank {r} {name}")


def test_tx_stream_raises_on_what_is_not_ported(monkeypatch):
    """Interleaved micro-batch lanes run through both engines (the streamed
    fused_pipe and fused_flat's barriers, which ignore them) and equal the
    plain stream; FSDP of the expert weights over a data group of one rank
    (a stand-in group) is the identity, with no collective (the grid is
    ``tests/test_torch_fsdp.py``'s); expert weights of more than one lane
    raise (a rank holds its own)."""
    p = _t(_params(0))
    x = torch.from_numpy(_x(2, 2, 4))
    placement = ExpertPlacement(n_experts=E, ep=1, node_size=1)
    for cfg in (DcommConfig(engine="fused_pipe", capacity_factor=CF),
                DcommConfig(capacity_factor=CF)):
        one, two = (fusco.tx_layer_stream(x, torch.arange(4), p, placement,
                                          cfg, K, **HEADS, interleave=k)
                    for k in (1, 2))
        np.testing.assert_allclose(two.numpy(), one.numpy(), rtol=TOL,
                                   atol=TOL, err_msg=cfg.engine)
    moe = {"router": p["router"],
           **{w: p[w][:, None] for w in ("w1", "w3", "w2")}}
    attn = {w: p[w] for w in ("wq", "wk", "wv", "wo")}
    kw = dict(placement=placement, dcfg=DcommConfig(capacity_factor=CF),
              top_k=K, positions=torch.arange(4), **HEADS)
    plain = stream_tx_layers(x, moe, attn, p["ln1"], p["ln2"], **kw)
    data = object()
    monkeypatch.setattr(dist, "get_world_size",
                        lambda group=None: 1 if group is data else 2)
    with dcomm.collective_calls() as calls:
        fsdp = stream_tx_layers(x, moe, attn, p["ln1"], p["ln2"], fsdp=data,
                                **kw)
    assert calls == []
    np.testing.assert_array_equal(fsdp.numpy(), plain.numpy())
    monkeypatch.undo()
    lanes = {**moe, **{w: p[w].reshape(N, 2, E // 2, *p[w].shape[2:])
                       for w in ("w1", "w3", "w2")}}
    with pytest.raises(ValueError, match="own lane"):
        stream_tx_layers(x, lanes, attn, p["ln1"], p["ln2"], **kw)


def _jax_serve(cfg, tokens, max_len, steps, engine="fused_flat",
               moe_stream=0):
    mesh = make_mesh((1, 1), ("data", "model"))
    ctx = dataclasses.replace(
        jlm.make_context(cfg, mesh, multi_pod=False, engine=engine,
                         moe_stream=moe_stream),
        compute_dtype=jnp.float32)
    params = jlm.init_params(cfg, jax.random.PRNGKey(0), ctx, dtype=jnp.float32)
    s = tokens.shape[1]
    with mesh:
        prefill = jax.jit(lambda p, t: jlm.prefill(p, t, jnp.arange(s), ctx,
                                                   max_len))
        decode = jax.jit(lambda p, st, t: jlm.decode_step(p, st, t, ctx,
                                                          max_len))
        logits, state = prefill(params, jnp.asarray(tokens))
        first = (np.asarray(logits), jax.tree.map(np.asarray, state.kv))
        steps_out = []
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        for _ in range(steps):
            logits, state = decode(params, state, tok)
            steps_out.append((np.asarray(tok), np.asarray(logits),
                              jax.tree.map(np.asarray, state.kv)))
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
    return jax.tree.map(np.asarray, params), first, steps_out


def test_reduced_moe_tx_serve_path_matches_jax():
    """``lm.prefill`` + three ``decode_step``s of the reduced moe-tx-stream,
    fed the same tokens, against the JAX package on a (1, 1) mesh."""
    b, s, steps = 3, 8, 3
    max_len = s + steps + 1
    tokens = np.random.default_rng(0).integers(0, CFG.vocab, (b, s)).astype(np.int32)
    params_np, (logits_j, kv_j), steps_j = _jax_serve(
        jget_arch(ARCH).reduced(), tokens, max_len, steps)

    ctx = lm.make_context(CFG, "cpu", compute_dtype=torch.float32)
    params = convert.params_from_jax(params_np, device="cpu")
    logits, state = lm.prefill(params, torch.from_numpy(tokens).long(),
                               torch.arange(s), ctx, max_len)
    np.testing.assert_allclose(logits.numpy(), logits_j, rtol=TOL_MODEL,
                               atol=TOL_MODEL)
    for name in ("k", "v"):
        np.testing.assert_allclose(state.kv[name].numpy(), kv_j[name],
                                   rtol=TOL_MODEL, atol=TOL_MODEL)
    for tok_j, step_logits_j, step_kv_j in steps_j:
        tok = logits.argmax(-1)
        np.testing.assert_array_equal(tok.numpy(), tok_j)
        logits, state = lm.decode_step(params, state, tok, ctx, max_len)
        np.testing.assert_allclose(logits.numpy(), step_logits_j,
                                   rtol=TOL_MODEL, atol=TOL_MODEL)
        for name in ("k", "v"):
            np.testing.assert_allclose(state.kv[name].numpy(), step_kv_j[name],
                                       rtol=TOL_MODEL, atol=TOL_MODEL)
    assert state.length == s + steps


def test_reduced_moe_tx_streamed_serve_path_matches_jax():
    """The reduced moe-tx-stream served as ``--engine fused_pipe
    --moe-stream 2`` (its two layers in one streamed block, pipesim's slice
    count on each side): prefill logits and caches against the JAX package
    with the same engine and block, then ``serve.run`` of those flags on the
    CPU gives in-vocabulary tokens and finite logits."""
    from repro_torch.launch import serve
    b, s = 3, 8
    max_len = s + 2
    tokens = np.random.default_rng(2).integers(0, CFG.vocab, (b, s)).astype(np.int32)
    params_np, (logits_j, kv_j), _ = _jax_serve(
        jget_arch(ARCH).reduced(), tokens, max_len, 0, engine="fused_pipe",
        moe_stream=2)
    argv = ["--arch", ARCH, "--reduced", "--engine", "fused_pipe",
            "--moe-stream", "2", "--requests", str(b), "--prompt-len", str(s),
            "--gen", "2"]
    args = serve.parse_args(argv)
    ctx = lm.make_context(CFG, "cpu", engine=args.engine,
                          moe_stream=args.moe_stream,
                          compute_dtype=torch.float32)
    params = convert.params_from_jax(params_np, device="cpu")
    logits, state = lm.prefill(params, torch.from_numpy(tokens).long(),
                               torch.arange(s), ctx, max_len)
    np.testing.assert_allclose(logits.numpy(), logits_j, rtol=TOL_MODEL,
                               atol=TOL_MODEL)
    for name in ("k", "v"):
        np.testing.assert_allclose(state.kv[name].numpy(), kv_j[name],
                                   rtol=TOL_MODEL, atol=TOL_MODEL)
    out = serve.run(args, device="cpu")
    assert out["tokens"].shape == (b, 2)
    assert bool(((out["tokens"] >= 0) & (out["tokens"] < CFG.vocab)).all())
    assert bool(torch.isfinite(out["logits"]).all())
    with pytest.raises(ValueError, match="must divide"):
        lm.prefill(params, torch.from_numpy(tokens).long(), torch.arange(s),
                   dataclasses.replace(ctx, moe_stream=3), max_len)


def test_convert_takes_the_jax_moe_tx_tree():
    """The reference's moe_tx tree (the moe family's keys without q/k norms)
    converts leaf for leaf, and the port's own init builds the same tree."""
    cfg_j = jget_arch(ARCH).reduced()
    mesh = make_mesh((1, 1), ("data", "model"))
    ctx_j = jlm.make_context(cfg_j, mesh, multi_pod=False, engine="fused_flat")
    tree = jax.tree.map(np.asarray, jlm.init_params(
        cfg_j, jax.random.PRNGKey(1), ctx_j, dtype=jnp.float32))
    assert "q_norm" not in tree["layers"]["attn"]
    params = convert.params_from_jax(tree, device="cpu")
    flat_j = {jax.tree_util.keystr(p): l for p, l in
              jax.tree_util.tree_flatten_with_path(tree)[0]}
    flat_t = {jax.tree_util.keystr(p): l for p, l in
              jax.tree_util.tree_flatten_with_path(
                  params, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]}
    assert flat_t.keys() == flat_j.keys()
    for key, leaf in flat_j.items():
        np.testing.assert_array_equal(flat_t[key].numpy(), leaf, err_msg=key)
    ctx = lm.make_context(CFG, "cpu")
    own = lm.init_params(CFG, ctx, torch.Generator().manual_seed(0))
    shapes = {jax.tree_util.keystr(p): tuple(l.shape) for p, l in
              jax.tree_util.tree_flatten_with_path(
                  own, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]}
    assert shapes == {k: v.shape for k, v in flat_j.items()}
