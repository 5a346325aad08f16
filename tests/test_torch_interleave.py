"""The port's interleaved micro-batch lanes against the JAX package: K token
lanes round-robin through one cross-layer schedule, each lane's deferred
tail in flight while the next lanes compute (``fusco.layer_stream`` /
``interleaved_layer_stream`` for the attention-free moe_ffn chain,
``fusco.tx_layer_stream`` for the parallel attention+MoE blocks, whose
lanes are batch chunks; ``dcomm.pipe_empty_tails``).

The cases are the reference's ``interleaved_pipe`` and
``tx_interleaved_pipe`` stream cases (``tests/test_engines.py``) and its
interleaved stream gradients (``tests/test_engine_grads.py``), copied here,
at the reduced ``moe-ffn-stream`` and ``moe-tx-stream`` widths (2 layers,
d 64, 8 experts, top-2), K = 2, S 1 and 2: at EP 1 in-process (outputs,
k/v, the traffic state and the gradient of every input and weight against
``jax.vjp``, the reference under ``jax.vmap(..., axis_name="model")``) and
at EP 4 rank by rank on four gloo ranks with autograd off, so that every
lane's tail rides the asynchronous exchange.  Capacity factor 8 (no row is
dropped, so the dense oracles apply).  Tolerance 1e-5, relative to each
tensor's max(1, |x|): float32 sums in another order; counts exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.core import fusco as jfusco
from repro.core import traffic as jtraffic
from repro.core.dcomm import DcommConfig as JDcommConfig
from repro.core.routing import ExpertPlacement as JPlacement
from repro_torch.configs import get_arch
from repro_torch.core import fusco, traffic
from repro_torch.core.dcomm import DcommConfig
from repro_torch.core.routing import ExpertPlacement
from repro_torch.layers.moe import stream_moe_layers, stream_tx_layers

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

FFN = get_arch("moe-ffn-stream").reduced()
TX = get_arch("moe-tx-stream").reduced()
N, D = FFN.n_layers, FFN.d_model
E, K = FFN.moe.n_experts, FFN.moe.top_k
HEADS = dict(n_heads=TX.n_heads, n_kv=TX.n_kv_heads, head_dim=TX.hd,
             rope_theta=TX.rope_theta)
LANES = 2
CF = 8.0
TOL = 1e-5
COUNTS = ("last_expert_count", "steps")
EXPERTS = ("w1", "w3", "w2")
assert (TX.n_layers, TX.d_model, TX.moe.n_experts, TX.moe.top_k) == (N, D, E, K)


def _close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, dtype=np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=what)


def _check_state(got, want, what=""):
    for name in traffic.TrafficState._fields:
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.shape == w.shape, (what, name)
        if name in COUNTS:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")
        else:
            _close(g, w, f"{what} {name}")


def _params(family, seed):
    """A block's stacked weights with ALL experts (N, E, ...): the moe_ffn
    stream's router, experts and pre-norm ``ln``, or the tx blocks' dict."""
    rng = np.random.default_rng(seed)
    w = lambda *s: (rng.standard_normal(s) * s[-2] ** -0.5).astype(np.float32)
    norm = lambda: (1 + 0.1 * rng.standard_normal((N, D))).astype(np.float32)
    f = (FFN if family == "ffn" else TX).moe.d_ff_expert
    p = {"router": w(N, D, E), "w1": w(N, E, D, f), "w3": w(N, E, D, f),
         "w2": w(N, E, f, D)}
    if family == "ffn":
        return {**p, "ln": norm()}
    hq, hkv, hd = TX.n_heads, TX.n_kv_heads, TX.hd
    return {**p, "ln1": norm(), "ln2": norm(), "wq": w(N, D, hq * hd),
            "wk": w(N, D, hkv * hd), "wv": w(N, D, hkv * hd),
            "wo": w(N, hq * hd, D)}


def _x(seed, b, s):
    return np.random.default_rng(seed).standard_normal((b, s, D)).astype(
        np.float32)


def _split(p, ep):
    """(replicated leaves, expert leaves cut into ``ep`` lanes (ep, N,
    E/ep, ...))."""
    rep = {k: v for k, v in p.items() if k not in EXPERTS}
    lanes = {k: np.moveaxis(p[k].reshape(N, ep, E // ep, *p[k].shape[2:]),
                            1, 0) for k in EXPERTS}
    return rep, lanes


def _jax_run(family, ep, p, x, slices, cot=None):
    """The reference's interleaved stream (K = 2, ``stream=True``,
    ``fused_pipe``) on ``ep`` emulated lanes with a cold traffic state:
    each lane's h (its stripe flattened b-major for moe_ffn, (b, S/ep, d)
    for tx), its new state, the tx k/v stacks; with ``cot`` (EP 1) also
    the gradients of x and every weight of ``sum(h * cot)`` (``jax.vjp``)."""
    b, s, _ = x.shape
    placement = JPlacement(n_experts=E, ep=ep, node_size=max(1, ep // 2))
    cfg = JDcommConfig(engine="fused_pipe", ep_axis="model",
                       node_size=placement.node_size, capacity_factor=CF,
                       pipe_slices=slices)
    tr0 = jtraffic.init_traffic_state(E, ep, n_layers=N)
    xl = x.reshape(b, ep, s // ep, D).transpose(1, 0, 2, 3)
    if family == "ffn":
        xl = xl.reshape(ep, -1, D)
    rep, lanes = _split(p, ep)

    def lane(xs, rp, lp):
        observe = lambda st, A: jtraffic.observe(
            st, A, placement, jax.lax.axis_index("model"), decay=0.99,
            axis_names=("model",))
        if family == "ffn":
            h, tr = jfusco.layer_stream(
                xs, rp["router"], lp["w1"], lp["w3"], lp["w2"], placement,
                cfg, K, ln=rp["ln"], stream=True, interleave=LANES,
                traffic=tr0, observe=observe)
            return h, (tr, ())
        h, tr, kv = jfusco.tx_layer_stream(
            xs, jnp.arange(s), {**rp, **lp}, placement, cfg, K, **HEADS,
            stream=True, interleave=LANES, traffic=tr0, observe=observe,
            return_kv=True)
        return h, (tr, kv)

    run = jax.vmap(lane, in_axes=(0, None, 0), axis_name="model")
    args = (jnp.asarray(xl), jax.tree.map(jnp.asarray, rep),
            jax.tree.map(jnp.asarray, lanes))
    if cot is None:
        h, (tr, kv) = jax.jit(run)(*args)
        grads = None
    else:
        def with_grads(*a):
            h, vjp, aux = jax.vjp(run, *a, has_aux=True)
            return h, aux, vjp(jnp.asarray(cot).reshape(h.shape))
        h, (tr, kv), grads = jax.jit(with_grads)(*args)
        gx, grep, glanes = jax.tree.map(np.asarray, grads)
        grads = {"x": gx.reshape(x.shape), **grep,
                 **{k: v[0] for k, v in glanes.items()}}
    return (np.asarray(h), jax.tree.map(np.asarray, tr),
            jax.tree.map(np.asarray, kv), grads)


def _t(tree, grad=False):
    return {k: torch.tensor(np.array(v), requires_grad=grad)
            for k, v in tree.items()}


def _port_run(family, p, x, slices, ep=1, rank=0, group=None, grad=False,
              interleave=LANES, engine="fused_pipe"):
    """The port's stream on this rank's stripe and its lane's experts, with
    a cold traffic state: (h, new state, tx's (k, v) or None, the leaves
    ``h`` was computed from: x and every weight)."""
    b, s, _ = x.shape
    s_l = s // ep
    placement = ExpertPlacement(n_experts=E, ep=ep, node_size=max(1, ep // 2))
    cfg = DcommConfig(engine=engine, capacity_factor=CF, pipe_slices=slices)
    rep, lanes = _split(p, ep)
    leaves = {"x": torch.tensor(np.ascontiguousarray(
        x[:, rank * s_l:(rank + 1) * s_l]), requires_grad=grad),
        **_t(rep, grad), **_t({k: v[rank] for k, v in lanes.items()}, grad)}
    observe = lambda st, A: traffic.observe(st, A, placement, rank,
                                            decay=0.99, group=group)
    tr0 = traffic.init_traffic_state(E, ep, n_layers=N)
    if family == "ffn":
        h, tr = fusco.layer_stream(
            leaves["x"].reshape(-1, D), leaves["router"], leaves["w1"],
            leaves["w3"], leaves["w2"], placement, cfg, K, ln=leaves["ln"],
            interleave=interleave, traffic=tr0, observe=observe, group=group)
        return h, tr, None, leaves
    params = {k: v for k, v in leaves.items() if k != "x"}
    h, tr, kv = fusco.tx_layer_stream(
        leaves["x"], torch.arange(s), params, placement, cfg, K, **HEADS,
        interleave=interleave, traffic=tr0, observe=observe, return_kv=True,
        group=group)
    return h, tr, kv, leaves


def _dense(family, p, x):
    """The port's dense oracle of the whole batch, in the stream's layout."""
    t = _t(p)
    if family == "ffn":
        return fusco.stream_dense_reference(
            torch.from_numpy(x.reshape(-1, D)), t["router"], t["w1"],
            t["w3"], t["w2"], K, ln=t["ln"]).numpy()
    return fusco.tx_dense_reference(torch.from_numpy(x),
                                    torch.arange(x.shape[1]), t, K,
                                    **HEADS).numpy()


@pytest.mark.parametrize("slices", [1, 2])
@pytest.mark.parametrize("family", ["ffn", "tx"])
def test_interleaved_stream_ep1_matches_jax_with_grads(family, slices):
    """K = 2 at EP 1: h, the traffic state (ONE observation a layer, of
    both lanes' routing: every token counted once), tx's k/v (lane j's
    rows at [j b/K, (j+1) b/K)) and the gradient of x and of every weight
    (through each lane's deferred tail) against the reference's; h against
    the dense oracle."""
    p = _params(family, 3)
    x = _x(4, 2, 8)
    cot = _x(5, 2, 8)
    h_j, tr_j, kv_j, g_j = _jax_run(family, 1, p, x, slices, cot)
    h, tr, kv, leaves = _port_run(family, p, x, slices, grad=True)
    _close(h, h_j[0], "h")
    _check_state(tr, jax.tree.map(lambda a: a[0], tr_j), "traffic")
    assert tr.steps.tolist() == [1] * N
    assert tr.last_expert_count.sum(-1).tolist() == [16 * K] * N
    if family == "tx":
        for got, want, name in zip(kv, kv_j, "kv"):
            _close(got, want[0], name)
    _close(h, _dense(family, p, x).reshape(h.shape), "dense oracle")
    (h * torch.from_numpy(cot).reshape(h.shape)).sum().backward()
    assert leaves.keys() == g_j.keys()
    for name, leaf in leaves.items():
        _close(leaf.grad, g_j[name], f"grad {name}")
        assert float(leaf.grad.abs().max()) > 0, name


def _rank_main(rank, world, init_file, data, out_dir):
    """One EP rank, autograd off (each lane's tail an asynchronous exchange
    in flight across the other lane's work): both families' interleaved
    stream at S 2, and through ``stream_moe_layers`` / ``stream_tx_layers``
    with the rank's own lane of the stack."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        d = dict(np.load(data))
        out = {}
        with torch.no_grad():
            for family in ("ffn", "tx"):
                x = d.pop(f"{family} x")
                p = {k.split(" ")[1]: d.pop(k) for k in list(d)
                     if k.startswith(f"{family} ")}
                h, tr, kv, _ = _port_run(family, p, x, 2, world, rank,
                                         dist.group.WORLD)
                out[f"{family} h"] = h.numpy()
                out.update({f"{family} tr {f}": getattr(tr, f).numpy()
                            for f in traffic.TrafficState._fields})
                if kv is not None:
                    out["tx k"], out["tx v"] = kv[0].numpy(), kv[1].numpy()
                s_l = x.shape[1] // world
                stripe = torch.from_numpy(np.ascontiguousarray(
                    x[:, rank * s_l:(rank + 1) * s_l]))
                t = _t(p)
                moe = {"router": t["router"], **{
                    w: t[w].reshape(N, world, E // world, *t[w].shape[2:])[
                        :, rank:rank + 1] for w in EXPERTS}}
                kw = dict(placement=ExpertPlacement(E, world,
                                                    max(1, world // 2)),
                          dcfg=DcommConfig(engine="fused_pipe",
                                           capacity_factor=CF, pipe_slices=2),
                          top_k=K, interleave=LANES, group=dist.group.WORLD)
                if family == "ffn":
                    y = stream_moe_layers(stripe, moe, t["ln"], **kw)
                else:
                    y = stream_tx_layers(
                        stripe, moe, {w: t[w] for w in ("wq", "wk", "wv",
                                                        "wo")},
                        t["ln1"], t["ln2"], positions=torch.arange(x.shape[1]),
                        **HEADS, **kw)
                out[f"{family} y"] = y.numpy()
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def test_interleaved_streams_ep4_gloo_match_jax_rank_by_rank(tmp_path):
    """Four lanes, K = 2 (one batch row a lane), S 2: every rank's h, traffic
    state and tx k/v against the reference's lane, the joined stripes
    against the dense oracle, and the layer functions' outputs equal to
    the stream's."""
    ep, b, s = 4, 2, 16
    data = {}
    cases = {}
    for i, family in enumerate(("ffn", "tx")):
        cases[family] = (_params(family, 5 + i), _x(6 + i, b, s))
        data[f"{family} x"] = cases[family][1]
        data.update({f"{family} {k}": v for k, v in cases[family][0].items()})
    np.savez(tmp_path / "data.npz", **data)
    ranks = mp.spawn(_rank_main, args=(ep, str(tmp_path / "rendezvous"),
                                       str(tmp_path / "data.npz"),
                                       str(tmp_path)),
                     nprocs=ep, join=False)
    want = {f: _jax_run(f, ep, *cases[f], 2) for f in cases}
    while not ranks.join():
        pass
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(ep)]
    for family, (p, x) in cases.items():
        h_j, tr_j, kv_j, _ = want[family]
        for r in range(ep):
            what = f"{family} rank {r}"
            _close(got[r][f"{family} h"], h_j[r], f"{what} h")
            state = traffic.TrafficState(*(got[r][f"{family} tr {f}"] for f in
                                           traffic.TrafficState._fields))
            _check_state(state, jax.tree.map(lambda a: a[r], tr_j), what)
            np.testing.assert_array_equal(
                got[r][f"{family} y"].reshape(-1, D),
                got[r][f"{family} h"].reshape(-1, D), err_msg=what)
            if family == "tx":
                _close(got[r]["tx k"], kv_j[0][r], f"{what} k")
                _close(got[r]["tx v"], kv_j[1][r], f"{what} v")
        joined = h_j.reshape(ep, b, s // ep, D).transpose(1, 0, 2, 3)
        _close(joined.reshape(b, s, D),
               _dense(family, p, x).reshape(b, s, D), f"{family} dense")


@pytest.mark.parametrize("family", ["ffn", "tx"])
def test_one_lane_is_the_plain_stream_and_barriers_ignore_lanes(family):
    """K = 1 through the dispatch is the plain stream bit for bit (moe_ffn:
    ``pipe_layer_stream``); the per-layer barriers ignore ``interleave``
    (the same bits at K = 2); the streamed K = 2 equals K = 1 up to the
    order of the sums."""
    p = _params(family, 8)
    x = _x(9, 2, 8)
    with torch.no_grad():
        one = _port_run(family, p, x, 2, interleave=1)
        two = _port_run(family, p, x, 2)
        _close(two[0], one[0].numpy(), "h, K 2 against K 1")
        if family == "tx":
            for got, want, name in zip(two[2], one[2], "kv"):
                _close(got, want.numpy(), f"{name}, K 2 against K 1")
        else:
            t = _t(p)
            placement = ExpertPlacement(E, 1, 1)
            h, tr = fusco.pipe_layer_stream(
                torch.from_numpy(x.reshape(-1, D)), t["router"],
                *(t[w] for w in EXPERTS), placement,
                DcommConfig(engine="fused_pipe", capacity_factor=CF,
                            pipe_slices=2), K, ln=t["ln"],
                traffic=traffic.init_traffic_state(E, 1, n_layers=N),
                observe=lambda st, A: traffic.observe(st, A, placement, 0))
            assert torch.equal(h, one[0])
            assert all(torch.equal(a, b) for a, b in zip(tr, one[1]))
        flat = [_port_run(family, p, x, 0, interleave=k, engine="fused_flat")
                for k in (1, 2)]
    assert torch.equal(flat[0][0], flat[1][0])
    assert all(torch.equal(a, b) for a, b in zip(flat[0][1], flat[1][1]))


def test_lanes_must_divide_the_tokens_and_the_batch():
    """K must divide the stream's tokens and each rank's batch: the stream
    functions and the layer functions (whatever the engine) raise
    ``ValueError`` before any work."""
    p = {f: _t(_params(f, 0)) for f in ("ffn", "tx")}
    placement = ExpertPlacement(E, 1, 1)
    pipe = DcommConfig(engine="fused_pipe", capacity_factor=CF)
    moe = lambda f: {"router": p[f]["router"],
                     **{w: p[f][w][:, None] for w in EXPERTS}}
    x = torch.zeros((3, 4, D))
    with pytest.raises(ValueError, match="must divide"):
        fusco.layer_stream(x.reshape(-1, D)[:9], p["ffn"]["router"],
                           *(p["ffn"][w] for w in EXPERTS), placement, pipe,
                           K, interleave=2)
    with pytest.raises(ValueError, match="must divide"):
        fusco.tx_layer_stream(x, torch.arange(4), p["tx"], placement, pipe,
                              K, **HEADS, interleave=2)
    for engine in ("fused_flat", "fused_pipe"):
        kw = dict(placement=placement, top_k=K, interleave=2,
                  dcfg=DcommConfig(engine=engine, capacity_factor=CF))
        with pytest.raises(ValueError, match="must divide"):
            stream_moe_layers(x, moe("ffn"), p["ffn"]["ln"], **kw)
        with pytest.raises(ValueError, match="must divide"):
            stream_tx_layers(x, moe("tx"), {w: p["tx"][w] for w in
                                            ("wq", "wk", "wv", "wo")},
                             p["tx"]["ln1"], p["tx"]["ln2"],
                             positions=torch.arange(4), **HEADS, **kw)
