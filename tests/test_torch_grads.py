"""Gradients of the port against the JAX package, and its grouped matmul.

- ``grouped_matmul``: the plain version (what the CPU runs) against the
  Pallas kernel in interpret mode and the jnp reference, with empty, partial
  and full groups and poison rows past the counts; the CUDA wrapper against
  its C signature.
- Each ``torch.autograd.Function`` of ``kernels/ops.py`` against the JAX
  VJP of ``repro.kernels.ops`` on the same cotangent: gather, scatter-add
  (dsrc and dgates), the fused SwiGLU (dx, dw1, dw3, dw2), and the flash
  attention against ``jax.grad`` of the lax flash on shifted layouts.
- One MoE layer (``fusco.moe_shuffle_ffn``) and one ``tx_attention``: EP = 1
  in-process with capacity drops, and EP = 4 rank by rank over four gloo
  ranks against ``jax.grad`` under ``shard_map`` on four forced host
  devices.  The losses are ``sum(out * cot)``; each rank differentiates its
  own, so a replicated weight's gradient on a rank is that rank's share and
  the ranks' shares sum to JAX's.

float32, tolerance 1e-5 relative to each result's largest magnitude (sums in
another order); bf16 grouped matmul 2e-2 (the jnp reference rounds to bf16
where the port sums in float32).
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from conftest import run_devices
from xla_prelude import PRELUDE
from repro.core import fusco as jfusco
from repro.core.dcomm import DcommConfig as JDcommConfig
from repro.core.routing import ExpertPlacement as JPlacement
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.grouped_matmul import grouped_matmul as gmm_pallas
from repro.layers.attention import flash_attention as lax_flash
from repro_torch.core import fusco
from repro_torch.core.dcomm import DcommConfig
from repro_torch.core.routing import ExpertPlacement
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import grouped_matmul as gmm_k

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

TOL = 1e-5


def _close(got, want, tol=TOL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


# ----------------------------------------------------------- grouped matmul

@pytest.mark.parametrize("g,c,d,f,dtype", [(4, 16, 32, 48, "f32"),
                                           (3, 24, 64, 32, "bf16"),
                                           (2, 8, 16, 16, "f32")])
def test_grouped_matmul_matches_pallas(g, c, d, f, dtype):
    rng = _rng(0)
    jd, td, tol = {"f32": (jnp.float32, torch.float32, TOL),
                   "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}[dtype]
    x = _f32(rng, g, c, d)
    w = _f32(rng, g, d, f, scale=d ** -0.5)
    counts = rng.integers(0, c + 1, g).astype(np.int32)
    counts[0], counts[1], counts[-1] = 0, 8 + 3 if c > 11 else 5, c
    live = counts[:, None] > np.arange(c)
    x[~live] = 1e4                           # poison: must come out zero
    xj, wj = jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(td)
    wt = torch.from_numpy(np.array(wj.astype(jnp.float32))).to(td)
    got = ops.grouped_matmul(xt, wt, torch.from_numpy(counts))
    assert got.dtype == td and got.shape == (g, c, f)
    pallas = gmm_pallas(xj, wj, jnp.asarray(counts), block_c=8, block_f=16,
                        block_d=16, interpret=True)
    expect = jref.grouped_matmul_ref(xj, wj, jnp.asarray(counts))
    _close(got, pallas, tol)
    _close(got, expect, tol)
    assert not got.float().numpy()[~live].any()


def test_grouped_matmul_shares_weights_across_lanes_and_reads_views():
    """Group g reads weight g % E (the S lanes of a landed (S, E, C, .)
    buffer share their experts), and a transposed view of the weights gives
    what its contiguous copy gives."""
    rng = _rng(1)
    s, e, c, d, f = 3, 2, 8, 16, 24
    x = _f32(rng, s * e, c, d)
    w = _f32(rng, e, f, d)                     # stored (E, N, K): use w^T
    counts = rng.integers(0, c + 1, s * e).astype(np.int32)
    wt = torch.from_numpy(w).transpose(1, 2)
    assert not wt.is_contiguous()
    got = ops.grouped_matmul(torch.from_numpy(x), wt, torch.from_numpy(counts))
    tiled = np.tile(np.swapaxes(w, 1, 2), (s, 1, 1))           # (G, K, N)
    _close(got, jref.grouped_matmul_ref(jnp.asarray(x), jnp.asarray(tiled),
                                        jnp.asarray(counts)))
    _close(got, ops.grouped_matmul(torch.from_numpy(x), wt.contiguous(),
                                   torch.from_numpy(counts)))


def test_grouped_matmul_wrapper_passes_what_the_c_entry_takes(monkeypatch):
    """The wrapper binds and calls the C entry with 4 pointers, then G, E,
    C, K, N, w's three strides and the dtype code, then the stream; a
    transposed bf16 view is passed with its strides, not copied; one call
    counts one launch."""
    from test_torch_kernels import _c_signatures
    sig = _c_signatures()["grouped_matmul", "grouped_matmul"]
    calls = []

    def fake_bind(name, fn, n_ptr, n_int):
        assert sig == "p" * n_ptr + "i" * n_int + "p"

        def call(*args):
            assert all(isinstance(a, int) for a in args), args
            calls.append(args)
            return 0
        return call

    monkeypatch.setattr(_build, "bind", fake_bind)
    monkeypatch.setattr(_build, "require_cuda", lambda *a: None)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    bf = dict(dtype=torch.bfloat16)
    x = torch.zeros(6, 5, 16, **bf)
    w2 = torch.zeros(3, 24, 16, **bf)           # (E, f, d) -> its transpose
    before = gmm_k.grouped_matmul.launches
    out = gmm_k.grouped_matmul(x, w2.transpose(1, 2),
                               torch.ones(6, dtype=torch.int32))
    assert out.shape == (6, 5, 24) and out.dtype == torch.bfloat16
    assert calls[0][4:13] == (6, 3, 5, 16, 24, 24 * 16, 1, 16, 1)
    gmm_k.grouped_matmul(x.float(), torch.zeros(3, 16, 24),
                         torch.ones(6, dtype=torch.int32))
    assert calls[1][4:13] == (6, 3, 5, 16, 24, 16 * 24, 24, 1, 0)
    assert gmm_k.grouped_matmul.launches == before + 2
    assert "grouped_matmul" in _build.KERNELS


@pytest.mark.parametrize("what", ["groups", "counts", "dtype", "layout",
                                  "ragged_k", "cpu"])
def test_grouped_matmul_wrapper_refuses_what_the_kernel_does_not_take(
        monkeypatch, what):
    if what != "cpu":
        monkeypatch.setattr(_build, "require_cuda", lambda *a: None)
    x, w = torch.zeros(4, 8, 16), torch.zeros(2, 16, 8)
    counts = torch.ones(4, dtype=torch.int32)
    if what == "groups":
        w = torch.zeros(3, 16, 8)
    elif what == "counts":
        counts = counts.long()
    elif what == "dtype":
        w = w.to(torch.bfloat16)
    elif what == "layout":        # bf16 with neither n nor k unit-strided
        x, w = x.to(torch.bfloat16), torch.zeros(2, 16, 8, 2,
                                                 dtype=torch.bfloat16)[..., 0]
    elif what == "ragged_k":      # bf16 with K % 8 != 0: no TMA map for x
        x, w = (torch.zeros(4, 8, 12, dtype=torch.bfloat16),
                torch.zeros(2, 12, 8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="grouped_matmul"):
        gmm_k.grouped_matmul(x, w, counts)


@pytest.mark.parametrize("dtype,launched", [(torch.bfloat16, True),
                                            (torch.float32, False)])
def test_grouped_matmul_group_limit_is_the_fma_forms(monkeypatch, dtype,
                                                    launched):
    """The Hopper form flattens its grid, so bf16 takes more than 65535
    groups; the float32 FMA form keeps the grid's z limit and refuses."""
    calls = []
    monkeypatch.setattr(_build, "bind", lambda *a: (
        lambda *args: calls.append(args) or 0))
    monkeypatch.setattr(_build, "require_cuda", lambda *a: None)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    g = gmm_k.MAX_GROUPS + 1
    x, w = torch.zeros(g, 1, 8, dtype=dtype), torch.zeros(1, 8, 8, dtype=dtype)
    counts = torch.ones(g, dtype=torch.int32)
    if launched:
        assert gmm_k.grouped_matmul(x, w, counts).shape == (g, 1, 8)
        assert calls[0][4] == g
    else:
        with pytest.raises(ValueError, match="groups"):
            gmm_k.grouped_matmul(x, w, counts)
        assert not calls


# ------------------------------------------------------ kernel entry VJPs

def test_ops_outputs_come_from_the_autograd_functions():
    x = torch.zeros(4, 8, requires_grad=True)
    i = torch.tensor([0, -1, 3], dtype=torch.int32)
    assert "SegmentGather" in type(ops.segment_gather(x, i).grad_fn).__name__
    assert "SegmentScatterAdd" in type(ops.segment_scatter_add(
        x, torch.tensor([1, -1, 0, 2]), torch.ones(4), 3).grad_fn).__name__
    xs = torch.zeros(1, 2, 4, 8, requires_grad=True)
    w = torch.zeros(2, 8, 4)
    assert "FusedSwiglu" in type(ops.fused_swiglu(
        xs, w, w, w.transpose(1, 2)).grad_fn).__name__
    q = torch.zeros(1, 4, 2, 16, requires_grad=True)
    p = torch.arange(4)
    assert "FlashAttention" in type(ops.flash_attention(
        q, q, q, p, p).grad_fn).__name__


def test_segment_gather_vjp_matches_jax():
    rng = _rng(2)
    src, dout = _f32(rng, 9, 32), _f32(rng, 12, 32)
    idx = rng.integers(-1, 9, 12).astype(np.int32)
    idx[:2], idx[2:5] = -1, 4                  # empty slots, repeated rows
    _, vjp = jax.vjp(lambda s: jops.segment_gather(s, jnp.asarray(idx)),
                     jnp.asarray(src))
    want = vjp(jnp.asarray(dout))[0]
    # without owner lists, and with them (idx's inverse, as a plan's slot
    # table): the backward's scatter-add then sums each row over its owners
    table = ref.owner_table(*ref.build_owners_ref(torch.from_numpy(idx), 9))
    for owners in (None, table):
        s = _t(src, grad=True)
        ops.segment_gather(s, torch.from_numpy(idx), owners).backward(_t(dout))
        _close(s.grad, want)


def test_segment_scatter_add_vjp_matches_jax():
    rng = _rng(3)
    r, rows, d = 16, 6, 24
    src, dout = _f32(rng, r, d), _f32(rng, rows, d)
    dst = rng.integers(-1, rows, r).astype(np.int32)
    dst[:3], dst[3] = 2, -1                    # duplicates and a drop
    gates = rng.uniform(size=r).astype(np.float32)
    _, vjp = jax.vjp(lambda s, g: jops.segment_scatter_add(
        s, jnp.asarray(dst), g, rows), jnp.asarray(src), jnp.asarray(gates))
    dsrc_j, dgates_j = vjp(jnp.asarray(dout))
    want = jops.segment_scatter_add(jnp.asarray(src), jnp.asarray(dst),
                                    jnp.asarray(gates), rows)
    # without owner lists (the plain scatter-add), and with them (the plain
    # owner-reduce, the sums the card takes); one backward for both
    table = ref.owner_table(*ref.build_owners_ref(torch.from_numpy(dst), rows))
    for owners in (None, table):
        s, g = _t(src, grad=True), _t(gates, grad=True)
        out = ops.segment_scatter_add(s, torch.from_numpy(dst), g, rows, owners)
        _close(out, want, what="out")
        out.backward(_t(dout))
        _close(s.grad, dsrc_j, what="dsrc")
        _close(g.grad, dgates_j, what="dgates")
        assert g.grad[3] == 0                  # the dropped row's gate


@pytest.mark.parametrize("s,e,c,d,f", [(2, 3, 16, 32, 24), (1, 4, 8, 16, 32)])
def test_fused_swiglu_vjp_matches_jax(s, e, c, d, f):
    rng = _rng(4)
    x = _f32(rng, s, e, c, d, scale=0.5)
    w1, w3 = _f32(rng, e, d, f, scale=d ** -0.5), _f32(rng, e, d, f, scale=d ** -0.5)
    w2 = _f32(rng, e, f, d, scale=f ** -0.5)
    dy = _f32(rng, s, e, c, d)
    counts = rng.integers(0, c + 1, (s, e)).astype(np.int32)
    counts.flat[0], counts.flat[1], counts.flat[-1] = 0, 5, c
    x[~(counts[..., None] > np.arange(c))] = 3.0     # dead rows hold values
    args = [jnp.asarray(a) for a in (x, w1, w3, w2)]
    _, vjp = jax.vjp(lambda *a: jops.fused_swiglu(*a, jnp.asarray(counts)),
                     *args)
    want = vjp(jnp.asarray(dy))
    ts = [_t(a, grad=True) for a in (x, w1, w3, w2)]
    ops.fused_swiglu(*ts, torch.from_numpy(counts)).backward(_t(dy))
    for name, t, w in zip(("dx", "dw1", "dw3", "dw2"), ts, want):
        _close(t.grad, w, what=name)


@pytest.mark.parametrize("offset,window,q_block", [(0, None, 512), (32, None, 8),
                                                   (32, 24, 8), (7, None, 512)])
def test_flash_attention_vjp_matches_the_lax_flash(offset, window, q_block):
    """q at positions offset.. against keys 0..; q_block 8 walks 4 x 8
    block pairs, some skipped by their position bounds."""
    rng = _rng(5)
    b, sq, sk, hq, hkv, hd = 2, 32, 64, 4, 2, 16
    q, k, v = _f32(rng, b, sq, hq, hd), _f32(rng, b, sk, hkv, hd), _f32(rng, b, sk, hkv, hd)
    dout = _f32(rng, b, sq, hq, hd)
    qp = np.arange(sq, dtype=np.int32) + offset
    kp = np.arange(sk, dtype=np.int32)
    _, vjp = jax.vjp(lambda *a: lax_flash(*a, jnp.asarray(qp), jnp.asarray(kp),
                                          True, window, 8, 8),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    if q_block == 512:            # through the autograd Function
        ts = [_t(a, grad=True) for a in (q, k, v)]
        ops.flash_attention(*ts, torch.from_numpy(qp), torch.from_numpy(kp),
                            True, window).backward(_t(dout))
        got = [t.grad for t in ts]
    else:                         # the backward alone, small blocks
        out, lse = ref.flash_attention_ref(*map(_t, (q, k, v, qp, kp)), True,
                                           window)
        got = ref.flash_attention_bwd(*map(_t, (q, k, v, qp, kp)), out, lse,
                                      _t(dout), True, window, q_block, q_block)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, 2e-5, what=name)


# ---------------------------------------------------------- one MoE layer

E, K, D, F = 8, 2, 16, 24


def _moe_weights(seed, t):
    rng = _rng(seed)
    return dict(x=_f32(rng, t, D), wr=_f32(rng, D, E, scale=0.5),
                w1=_f32(rng, E, D, F, scale=0.1), w3=_f32(rng, E, D, F, scale=0.1),
                w2=_f32(rng, E, F, D, scale=0.1), cot=_f32(rng, t, D))


def test_moe_layer_grads_ep1_with_drops_match_jax():
    """Capacity factor 0.5 drops assignments: their gates get no gradient,
    as in JAX (the dropped slots pile onto a row the plan cuts off)."""
    p = _moe_weights(6, 32)
    names = ("x", "wr", "w1", "w3", "w2")
    jp = JPlacement(n_experts=E, ep=1, node_size=1)
    jcfg = JDcommConfig(engine="fused_flat", ep_axis="model", node_size=1,
                        capacity_factor=0.5)

    def jloss(*a):
        y = jax.vmap(lambda *b: jfusco.moe_shuffle_ffn(*b, jp, jcfg, K),
                     in_axes=(0, None, 0, 0, 0), axis_name="model")(
            a[0][None], a[1], a[2][None], a[3][None], a[4][None])[0]
        return jnp.sum(y * jnp.asarray(p["cot"]))

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(5))))(
        *(jnp.asarray(p[n]) for n in names))
    ts = [_t(p[n], grad=True) for n in names]
    y = fusco.moe_shuffle_ffn(*ts, ExpertPlacement(E, 1, 1),
                              DcommConfig(engine="fused_flat",
                                          capacity_factor=0.5), K)
    (y * _t(p["cot"])).sum().backward()
    for n, t, w in zip(names, ts, want):
        _close(t.grad, w, what=n)


EP, T_LANE, B_TX, S_TX = 4, 12, 2, 16
HQ, HKV, HD = 4, 2, 8
TX_KEYS = ("h", "ln1", "wq", "wk", "wv", "wo")

JAX_EP_CODE = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.core import fusco
from repro.core.dcomm import DcommConfig
from repro.core.routing import ExpertPlacement
d = dict(np.load({data!r}))
EP, K = {ep}, {k}
mesh = make_mesh((EP,), ("model",))
placement = ExpertPlacement(n_experts={e}, ep=EP, node_size=EP // 2)
cfg = DcommConfig(engine="fused_flat", ep_axis="model", node_size=EP // 2,
                  capacity_factor=8.0)
moe = shard_map(lambda x, wr, a, b, c: fusco.moe_shuffle_ffn(
                    x, wr, a, b, c, placement, cfg, K),
                mesh=mesh, in_specs=(P("model"), P(), P("model"), P("model"),
                                     P("model")),
                out_specs=P("model"), check_vma=False)
g_moe = jax.jit(jax.grad(lambda *a: jnp.sum(moe(*a) * d["cot"]),
                         argnums=(0, 1, 2, 3, 4)))(
    *(jnp.asarray(d[n]) for n in ("x", "wr", "w1", "w3", "w2")))
S = d["h"].shape[1]

def tx(h, ln1, wq, wk, wv, wo):
    s_l = h.shape[1]
    pos_q = jax.lax.axis_index("model") * s_l + jnp.arange(s_l)
    return fusco.tx_attention(h, dict(ln1=ln1, wq=wq, wk=wk, wv=wv, wo=wo),
                              pos_q, jnp.arange(S), n_heads={hq}, n_kv={hkv},
                              head_dim={hd}, ep_axes=("model",))

txs = shard_map(tx, mesh=mesh, in_specs=(P(None, "model"),) + (P(),) * 5,
                out_specs=P(None, "model"), check_vma=False)
g_tx = jax.jit(jax.grad(lambda *a: jnp.sum(txs(*a) * d["cot_tx"]),
                        argnums=tuple(range(6))))(
    *(jnp.asarray(d[n]) for n in {tx_keys!r}))
np.savez({out!r}, **{{"moe_" + n: np.asarray(g) for n, g in
                      zip(("x", "wr", "w1", "w3", "w2"), g_moe)}},
         **{{"tx_" + n: np.asarray(g) for n, g in zip({tx_keys!r}, g_tx)}})
print("JAX_OK")
"""


def _ep_rank_main(rank, world, init_file, data, out_dir):
    """One EP rank: the grads of its own loss through the MoE layer (its
    token shard, its lane's experts) and through tx_attention (its stripe of
    the sequence; k/v all-gathered)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        d = dict(np.load(data))
        group = dist.group.WORLD
        el, t = E // world, d["x"].shape[0] // world
        lane = lambda a: a[rank * el:(rank + 1) * el]
        ts = [_t(a, grad=True) for a in (d["x"][rank * t:(rank + 1) * t], d["wr"],
                                          lane(d["w1"]), lane(d["w3"]),
                                          lane(d["w2"]))]
        y = fusco.moe_shuffle_ffn(*ts, ExpertPlacement(E, world, world // 2),
                                  DcommConfig(engine="fused_flat",
                                              capacity_factor=8.0), K,
                                  group=group)
        cot = d["cot"][rank * t:(rank + 1) * t]
        grads = torch.autograd.grad((y * _t(cot)).sum(), ts)
        out = {"moe_" + n: g.numpy() for n, g in
               zip(("x", "wr", "w1", "w3", "w2"), grads)}
        s_l = d["h"].shape[1] // world
        stripe = slice(rank * s_l, (rank + 1) * s_l)
        h = _t(d["h"][:, stripe], grad=True)
        lp = {n: _t(d[n], grad=True) for n in TX_KEYS[1:]}
        pos = torch.arange(d["h"].shape[1])
        a = fusco.tx_attention(h, lp, pos[stripe], pos, n_heads=HQ, n_kv=HKV,
                               head_dim=HD, group=group)
        grads = torch.autograd.grad((a * _t(d["cot_tx"][:, stripe])).sum(),
                                    [h, *lp.values()])
        out.update({"tx_" + n: g.numpy() for n, g in zip(TX_KEYS, grads)})
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ep4_grads(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep4_grads")
    rng = _rng(7)
    d = _moe_weights(8, EP * T_LANE)
    d.update(h=_f32(rng, B_TX, S_TX, D), ln1=1 + _f32(rng, D, scale=0.1),
             wq=_f32(rng, D, HQ * HD, scale=D ** -0.5),
             wk=_f32(rng, D, HKV * HD, scale=D ** -0.5),
             wv=_f32(rng, D, HKV * HD, scale=D ** -0.5),
             wo=_f32(rng, HQ * HD, D, scale=(HQ * HD) ** -0.5),
             cot_tx=_f32(rng, B_TX, S_TX, D))
    data = tmp / "data.npz"
    np.savez(data, **d)
    code = PRELUDE + JAX_EP_CODE.format(
        data=str(data), ep=EP, k=K, e=E, hq=HQ, hkv=HKV, hd=HD,
        tx_keys=TX_KEYS, out=str(tmp / "jax.npz"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(run_devices, code, EP, 300)
        mp.spawn(_ep_rank_main, args=(EP, str(tmp / "rendezvous"), str(data),
                                      str(tmp)), nprocs=EP, join=True)
        assert "JAX_OK" in jax_run.result()
    return (np.load(tmp / "jax.npz"),
            [np.load(tmp / f"rank{r}.npz") for r in range(EP)])


def test_moe_layer_grads_ep4_gloo_match_jax_rank_by_rank(ep4_grads):
    """x and the lane's expert weights rank by rank; the replicated router's
    per-rank shares sum to JAX's.  Fails without the exchange's backward."""
    want, ranks = ep4_grads
    el = E // EP
    for r, got in enumerate(ranks):
        _close(got["moe_x"], want["moe_x"][r * T_LANE:(r + 1) * T_LANE],
               what=f"rank {r} x")
        for n in ("w1", "w3", "w2"):
            _close(got["moe_" + n], want["moe_" + n][r * el:(r + 1) * el],
                   what=f"rank {r} {n}")
    _close(sum(g["moe_wr"] for g in ranks), want["moe_wr"], what="router")


def test_tx_attention_grads_ep4_gloo_match_jax_rank_by_rank(ep4_grads):
    """The k/v all-gather's backward keeps each rank's stripe of the
    cotangent summed over the ranks (JAX's psum_scatter): h rank by rank,
    the replicated weights' shares summed."""
    want, ranks = ep4_grads
    s_l = S_TX // EP
    for r, got in enumerate(ranks):
        _close(got["tx_h"], want["tx_h"][:, r * s_l:(r + 1) * s_l],
               what=f"rank {r} h")
    for n in TX_KEYS[1:]:
        _close(sum(g["tx_" + n] for g in ranks), want["tx_" + n], what=n)
