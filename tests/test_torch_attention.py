"""The port's position-safe flash attention against the JAX package.

The plain version (``kernels/ref.flash_attention_ref``, what the CPU runs)
against the Pallas kernel in interpret mode, output and log-sum-exp, on the
shifted layouts of ``tests/test_flash_attention.py``; the moe family's
``causal_attention`` against the JAX lax flash; and the CUDA kernel's
wrapper against its C signature (the kernel itself is held against the plain
version on the card by ``chip_smoke.py``).  float32, tolerance 2e-5 (sums in
another order; the Pallas kernel walks 16-key blocks with an online softmax).

The plain-against-Pallas checks run both sides on one thread (torch's
intra-op pool set to 1 for the test, the Pallas program compiled with
XLA's Eigen threading and parallel codegen off), so their arithmetic does
not hang on the size of either pool, which differs between a worker of a
parallel test run and a lone process.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import _flash_fwd_pallas
from repro.layers.attention import flash_attention as lax_flash
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import flash_attention as flash_k
from repro_torch.layers.attention import causal_attention

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

TOL = 2e-5


def _qkv(seed, b, sq, sk, hq, hkv, hd):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.standard_normal((b, sq, hq, hd)).astype(f32),
            rng.standard_normal((b, sk, hkv, hd)).astype(f32),
            rng.standard_normal((b, sk, hkv, hd)).astype(f32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# XLA's CPU options that keep one compiled program on one thread
ONE_THREAD = {"xla_cpu_multi_thread_eigen": False,
              "xla_cpu_parallel_codegen_split_count": 1}


@pytest.fixture
def one_thread():
    """torch's intra-op pool at one thread for the test, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pallas(q, k, v, qp, kp, causal, window, blk):
    """The Pallas forward in interpret mode, compiled for one thread:
    (out (B, Sq, Hq, hd), lse (B, Hq, Sq)) as numpy."""
    args = [jnp.asarray(a) for a in (q, k, v, qp, kp)]
    out, lse = _flash_fwd_pallas.lower(
        *args, causal, window, blk, blk, True).compile(ONE_THREAD)(*args)
    b, sq, hq, _ = q.shape
    # (B, nq, Hkv, G, qb) -> (B, Hq, Sq)
    return np.asarray(out), np.moveaxis(np.asarray(lse), 1, 3).reshape(
        b, hq, sq)


@pytest.mark.parametrize("offset,window,hq,hkv", [
    (0, None, 4, 2), (32, None, 4, 2), (32, 24, 8, 2), (7, None, 2, 1),
])
def test_flash_ref_matches_pallas_out_and_lse(offset, window, hq, hkv,
                                              one_thread):
    b, sq, sk, hd, blk = 2, 32, 64, 16, 16
    q, k, v = _qkv(7, b, sq, sk, hq, hkv, hd)
    qp = np.arange(sq, dtype=np.int32) + offset
    kp = np.arange(sk, dtype=np.int32)
    out_j, lse_j = _pallas(q, k, v, qp, kp, True, window, blk)
    out, lse = ref.flash_attention_ref(*_t(q, k, v, qp, kp), True, window)
    assert out.dtype == torch.float32 and lse.shape == (b, hq, sq)
    np.testing.assert_allclose(out.numpy(), out_j, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), lse_j, rtol=TOL, atol=TOL)
    # the query-block size of the plain version does not change the result
    out8, lse8 = ref.flash_attention_ref(*_t(q, k, v, qp, kp), True, window,
                                         q_block=8)
    np.testing.assert_allclose(out8.numpy(), out.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse8.numpy(), lse.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("sq,sk,offset", [(32, 32, 0), (32, 64, 16),
                                          (64, 32, 0)])
def test_flash_ref_matches_pallas_bidirectional(sq, sk, offset, one_thread):
    """``causal=False`` (an encoder's self-attention, Sq = Sk, and a
    decoder's cross-attention over encoder keys, Sq < Sk and Sq > Sk; the
    queries' positions shifted by ``offset``), G 1 and G 2: output and
    log-sum-exp, every key seen by every query."""
    b, hd, blk = 2, 16, 16
    for hq, hkv in ((2, 2), (4, 2)):
        q, k, v = _qkv(11, b, sq, sk, hq, hkv, hd)
        qp = np.arange(sq, dtype=np.int32) + offset
        kp = np.arange(sk, dtype=np.int32)
        out_j, lse_j = _pallas(q, k, v, qp, kp, False, None, blk)
        out, lse = ref.flash_attention_ref(*_t(q, k, v, qp, kp), False, None)
        np.testing.assert_allclose(out.numpy(), out_j, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(lse.numpy(), lse_j, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, None)])
def test_ops_flash_on_cpu_is_the_plain_version(causal, window):
    q, k, v = _t(*_qkv(1, 2, 12, 20, 6, 2, 32))
    qp, kp = torch.arange(8, 20), torch.arange(20)
    got = ops.flash_attention(q, k, v, qp, kp, causal, window)
    want, _ = ref.flash_attention_ref(q, k, v, qp, kp, causal, window)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert got.shape == q.shape


@pytest.mark.parametrize("offset,window", [(0, None), (16, None), (16, 12)])
def test_causal_attention_matches_the_lax_flash(offset, window):
    """The moe family's attention (now ``ops.flash_attention``) against the
    reference's lax flash, which that family's prefill runs."""
    b, sq, sk, hq, hkv, hd = 2, 16, 32, 4, 2, 16
    q, k, v = _qkv(3, b, sq, sk, hq, hkv, hd)
    qp = np.arange(sq, dtype=np.int32) + offset
    kp = np.arange(sk, dtype=np.int32)
    want = lax_flash(*map(jnp.asarray, (q, k, v, qp, kp)), True, window, 8, 8)
    got = causal_attention(*_t(q, k, v, qp, kp), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _fake_kernel(monkeypatch, calls):
    """Replace the C entry by a recorder that checks each call against its
    signature in csrc/flash_attention.cu: CUDA is not here."""
    import re
    src = (_build.CSRC / "flash_attention.cu").read_text()
    kinds = {fn: "".join("p" if "*" in p else "i" for p in params.split(","))
             for fn, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                          src)}
    assert set(kinds) == {"flash_attention_fwd", "flash_attention_fwd_tc"}

    def fake_bind(name, fn, n_ptr, n_int):
        assert name == "flash_attention"
        assert kinds[fn] == "p" * n_ptr + "i" * n_int + "p", (fn, kinds[fn])

        def call(*args):
            assert len(args) == len(kinds[fn])
            assert all(isinstance(a, int) for a in args), args
            calls.append((fn, args))
            return 0
        return call

    monkeypatch.setattr(_build, "bind", fake_bind)
    monkeypatch.setattr(_build, "require_cuda", lambda *a: None)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)


def test_flash_wrapper_passes_what_the_c_entries_take(monkeypatch):
    """bf16 and float32 reach flash_attention_fwd with their dtype codes (the
    entry picks the Hopper or the FMA form by it), and so do bf16 group
    sizes that do not divide 64 (3 at hd 64; mixtral's 6 and deepseek's 7
    at hd 128); the bf16 shapes the Hopper form refuses (hd 32) reach
    flash_attention_fwd_tc with the same arguments; one call counts one
    launch."""
    calls = []
    _fake_kernel(monkeypatch, calls)
    q, k, v = (torch.zeros(s, dtype=torch.bfloat16)
               for s in ((2, 8, 4, 64), (2, 12, 2, 64), (2, 12, 2, 64)))
    qp = torch.arange(4, 12, dtype=torch.int32)
    kp = torch.arange(12, dtype=torch.int32)
    before = flash_k.flash_attention.launches
    out, lse = flash_k.flash_attention(q, k, v, qp, kp, True, 6)
    assert flash_k.flash_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == q.dtype
    assert lse.shape == (2, 4, 8) and lse.dtype == torch.float32
    # after the 7 pointers: b, sq, sk, hq, hkv, hd, dtype, causal, window
    fn, args = calls[0]
    assert (fn, args[7:16]) == ("flash_attention_fwd",
                                (2, 8, 12, 4, 2, 64, 1, 1, 6))
    flash_k.flash_attention(q.float(), k.float(), v.float(), qp, kp, False)
    fn, args = calls[1]
    assert (fn, args[7:16]) == ("flash_attention_fwd",
                                (2, 8, 12, 4, 2, 64, 0, 0, 0))
    assert flash_k.flash_attention.launches == before + 2
    for hq, hkv, hd, entry in ((4, 2, 32, "flash_attention_fwd_tc"),
                               (6, 2, 64, "flash_attention_fwd"),
                               (12, 2, 128, "flash_attention_fwd"),
                               (14, 2, 128, "flash_attention_fwd")):
        q, k, v = (torch.zeros(s, dtype=torch.bfloat16)
                   for s in ((2, 8, hq, hd), (2, 12, hkv, hd), (2, 12, hkv, hd)))
        flash_k.flash_attention(q, k, v, qp, kp)
        fn, args = calls[-1]
        assert (fn, args[7:16]) == (entry, (2, 8, 12, hq, hkv, hd, 1, 1, 0))
    assert flash_k.flash_attention.launches == before + 6


def test_flash_hopper_tiles_cover_every_query_head_pair_once():
    """The Hopper form's query tiles (``hopper_tiles``, the C source's
    ``flash_tile_queries``): at every group size G up to 64 a CTA's Q box
    of Qc queries x G heads fills Qc G <= 64 rows of the wgmma tile, and
    the grid of ceil(Sq / Qc) tiles, tile i's rows at i Qc G (the box's
    first query i Qc), holds every (query, head-in-group) pair of Sq
    queries exactly once; its rows past Sq are dropped."""
    import re
    src = (_build.CSRC / "flash_attention.cu").read_text()
    rows = int(re.search(r"constexpr int kFlashRows = (\d+);", src).group(1))
    body = re.search(r"constexpr int flash_tile_queries\(int g\) \{\s*"
                     r"return ([^;]+);", src).group(1)
    assert rows == flash_k.ROWS
    for g in range(1, rows + 1):
        qc, live = flash_k.hopper_tiles(g)
        # C's integer division of positive ints
        assert qc == eval(body.replace("/", "//"), {},
                          {"kFlashRows": rows, "g": g}) >= 1
        assert live == qc * g and rows - g < live <= rows
        for sq in (*range(1, 70), 101, 127, 128, 255, 256, 257, 300, 512):
            seen = np.zeros((sq, g), dtype=np.int64)
            for tile in range(-(-sq // qc)):
                row0 = tile * live
                assert row0 % g == 0 and row0 // g == tile * qc
                for r in range(live):           # the box's (query, head)
                    query, head = tile * qc + r // g, r % g
                    assert divmod(row0 + r, g) == (query, head)
                    if query < sq:
                        seen[query, head] += 1
            assert (seen == 1).all(), (g, sq)
    assert flash_k.hopper_tiles(6) == (10, 60)      # mixtral-8x22b
    assert flash_k.hopper_tiles(7) == (9, 63)       # deepseek-v3-bench
    assert flash_k.hopper_tiles(5) == (12, 60)      # qwen3-14b
    assert flash_k.hopper_tiles(8) == (8, 64)


@pytest.mark.parametrize("what", ["hd", "gqa", "dtype", "positions", "window",
                                  "bf16_hd", "bf16_keys"])
def test_flash_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch, what):
    """Shapes no form takes, in float32 and in bf16 (a head dim with no
    template instance; no keys): raised before any launch."""
    calls = []
    _fake_kernel(monkeypatch, calls)
    q, k, v = torch.zeros(1, 4, 4, 32), torch.zeros(1, 4, 2, 32), torch.zeros(1, 4, 2, 32)
    qp = kp = torch.arange(4, dtype=torch.int32)
    window = None
    if what == "hd":
        q, k, v = q[..., :24].contiguous(), k[..., :24].contiguous(), v[..., :24].contiguous()
    elif what == "gqa":
        q = torch.zeros(1, 4, 3, 32)
    elif what == "dtype":
        k = k.to(torch.bfloat16)
    elif what == "positions":
        qp = qp.long()
    elif what == "window":
        window = 0
    elif what == "bf16_hd":
        q, k, v = (torch.zeros(1, 4, h, 48, dtype=torch.bfloat16)
                   for h in (4, 2, 2))
    else:                              # Sk = 0
        q = torch.zeros(1, 4, 4, 64, dtype=torch.bfloat16)
        k = v = torch.zeros(1, 0, 2, 64, dtype=torch.bfloat16)
        kp = kp[:0]
    with pytest.raises(ValueError, match="flash_attention"):
        flash_k.flash_attention(q, k, v, qp, kp, True, window)
    assert not calls


def test_flash_wrapper_takes_cuda_tensors_only():
    q = torch.zeros(1, 4, 2, 16)
    p = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_k.flash_attention(q, q, q, p, p)
    assert "flash_attention" in _build.KERNELS
