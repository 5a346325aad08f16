"""The port's staging kernels (plain PyTorch versions, which the CPU runs)
against the JAX package's Pallas kernels in interpret mode and its jnp
references, on the same numpy inputs.

Tolerances: float32 1e-5 (sums in another order); bfloat16 one or two bf16
steps at the output's scale (2e-2 relative), because the jnp reference
rounds its intermediates to bf16 where the kernels keep float32.  The CUDA
kernels themselves are held against these plain versions on the card by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.fused_staging import fused_swiglu_pallas
from repro.kernels.segment_gather import segment_gather as gather_pallas
from repro.kernels.segment_scatter_add import (
    segment_scatter_add as scatter_pallas)
from repro_torch.kernels import fused_staging, ops

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jd, td, _ = DTYPES[dtype]
    j = jnp.asarray(a).astype(jd)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)
    return j, t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("t,r,d,dtype", [(37, 16, 256, "f32"),
                                         (64, 64, 128, "bf16"),
                                         (5, 40, 64, "f32")])
def test_segment_gather_matches_pallas(t, r, d, dtype):
    rng = np.random.default_rng(0)
    src_j, src_t = _pair(rng.standard_normal((t, d)), dtype)
    idx = rng.integers(-1, t, r).astype(np.int32)
    idx[:3] = -1                                   # empty slots
    idx[3:6] = idx[6]                              # repeated source rows
    got = ops.segment_gather(src_t, torch.from_numpy(idx))
    assert got.dtype == src_t.dtype and got.shape == (r, d)
    pallas = gather_pallas(src_j, jnp.asarray(idx), block_d=min(d, 128),
                           interpret=True)
    np.testing.assert_array_equal(_np(got), _np(pallas))
    np.testing.assert_array_equal(_np(got), _np(jref.segment_gather_ref(
        src_j, jnp.asarray(idx))))
    assert not _np(got)[:3].any()


@pytest.mark.parametrize("r,out_rows,d,dtype", [(24, 5, 256, "f32"),
                                                (32, 8, 128, "bf16"),
                                                (16, 16, 64, "f32")])
def test_segment_scatter_add_matches_pallas(r, out_rows, d, dtype):
    rng = np.random.default_rng(1)
    src_j, src_t = _pair(rng.standard_normal((r, d)), dtype)
    dst = rng.integers(-1, out_rows, r).astype(np.int32)
    dst[:4] = 2                                    # duplicate destinations
    dst[4] = -1                                    # a dropped row
    gates = rng.uniform(size=r).astype(np.float32)
    got = ops.segment_scatter_add(src_t, torch.from_numpy(dst),
                                  torch.from_numpy(gates), out_rows)
    assert got.dtype == src_t.dtype and got.shape == (out_rows, d)
    pallas = scatter_pallas(src_j, jnp.asarray(dst), jnp.asarray(gates),
                            out_rows, block_d=min(d, 128), interpret=True)
    expect = jref.segment_scatter_add_ref(src_j, jnp.asarray(dst),
                                          jnp.asarray(gates), out_rows)
    tol = DTYPES[dtype][2]
    # the Pallas kernel rounds its accumulator to the output dtype at each
    # visit; the reference and the port round once at the end
    scale = np.abs(_np(expect)).max()
    np.testing.assert_allclose(_np(got), _np(expect), atol=tol * scale,
                               rtol=tol)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=2 * tol * scale,
                               rtol=2 * tol)


@pytest.mark.parametrize("s,e,c,d,f,block_c,dtype", [
    (2, 3, 16, 32, 48, 8, "f32"),
    (1, 4, 24, 64, 32, 8, "bf16"),
    (2, 2, 8, 16, 24, 8, "f32"),
])
def test_fused_swiglu_matches_pallas(s, e, c, d, f, block_c, dtype):
    rng = np.random.default_rng(2)
    x_j, x_t = _pair(rng.standard_normal((s, e, c, d)) * 0.5, dtype)
    w1_j, w1_t = _pair(rng.standard_normal((e, d, f)) * d ** -0.5, dtype)
    w3_j, w3_t = _pair(rng.standard_normal((e, d, f)) * d ** -0.5, dtype)
    w2_j, w2_t = _pair(rng.standard_normal((e, f, d)) * f ** -0.5, dtype)
    counts = rng.integers(0, c + 1, (s, e)).astype(np.int32)
    counts.flat[0] = 0                  # an empty group: every block skipped
    counts.flat[1] = min(block_c + 3, c)  # a partly occupied row-block
    counts.flat[-1] = c                 # a full group
    got = ops.fused_swiglu(x_t, w1_t, w3_t, w2_t, torch.from_numpy(counts))
    assert got.dtype == x_t.dtype and got.shape == x_t.shape
    pallas = fused_swiglu_pallas(x_j, w1_j, w3_j, w2_j, jnp.asarray(counts),
                                 block_c=block_c, block_f=16, interpret=True)
    expect = jref.fused_swiglu_ref(x_j, w1_j, w3_j, w2_j, jnp.asarray(counts))
    tol = DTYPES[dtype][2]
    scale = np.abs(_np(expect)).max()
    np.testing.assert_allclose(_np(got), _np(pallas), atol=tol * scale,
                               rtol=tol)
    np.testing.assert_allclose(_np(got), _np(expect), atol=tol * scale,
                               rtol=tol)
    live = counts[..., None] > np.arange(c)
    assert not _np(got)[~live].any()


def test_fused_swiglu_all_rows_live_without_counts():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 2, 8, 16)).astype(np.float32))
    w1, w3 = (torch.from_numpy(rng.standard_normal((2, 16, 8)).astype(np.float32))
              for _ in range(2))
    w2 = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))
    full = torch.full((1, 2), 8, dtype=torch.int32)
    torch.testing.assert_close(ops.fused_swiglu(x, w1, w3, w2),
                               ops.fused_swiglu(x, w1, w3, w2, full))


@pytest.mark.parametrize("c,d,elem,bc", [(64, 2048, 2, 16), (64, 2048, 4, 8),
                                         (8, 2048, 2, 8), (3, 64, 4, 4),
                                         (1, 16, 4, 1)])
def test_fused_swiglu_tile_rows_fit_shared_memory(c, d, elem, bc):
    assert fused_staging.tile_rows(c, d, elem) == bc
    assert fused_staging.smem_bytes(bc, d, elem) <= fused_staging.SMEM_OPTIN


def test_fused_swiglu_tile_rows_raises_when_nothing_fits():
    with pytest.raises(ValueError, match="does not fit"):
        fused_staging.tile_rows(8, 40000, 4)


def test_kernel_wrappers_take_cuda_tensors_only():
    """The kernel wrappers never run the plain version: a CPU tensor is
    refused (ops routes it to the plain version before it gets there)."""
    from repro_torch.kernels.segment_gather import segment_gather
    from repro_torch.kernels.segment_scatter_add import segment_scatter_add
    x = torch.zeros(4, 8)
    i = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        segment_gather(x, i)
    with pytest.raises(ValueError, match="CUDA"):
        segment_scatter_add(x, i, torch.ones(4), 4)
    with pytest.raises(ValueError, match="CUDA"):
        fused_staging.fused_swiglu(x[None, None], torch.zeros(1, 8, 4),
                                   torch.zeros(1, 8, 4), torch.zeros(1, 4, 8),
                                   torch.ones(1, 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="device meta"):
        ops.segment_gather(x.to("meta"), i)



def _c_signatures():
    """Parameter kinds of every extern "C" entry in csrc/*.cu:
    'p' for a pointer, 'i' for an int."""
    import re
    from repro_torch.kernels import _build
    sigs = {}
    for src in _build.CSRC.glob("*.cu"):
        for fn, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                     src.read_text()):
            kinds = ["p" if "*" in p else "i" for p in params.split(",")]
            assert all(("*" in p) or p.split()[0] == "int"
                       for p in params.split(",")), (fn, params)
            sigs[src.stem, fn] = "".join(kinds)
    return sigs


def test_wrappers_pass_what_the_c_entries_take(monkeypatch):
    """Each wrapper's ctypes binding and call match its C signature
    (pointers, then ints, then the stream), and one call counts one launch.
    The C entry is replaced by a recorder: CUDA is not here."""
    from repro_torch.kernels import _build, segment_gather as g_mod
    from repro_torch.kernels import segment_scatter_add as s_mod
    sigs = _c_signatures()
    calls = []

    def fake_bind(name, fn, n_ptr, n_int):
        assert sigs[name, fn] == "p" * n_ptr + "i" * n_int + "p", (name, fn)

        def call(*args):
            assert len(args) == n_ptr + n_int + 1, (fn, args)
            assert all(isinstance(a, int) for a in args), (fn, args)
            calls.append(fn)
            return 0
        return call

    monkeypatch.setattr(_build, "bind", fake_bind)
    monkeypatch.setattr(_build, "require_cuda", lambda *a: None)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: object())
    x = torch.zeros(6, 16, dtype=torch.bfloat16)
    i = torch.zeros(4, dtype=torch.int32)
    before = (g_mod.segment_gather.launches, s_mod.segment_scatter_add.launches,
              fused_staging.fused_swiglu.launches)
    g_mod.segment_gather(x, i)
    s_mod.segment_scatter_add(x[:4], i, torch.ones(4), 6)
    counts = torch.ones(1, 2, dtype=torch.int32)
    fused_staging.fused_swiglu(torch.zeros(1, 2, 3, 16), torch.zeros(2, 16, 8),
                               torch.zeros(2, 16, 8), torch.zeros(2, 8, 16),
                               counts)                    # f32: FMA variant
    bf = dict(dtype=torch.bfloat16)
    fused_staging.fused_swiglu(torch.zeros(1, 2, 3, 16, **bf),
                               torch.zeros(2, 16, 32, **bf),
                               torch.zeros(2, 16, 32, **bf),
                               torch.zeros(2, 32, 16, **bf), counts)  # tensor cores
    assert calls == ["segment_gather", "segment_scatter_add", "fused_swiglu",
                     "fused_swiglu_tc"]
    after = (g_mod.segment_gather.launches, s_mod.segment_scatter_add.launches,
             fused_staging.fused_swiglu.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 2]


@pytest.mark.parametrize("dtype,d,f,tc", [("bf16", 2048, 768, True),
                                          ("bf16", 64, 32, True),
                                          ("bf16", 16, 24, False),
                                          ("f32", 2048, 768, False)])
def test_fused_swiglu_variant_follows_the_inputs(dtype, d, f, tc):
    td = DTYPES[dtype][1]
    x = torch.empty(1, 1, 1, d, dtype=td)
    ws = (torch.empty(1, d, f, dtype=td), torch.empty(1, d, f, dtype=td),
          torch.empty(1, f, d, dtype=td))
    assert fused_staging.use_tensor_cores(x, ws) is tc
    assert fused_staging.smem_bytes_tc(2048, 768) == 172032
