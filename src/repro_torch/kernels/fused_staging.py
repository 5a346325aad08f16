"""Fused grouped SwiGLU over the landed dispatch buffer, on Hopper.

Port of the Pallas kernel ``repro/kernels/fused_staging.py``
(``fused_swiglu_pallas``).  The CUDA kernel is ``csrc/fused_swiglu.cu``: one
block per (source lane, local expert, tile of rows) keeps its x tile and the
tile's hidden activations in shared memory, so the (C, f) activations never
reach device memory; a tile past the group's occupancy writes zeros and
skips its weights.  It has two variants, chosen from the inputs: bf16 with d
and f multiples of 16 runs on the tensor cores (WMMA, 16-row tiles, weights
streamed by ``cp.async``); anything else runs with FMA on the CUDA cores,
walking f in chunks into an f32 output accumulator.
:func:`fused_swiglu_plain` is its plain PyTorch version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import fused_swiglu_ref as fused_swiglu_plain

# tile geometry of csrc/fused_swiglu.cu
FC = 32          # f columns per chunk (FMA variant)
WARPS = 8
TC_WARP_BYTES = 8 * 1024 + 2 * 16 * 16 * 4   # per-warp weight ring + scratch
TILE_ROWS = (16, 8, 4, 2, 1)
SMEM_OPTIN = 232448   # bytes of shared memory a Hopper block may opt into


def smem_bytes(bc: int, d: int, elem_bytes: int) -> int:
    """Dynamic shared memory of one FMA-variant block
    (csrc/fused_swiglu.cu:smem_bytes): f32 accumulator, warp partials,
    activation chunk, x tile."""
    return bc * d * 4 + WARPS * 2 * bc * FC * 4 + bc * FC * 4 + bc * d * elem_bytes


def smem_bytes_tc(d: int, f: int) -> int:
    """Dynamic shared memory of one tensor-core-variant block
    (csrc/fused_swiglu.cu:smem_bytes_tc): bf16 x tile and activation rows
    (16 rows each), then each warp's weight ring and scratch."""
    return 16 * d * 2 + 16 * f * 2 + WARPS * TC_WARP_BYTES


def use_tensor_cores(x: torch.Tensor, ws, limit: int = SMEM_OPTIN) -> bool:
    """Whether the tensor-core variant takes these inputs: bf16, d and f
    multiples of 16, 32-byte aligned operands, and the tile fits."""
    d, f = x.shape[-1], ws[0].shape[-1]
    return (x.dtype == torch.bfloat16 and d % 16 == 0 and f % 16 == 0
            and all(t.data_ptr() % 32 == 0 for t in (x, *ws))
            and smem_bytes_tc(d, f) <= limit)


def tile_rows(c: int, d: int, elem_bytes: int, limit: int = SMEM_OPTIN) -> int:
    """Rows per tile: the largest of 16, 8, 4, 2, 1 that fits the shared
    memory and does not exceed C rounded up to a power of two (decode has
    C = 8)."""
    cap = 1 << max(0, (c - 1).bit_length())
    for bc in TILE_ROWS:
        if bc <= cap and smem_bytes(bc, d, elem_bytes) <= limit:
            return bc
    raise ValueError(f"fused_swiglu: d={d} does not fit one row of "
                     f"{elem_bytes}-byte elements in {limit} B of shared memory")


def fused_swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                 w2: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """silu(x @ w1) * (x @ w3) @ w2 per (s, e) group on the card, rows at or
    past counts zeroed.  x: (S, E, C, d); w1/w3: (E, d, f); w2: (E, f, d);
    counts: (S, E) int32; all contiguous CUDA tensors, x and weights of one
    dtype (float32 or bfloat16)."""
    _build.require_cuda("fused_swiglu", x, w1, w3, w2, counts)
    s, e, c, d = x.shape
    f = w1.shape[-1]
    if (w1.shape != (e, d, f) or w3.shape != (e, d, f) or w2.shape != (e, f, d)
            or counts.shape != (s, e) or counts.dtype != torch.int32):
        raise ValueError(
            f"fused_swiglu: x (S,E,C,d), w1/w3 (E,d,f), w2 (E,f,d), counts "
            f"(S,E) int32; got {tuple(x.shape)} {tuple(w1.shape)} "
            f"{tuple(w3.shape)} {tuple(w2.shape)} {tuple(counts.shape)} "
            f"{counts.dtype}")
    if x.dtype not in _build.DTYPE_CODE or any(
            w.dtype != x.dtype for w in (w1, w3, w2)):
        raise ValueError(f"fused_swiglu: x and weights must share one dtype "
                         f"of {list(_build.DTYPE_CODE)}")
    limit = getattr(torch.cuda.get_device_properties(x.device),
                    "shared_memory_per_block_optin", SMEM_OPTIN)
    out = torch.empty_like(x)
    if use_tensor_cores(x, (w1, w3, w2), limit):
        _launch_tc(x, w1, w3, w2, counts, out)
    else:
        _launch_fma(x, w1, w3, w2, counts, out, limit)
    fused_swiglu.launches += 1
    return out


fused_swiglu.launches = 0


def _launch_tc(x, w1, w3, w2, counts, out) -> None:
    s, e, c, d = x.shape
    fn = _build.bind("fused_swiglu", "fused_swiglu_tc", 6, 5)
    _build.check(fn(x.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
                    counts.data_ptr(), out.data_ptr(), s, e, c, d,
                    w1.shape[-1], _build.stream_of(x)), "fused_swiglu_tc")


def _launch_fma(x, w1, w3, w2, counts, out, limit: int = SMEM_OPTIN) -> None:
    s, e, c, d = x.shape
    bc = tile_rows(c, d, x.element_size(), limit)
    fn = _build.bind("fused_swiglu", "fused_swiglu", 6, 7)
    _build.check(fn(x.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
                    counts.data_ptr(), out.data_ptr(), s, e, c, d,
                    w1.shape[-1], _build.DTYPE_CODE[x.dtype], bc,
                    _build.stream_of(x)), "fused_swiglu")
