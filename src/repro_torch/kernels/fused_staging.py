"""Fused grouped SwiGLU over the landed dispatch buffer, on Hopper.

Port of the Pallas kernel ``repro/kernels/fused_staging.py``
(``fused_swiglu_pallas``).  The CUDA kernels are in ``csrc/fused_swiglu.cu``
(its header says what bounds them on the H100 and how they are laid out):
one block per (source lane, local expert, tile of rows) keeps the tile's
hidden activations in shared memory, so the (C, f) activations never reach
device memory; a tile past the group's occupancy writes zeros and skips its
weights.  Three forms, chosen from the inputs (:func:`form`): bf16 with d
and f multiples of 8 and 16-byte aligned operands runs the Hopper form
(64-row tiles, each split over a two-CTA cluster; TMA into a shared-memory
ring, ``wgmma`` on two consumer warpgroups; :func:`hopper_plan` mirrors its
shared-memory plan) where the 64 x f activations fit beside its stages;
where they do not (f above ~1472: deepseek-v3-bench, mixtral-8x22b) two
tensor-core launches, the gate/up products with the SwiGLU applied in
registers into an (S E, C, f) bf16 buffer (``grouped_swiglu`` in
``csrc/grouped_matmul.cu``) and ``grouped_matmul`` of it by w2; float32
runs with FMA on the CUDA cores (bf16 only where TMA refuses the operands),
walking f in chunks into an f32 output accumulator.
:func:`fused_swiglu_plain` is its plain PyTorch version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import grouped_matmul as gmm_k
from repro_torch.kernels.ref import fused_swiglu_ref as fused_swiglu_plain

# tile geometry of csrc/fused_swiglu.cu
FC = 32          # f columns per chunk (FMA form)
WARPS = 8
TILE_ROWS = (16, 8, 4, 2, 1)
SMEM_OPTIN = 232448   # bytes of shared memory a Hopper block may opt into
# the Hopper form (swiglu_wgmma): 64-row tiles, the resident activations
# (64 x f rounded up to 64 columns, bf16) and SMEM_FIXED bytes of alignment
# slack and barriers, then stages of one x k-tile (64 x BK) and four BK x 64
# weight boxes, as many as fit up to MAX_STAGES
TILE_M = 64
BK = 32
ACT_BLOCK = TILE_M * 64 * 2
STAGE_BYTES = TILE_M * BK * 2 + 4 * BK * 64 * 2
MAX_STAGES = 8
MIN_STAGES = 2
SMEM_FIXED = 1024 + 256


def smem_bytes(bc: int, d: int, elem_bytes: int) -> int:
    """Dynamic shared memory of one FMA-form block
    (csrc/fused_swiglu.cu:smem_bytes): f32 accumulator, warp partials,
    activation chunk, x tile."""
    return bc * d * 4 + WARPS * 2 * bc * FC * 4 + bc * FC * 4 + bc * d * elem_bytes


def hopper_plan(f: int, limit: int = SMEM_OPTIN) -> tuple[int, int]:
    """(stages, shared-memory bytes) of one Hopper-form block
    (csrc/fused_swiglu.cu:hopper_stages, smem_bytes_hopper): the resident
    bf16 activations, 64 rows by f rounded up to 64, then as many stages as
    fit, at most MAX_STAGES.  Fewer than MIN_STAGES stages means the form
    cannot take this f."""
    act = -(-f // 64) * ACT_BLOCK
    stages = min(MAX_STAGES, (SMEM_OPTIN - SMEM_FIXED - act) // STAGE_BYTES)
    smem = SMEM_FIXED + act + max(stages, 0) * STAGE_BYTES
    return (stages if smem <= limit else 0), smem


def tma_layout(x: torch.Tensor, ws) -> bool:
    """Whether TMA takes these operands: bf16, d and f positive multiples of
    8 (16-byte strides) and 16-byte aligned pointers."""
    d, f = x.shape[-1], ws[0].shape[-1]
    return (x.dtype == torch.bfloat16 and d % 8 == 0 and f % 8 == 0
            and d > 0 and f > 0
            and all(t.data_ptr() % 16 == 0 for t in (x, *ws)))


def use_tensor_cores(x: torch.Tensor, ws, limit: int = SMEM_OPTIN) -> bool:
    """Whether the Hopper form takes these inputs: :func:`tma_layout`, and
    at least MIN_STAGES stages beside the resident activations."""
    return (tma_layout(x, ws)
            and hopper_plan(ws[0].shape[-1], limit)[0] >= MIN_STAGES)


def form(x: torch.Tensor, ws, limit: int = SMEM_OPTIN) -> str:
    """The form a call takes: "wgmma" (the Hopper form), "split" (bf16 at
    an f the Hopper form cannot keep resident: two tensor-core launches) or
    "fma" (float32, and bf16 operands TMA refuses: d or f not a multiple
    of 8, which no config has)."""
    if use_tensor_cores(x, ws, limit):
        return "wgmma"
    if tma_layout(x, ws):
        return "split"
    return "fma"


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
    how = form(x, (w1, w3, w2), limit)
    {"wgmma": _launch_tc, "split": _launch_split,
     "fma": lambda *a: _launch_fma(*a, limit)}[how](x, w1, w3, w2, counts,
                                                    out)
    fused_swiglu.launches += 1
    fused_swiglu.forms[how] += 1
    return out


fused_swiglu.launches = 0
# launches by form (:func:`form`), beside the one count of the wrapper
fused_swiglu.forms = {"wgmma": 0, "split": 0, "fma": 0}


def _launch_tc(x, w1, w3, w2, counts, out) -> None:
    s, e, c, d = x.shape
    fn = _build.bind("fused_swiglu", "fused_swiglu_tc", 6, 5)
    _build.check(fn(x.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
                    counts.data_ptr(), out.data_ptr(), s, e, c, d,
                    w1.shape[-1], _build.stream_of(x)), "fused_swiglu_tc")


def _launch_split(x, w1, w3, w2, counts, out) -> None:
    """The large-f form: silu(x @ w1) * (x @ w3) into an (S E, C, f) bf16
    buffer (``grouped_swiglu``, one group per (s, e), rows past counts
    zero), then the buffer by w2 (grouped_matmul's C entry) into ``out``."""
    s, e, c, d = x.shape
    f = w1.shape[-1]
    cnt = counts.reshape(-1)
    a = torch.empty((s * e, c, f), dtype=x.dtype, device=x.device)
    fn = _build.bind("grouped_matmul", "grouped_swiglu", 5, 6)
    _build.check(fn(x.data_ptr(), w1.data_ptr(), w3.data_ptr(),
                    cnt.data_ptr(), a.data_ptr(), s * e, e, c, d, f, d * f,
                    _build.stream_of(x)), "grouped_swiglu")
    gmm_k.launch(a, w2, cnt, out.view(s * e, c, d))


def _launch_fma(x, w1, w3, w2, counts, out, limit: int = SMEM_OPTIN) -> None:
    s, e, c, d = x.shape
    bc = tile_rows(c, d, x.element_size(), limit)
    fn = _build.bind("fused_swiglu", "fused_swiglu", 6, 7)
    _build.check(fn(x.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
                    counts.data_ptr(), out.data_ptr(), s, e, c, d,
                    w1.shape[-1], _build.DTYPE_CODE[x.dtype], bc,
                    _build.stream_of(x)), "fused_swiglu")
