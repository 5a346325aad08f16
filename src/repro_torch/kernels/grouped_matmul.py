"""Grouped, row-masked matmul over the landed dispatch buffer, on Hopper.

Port of the Pallas kernel ``repro/kernels/grouped_matmul.py``.  The CUDA
kernel is ``csrc/grouped_matmul.cu`` (its header says what bounds it and how
it is laid out): one block per (column tile, row tile, group), the
contraction looped inside the block, a tile past the group's occupancy
written as zeros without reading x or w.  bf16 runs the Hopper form (128 x
256 tiles, TMA into a four-stage shared-memory ring, ``wgmma`` on two
consumer warpgroups); float32 runs with FMA.  The weights are read through
their strides, so a transposed view (``w.transpose(1, 2)``) is taken without
a copy (loaded K-major; a row-major weight is loaded MN-major), and group g
reads weight ``g % E``, so the S source lanes of a landed (S, E, C, .) buffer
share their experts' weights in one launch.
:func:`grouped_matmul_plain` is its plain PyTorch version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import grouped_matmul_ref as grouped_matmul_plain

MAX_GROUPS = 65535     # the FMA form's grid z extent (float32 only)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   counts: torch.Tensor) -> torch.Tensor:
    """out[g] = x[g] @ w[g % E] on the card, rows at or past counts[g] zero.

    x: (G, C, K) contiguous; w: (E, K, N) with G % E == 0, any strides
    (bf16: unit stride along N or along K, 16-byte aligned rows; float32: G
    <= MAX_GROUPS); counts: (G,) int32; x and w of one dtype (float32 or
    bfloat16).  Returns (G, C, N) in x's dtype."""
    _build.require_cuda("grouped_matmul", x, counts)
    if w.device != x.device:
        raise ValueError(f"grouped_matmul: w on {w.device}, x on {x.device}")
    if x.ndim != 3 or w.ndim != 3 or w.shape[1] != x.shape[2]:
        raise ValueError(f"grouped_matmul: x (G, C, K), w (E, K, N); got "
                         f"{tuple(x.shape)} {tuple(w.shape)}")
    g, c, k = x.shape
    e, _, n = w.shape
    if e == 0 or g % e or (x.dtype == torch.float32 and g > MAX_GROUPS):
        raise ValueError(f"grouped_matmul: {g} groups over {e} weights "
                         f"(G % E == 0; float32: G <= {MAX_GROUPS})")
    if counts.shape != (g,) or counts.dtype != torch.int32:
        raise ValueError(f"grouped_matmul: counts ({g},) int32; got "
                         f"{tuple(counts.shape)} {counts.dtype}")
    if x.dtype not in _build.DTYPE_CODE or w.dtype != x.dtype:
        raise ValueError(f"grouped_matmul: x and w must share one dtype of "
                         f"{list(_build.DTYPE_CODE)}")
    strides = w.stride()
    if max(strides) >= 2 ** 31:
        raise ValueError(f"grouped_matmul: w strides {strides} exceed int32")
    if x.dtype == torch.bfloat16 and not tensor_core_layout(x, w):
        raise ValueError(
            "grouped_matmul: bf16 needs K and N multiples of 8, 16-byte "
            "aligned x and w, and w with unit stride along N or K (strides "
            f"{strides}, multiples of 8); got x {tuple(x.shape)}, w "
            f"{tuple(w.shape)}")
    out = torch.empty((g, c, n), dtype=x.dtype, device=x.device)
    launch(x, w, counts, out)
    grouped_matmul.launches += 1
    return out


def launch(x: torch.Tensor, w: torch.Tensor, counts: torch.Tensor,
           out: torch.Tensor) -> None:
    """The C entry on checked operands, into ``out`` (G, C, N); counted by
    its caller (fused_swiglu's large-f form runs it as its second
    launch)."""
    g, c, k = x.shape
    e, _, n = w.shape
    fn = _build.bind("grouped_matmul", "grouped_matmul", 4, 9)
    _build.check(fn(x.data_ptr(), w.data_ptr(), counts.data_ptr(),
                    out.data_ptr(), g, e, c, k, n, *w.stride(),
                    _build.DTYPE_CODE[x.dtype], _build.stream_of(x)),
                 "grouped_matmul")


grouped_matmul.launches = 0


def tensor_core_layout(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether the bf16 Hopper form takes these operands, which is what its
    TMA maps need: K and N multiples of 8, 16-byte aligned pointers, w's
    expert stride a multiple of 8, and w unit-strided along N (row-major,
    loaded MN-major) or along K (a transposed view, loaded K-major) with the
    other stride a multiple of 8."""
    k, n = w.shape[1], w.shape[2]
    s_e, s_k, s_n = w.stride()
    unit = (s_n == 1 and s_k % 8 == 0) or (s_k == 1 and s_n % 8 == 0)
    return (k % 8 == 0 and n % 8 == 0 and s_e % 8 == 0 and unit
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
