"""Gated scatter-add (dComm combine) on Hopper.

Port of the Pallas kernel ``repro/kernels/segment_scatter_add.py``.  The CUDA
kernel is ``csrc/segment_scatter_add.cu``: float32 atomics into a zeroed
accumulator, then a cast, because Hopper blocks run in parallel where the
TPU grid ran in order.  The summation order therefore changes from run to
run; results agree with :func:`segment_scatter_add_plain` up to float32
rounding of a reordered sum (and one bf16 rounding on top for bf16).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (
    segment_scatter_add_ref as segment_scatter_add_plain)


def segment_scatter_add(src: torch.Tensor, dst: torch.Tensor,
                        gates: torch.Tensor, out_rows: int) -> torch.Tensor:
    """out[dst[i]] += gates[i] * src[i] on the card; dst == -1 dropped.
    src: (R, d) float32/bfloat16; dst: (R,) int32; gates: (R,) float32."""
    _build.require_cuda("segment_scatter_add", src, dst, gates)
    if src.dtype not in _build.DTYPE_CODE:
        raise ValueError(f"segment_scatter_add: dtype {src.dtype} not built")
    r = src.shape[0]
    if (src.ndim != 2 or dst.shape != (r,) or gates.shape != (r,)
            or dst.dtype != torch.int32 or gates.dtype != torch.float32):
        raise ValueError("segment_scatter_add: src (R, d), dst (R,) int32, "
                         "gates (R,) float32")
    d = src.shape[1]
    acc = torch.zeros((out_rows, d), dtype=torch.float32, device=src.device)
    out = acc if src.dtype == torch.float32 else torch.empty(
        (out_rows, d), dtype=src.dtype, device=src.device)
    fn = _build.bind("segment_scatter_add", "segment_scatter_add", 5, 4)
    _build.check(fn(src.data_ptr(), dst.data_ptr(), gates.data_ptr(),
                    acc.data_ptr(), out.data_ptr(), r, d, out_rows,
                    _build.DTYPE_CODE[src.dtype], _build.stream_of(src)),
                 "segment_scatter_add")
    segment_scatter_add.launches += 1
    return out


segment_scatter_add.launches = 0
