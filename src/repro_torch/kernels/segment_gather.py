"""Descriptor-driven row gather (dComm dispatch copy) on Hopper.

Port of the Pallas kernel ``repro/kernels/segment_gather.py``.  The CUDA
kernel is ``csrc/segment_gather.cu`` (its header says what bounds it and how
it is laid out); :func:`segment_gather_plain` is its plain PyTorch version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import segment_gather_ref as segment_gather_plain


def _vec_bytes(row_bytes: int, *ptrs: int) -> int:
    """Widest copy unit (16, 8, 4 or 2 bytes) that divides the row and
    aligns every pointer."""
    for v in (16, 8, 4, 2):
        if row_bytes % v == 0 and all(p % v == 0 for p in ptrs):
            return v
    raise ValueError(f"segment_gather: row of {row_bytes} bytes has no "
                     "2-byte-aligned copy unit")


def segment_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = src[idx[i]] (idx -1 -> zeros) on the card.  src: (T, d)
    contiguous CUDA tensor; idx: (R,) int32 on the same device."""
    _build.require_cuda("segment_gather", src, idx)
    if src.ndim != 2 or idx.ndim != 1 or idx.dtype != torch.int32:
        raise ValueError(f"segment_gather: src (T, d), idx (R,) int32; got "
                         f"{tuple(src.shape)}, {tuple(idx.shape)} {idx.dtype}")
    t, d = src.shape
    out = torch.empty((idx.shape[0], d), dtype=src.dtype, device=src.device)
    row_bytes = d * src.element_size()
    fn = _build.bind("segment_gather", "segment_gather", 3, 4)
    _build.check(fn(src.data_ptr(), idx.data_ptr(), out.data_ptr(), t,
                    idx.shape[0], row_bytes,
                    _vec_bytes(row_bytes, src.data_ptr(), out.data_ptr()),
                    _build.stream_of(src)), "segment_gather")
    segment_gather.launches += 1
    return out


segment_gather.launches = 0
