"""Gated scatter-add (dComm combine) on Hopper, and its backward.

Port of the Pallas kernel ``repro/kernels/segment_scatter_add.py``.  The CUDA
kernels are in ``csrc/segment_scatter_add.cu`` (its header says what bounds
them and how they are laid out):

- :func:`segment_scatter_add`: a deterministic owner-reduce.  Each output
  row is summed by one block from its owner list (the source rows landing on
  it) in the list's order, in float32, and written once; no atomics, so two
  calls give the same bits.  The lists are a (out_rows, K) table (the flat
  plan's slot table) or, when the caller has none, the CSR lists that
  :func:`build_owners` makes on the card, each ascending.
- :func:`segment_scatter_add_bwd`: one pass over the source rows, a gather
  of the cotangent: dsrc = gates * dout[dst], dgates = sum_d dout[dst] * src.

:func:`segment_scatter_add_plain`, :func:`owner_reduce_plain`,
:func:`build_owners_plain` and :func:`segment_scatter_add_bwd_plain` are the
plain PyTorch versions.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import build_owners_ref as build_owners_plain
from repro_torch.kernels.ref import owner_reduce_ref as owner_reduce_plain
from repro_torch.kernels.ref import owner_table
from repro_torch.kernels.ref import (
    segment_scatter_add_bwd as segment_scatter_add_bwd_plain)
from repro_torch.kernels.ref import (
    segment_scatter_add_ref as segment_scatter_add_plain)


def _vec(d: int, *tensors: torch.Tensor) -> int:
    """Elements per 16-byte vector when d and every pointer allow it, else 1."""
    per = 16 // tensors[0].element_size()
    ok = d % per == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)
    return per if ok else 1


def build_owners(dst: torch.Tensor, out_rows: int):
    """The owner lists of ``dst`` (R,) int32 over [0, out_rows), built on the
    card by the counting pass: offsets (out_rows + 1,) and owners (nnz,)
    int32, each list in ascending source-row order (rows with dst outside
    [0, out_rows) in no list)."""
    _build.require_cuda("segment_scatter_add owners", dst)
    if dst.ndim != 1 or dst.dtype != torch.int32:
        raise ValueError("segment_scatter_add owners: dst (R,) int32")
    r = dst.shape[0]
    dev = dst.device
    counts = torch.empty(max(out_rows, 1), dtype=torch.int32, device=dev)
    offsets = torch.empty(out_rows + 1, dtype=torch.int32, device=dev)
    unsorted = torch.empty(max(r, 1), dtype=torch.int32, device=dev)
    owners = torch.empty(max(r, 1), dtype=torch.int32, device=dev)
    fn = _build.bind("segment_scatter_add", "segment_scatter_add_owners", 5, 2)
    _build.check(fn(dst.data_ptr(), counts.data_ptr(), offsets.data_ptr(),
                    unsorted.data_ptr(), owners.data_ptr(), r, out_rows,
                    _build.stream_of(dst)), "segment_scatter_add owners")
    build_owners.launches += 1
    return offsets, owners


def segment_scatter_add(src: torch.Tensor, dst: torch.Tensor,
                        gates: torch.Tensor, out_rows: int,
                        owners: torch.Tensor | None = None) -> torch.Tensor:
    """out[t] = sum of gates[i] * src[i] over the rows i with dst[i] == t,
    on the card; dst == -1 dropped.  src: (R, d) float32/bfloat16; dst: (R,)
    int32; gates: (R,) float32; owners: (out_rows, K) int32, row t listing
    the source rows of t (-1 for none; the flat plan's slot table), or None
    to build the lists from dst (:func:`build_owners`)."""
    _build.require_cuda("segment_scatter_add", src, dst, gates)
    if src.dtype not in _build.DTYPE_CODE:
        raise ValueError(f"segment_scatter_add: dtype {src.dtype} not built")
    r = src.shape[0]
    if (src.ndim != 2 or dst.shape != (r,) or gates.shape != (r,)
            or dst.dtype != torch.int32 or gates.dtype != torch.float32):
        raise ValueError("segment_scatter_add: src (R, d), dst (R,) int32, "
                         "gates (R,) float32")
    if owners is None:
        offsets, lists = build_owners(dst, out_rows)
        width = 0
    else:
        _build.require_cuda("segment_scatter_add", src, owners)
        if (owners.ndim != 2 or owners.shape[0] != out_rows
                or owners.dtype != torch.int32):
            raise ValueError(f"segment_scatter_add: owners ({out_rows}, K) "
                             f"int32; got {tuple(owners.shape)} {owners.dtype}")
        offsets, lists, width = None, owners, owners.shape[1]
    d = src.shape[1]
    out = torch.empty((out_rows, d), dtype=src.dtype, device=src.device)
    fn = _build.bind("segment_scatter_add", "segment_scatter_add", 5, 6)
    _build.check(fn(src.data_ptr(), gates.data_ptr(),
                    0 if offsets is None else offsets.data_ptr(),
                    lists.data_ptr(), out.data_ptr(), r, d, out_rows, width,
                    _build.DTYPE_CODE[src.dtype], _vec(d, src, out),
                    _build.stream_of(src)), "segment_scatter_add")
    segment_scatter_add.launches += 1
    return out


def segment_scatter_add_bwd(src: torch.Tensor, dst: torch.Tensor,
                            gates: torch.Tensor, dout: torch.Tensor):
    """The VJP of the scatter-add on the card: (dsrc (R, d) in src's dtype,
    dgates (R,) float32), zeros for dropped rows.  src: (R, d); dst: (R,)
    int32; gates: (R,) float32; dout: (out_rows, d) in src's dtype."""
    _build.require_cuda("segment_scatter_add_bwd", src, dst, gates, dout)
    r = src.shape[0]
    if (src.ndim != 2 or dst.shape != (r,) or gates.shape != (r,)
            or dst.dtype != torch.int32 or gates.dtype != torch.float32
            or dout.ndim != 2 or dout.shape[1] != src.shape[1]
            or dout.dtype != src.dtype or src.dtype not in _build.DTYPE_CODE):
        raise ValueError("segment_scatter_add_bwd: src (R, d), dst (R,) int32, "
                         "gates (R,) float32, dout (out_rows, d) of src's dtype")
    d = src.shape[1]
    dsrc = torch.empty_like(src)
    dgates = torch.empty(r, dtype=torch.float32, device=src.device)
    fn = _build.bind("segment_scatter_add", "segment_scatter_add_bwd", 6, 5)
    _build.check(fn(src.data_ptr(), dst.data_ptr(), gates.data_ptr(),
                    dout.data_ptr(), dsrc.data_ptr(), dgates.data_ptr(), r, d,
                    dout.shape[0], _build.DTYPE_CODE[src.dtype],
                    _vec(d, src, dout, dsrc), _build.stream_of(src)),
                 "segment_scatter_add_bwd")
    segment_scatter_add_bwd.launches += 1
    return dsrc, dgates


build_owners.launches = 0
segment_scatter_add.launches = 0
segment_scatter_add_bwd.launches = 0
