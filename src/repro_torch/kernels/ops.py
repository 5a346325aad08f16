"""Entry points of the kernels, dispatched by the tensor's device, with their
gradients (port of ``repro/kernels/ops.py``).

A CPU tensor takes the plain PyTorch version (``kernels/ref.py``).  A CUDA
tensor takes the hand-written kernel, which raises if it cannot build or
launch.  There is no environment switch and no fallback: this replaces the
reference's ``use_pallas()`` choices (ops.py:38-51, 171-183).

Every entry but ``grouped_matmul`` is a ``torch.autograd.Function`` that
mirrors the reference's custom VJP and dispatches its backward by device the
same way (``ref.*_bwd``): the gather's backward is the scatter-add kernel
(over the owner lists the caller passes), the scatter-add's backward a
one-pass kernel of its own; the fused SwiGLU backward recomputes
its hidden activations, its row-masked products on the grouped-matmul
kernel; the flash backward is a blockwise torch recompute from the
forward's lse, as the reference's is lax and not Pallas.
``grouped_matmul`` is forward-only, as in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as flash_k
from repro_torch.kernels import fused_staging, ref
from repro_torch.kernels import grouped_matmul as gmm_k
from repro_torch.kernels import segment_gather as gather_k
from repro_torch.kernels import segment_scatter_add as scatter_k


def _on_cuda(what: str, t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel or plain path for device {t.device}")


class _SegmentGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, idx, owners):
        ctx.save_for_backward(idx, owners)
        ctx.rows = src.shape[0]
        if _on_cuda("segment_gather", src):
            return gather_k.segment_gather(src.contiguous(),
                                           idx.to(torch.int32).contiguous())
        return ref.segment_gather_ref(src, idx)

    @staticmethod
    def backward(ctx, dout):
        # the transpose: a unit-gate scatter-add of the cotangent
        idx, owners = ctx.saved_tensors
        ones = torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
        return segment_scatter_add(dout, idx, ones, ctx.rows, owners), None, None


def segment_gather(src: torch.Tensor, idx: torch.Tensor,
                   owners: torch.Tensor | None = None) -> torch.Tensor:
    """out[i] = src[idx[i]]; idx == -1 -> zeros.  src: (T, d); idx: (R,);
    owners: (T, K), row t the rows i with idx[i] == t (-1 for none), or
    None.  Backward: the scatter-add of the cotangent with unit gates, over
    ``owners`` when given."""
    return _SegmentGather.apply(src, idx, owners)


class _SegmentScatterAdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, dst, gates, out_rows, owners):
        ctx.save_for_backward(src, dst, gates)
        if _on_cuda("segment_scatter_add", src):
            return scatter_k.segment_scatter_add(
                src.contiguous(), dst.to(torch.int32).contiguous(),
                gates.to(torch.float32).contiguous(), out_rows,
                None if owners is None else owners.to(torch.int32).contiguous())
        if owners is not None:
            return ref.owner_reduce_ref(src, gates, owners, out_rows)
        return ref.segment_scatter_add_ref(src, dst, gates, out_rows)

    @staticmethod
    def backward(ctx, dout):
        src, dst, gates = ctx.saved_tensors
        if _on_cuda("segment_scatter_add", src):
            dsrc, dgates = scatter_k.segment_scatter_add_bwd(
                src.contiguous(), dst.to(torch.int32).contiguous(),
                gates.to(torch.float32).contiguous(),
                dout.to(src.dtype).contiguous())
            dgates = dgates.to(gates.dtype)
        else:
            dsrc, dgates = ref.segment_scatter_add_bwd(src, dst, gates, dout)
        return dsrc, None, dgates, None, None


def segment_scatter_add(src: torch.Tensor, dst: torch.Tensor,
                        gates: torch.Tensor, out_rows: int,
                        owners: torch.Tensor | None = None) -> torch.Tensor:
    """out[dst[i]] += gates[i] * src[i], f32 accumulation; dst == -1
    dropped.  src: (R, d); dst/gates: (R,); owners: (out_rows, K), row t the
    source rows landing on t (-1 for none; the flat plan's slot table), or
    None.  The card sums each output row over its owners in a fixed order
    (lists built from dst when none are given); the CPU takes the plain
    owner-reduce when owners are given.  Backward: the gather of the
    cotangent times the gates, and per-row dgates."""
    return _SegmentScatterAdd.apply(src, dst, gates, out_rows, owners)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   counts: torch.Tensor) -> torch.Tensor:
    """out[g] = x[g] @ w[g % E], rows at or past counts[g] zero.  x: (G, C,
    K); w: (E, K, N), any strides (a transposed view is read in place);
    counts: (G,).  Forward-only, as the reference's."""
    if _on_cuda("grouped_matmul", x):
        return gmm_k.grouped_matmul(x.contiguous(), w,
                                    counts.to(torch.int32).contiguous())
    return ref.grouped_matmul_ref(x, w, counts)


class _FusedSwiglu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, w3, w2, counts):
        ctx.save_for_backward(x, w1, w3, w2, counts)
        if _on_cuda("fused_swiglu", x):
            return fused_staging.fused_swiglu(
                x.contiguous(), w1.contiguous(), w3.contiguous(),
                w2.contiguous(), counts.to(torch.int32).contiguous())
        return ref.fused_swiglu_ref(x, w1, w3, w2, counts)

    @staticmethod
    def backward(ctx, dy):
        x, w1, w3, w2, counts = ctx.saved_tensors
        return (*ref.fused_swiglu_bwd(x, w1, w3, w2, counts, dy,
                                      gmm=grouped_matmul), None)


def fused_swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                 w2: torch.Tensor,
                 counts: torch.Tensor | None = None) -> torch.Tensor:
    """Grouped SwiGLU over the landed buffer, silu(x@w1) * (x@w3) @ w2 per
    (source lane, local expert) group.  x: (S, E, C, d); w1/w3: (E, d, f);
    w2: (E, f, d); counts: (S, E) occupancy or None (all rows live).
    Backward: the recompute of ``ref.fused_swiglu_bwd`` on the grouped
    matmul."""
    if counts is None:
        counts = torch.full(x.shape[:2], x.shape[2], dtype=torch.int32,
                            device=x.device)
    return _FusedSwiglu.apply(x, w1, w3, w2, counts)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_positions, k_positions, causal, window):
        if _on_cuda("flash_attention", q):
            out, lse = flash_k.flash_attention(
                q.contiguous(), k.contiguous(), v.contiguous(),
                q_positions.to(torch.int32).contiguous(),
                k_positions.to(torch.int32).contiguous(), causal, window)
        else:
            out, lse = ref.flash_attention_ref(q, k, v, q_positions,
                                               k_positions, causal, window)
        ctx.save_for_backward(q, k, v, q_positions, k_positions, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, qp, kp, out, lse = ctx.saved_tensors
        dq, dk, dv = ref.flash_attention_bwd(q, k, v, qp, kp, out, lse, dout,
                                             ctx.causal, ctx.window)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_positions: torch.Tensor, k_positions: torch.Tensor,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """Position-safe GQA attention: masked from the actual positions, so a
    shifted query stripe against the gathered k/v is right.  q: (B, Sq, Hq,
    hd); k/v: (B, Sk, Hkv, hd); positions (Sq,)/(Sk,).  Returns (B, Sq, Hq,
    hd) in q's dtype; the block sizes are the kernel's own.  Backward:
    ``ref.flash_attention_bwd`` from the forward's lse."""
    return _FlashAttention.apply(q, k, v, q_positions, k_positions, causal,
                                 window)
