"""Entry points of the kernels, dispatched by the tensor's device (port of
``repro/kernels/ops.py``, forward only).

A CPU tensor takes the plain PyTorch version (``kernels/ref.py``).  A CUDA
tensor takes the hand-written kernel, which raises if it cannot build or
launch.  There is no environment switch and no fallback: this replaces the
reference's ``use_pallas()`` choices (ops.py:38-51, 171-183).  Gradients
(``torch.autograd.Function``s mirroring the reference's custom VJPs) come with
the training slice.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as flash_k
from repro_torch.kernels import fused_staging, ref
from repro_torch.kernels import segment_gather as gather_k
from repro_torch.kernels import segment_scatter_add as scatter_k


def _on_cuda(what: str, t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel or plain path for device {t.device}")


def segment_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = src[idx[i]]; idx == -1 -> zeros.  src: (T, d); idx: (R,)."""
    if _on_cuda("segment_gather", src):
        return gather_k.segment_gather(src.contiguous(),
                                       idx.to(torch.int32).contiguous())
    return ref.segment_gather_ref(src, idx)


def segment_scatter_add(src: torch.Tensor, dst: torch.Tensor,
                        gates: torch.Tensor, out_rows: int) -> torch.Tensor:
    """out[dst[i]] += gates[i] * src[i], f32 accumulation; dst == -1
    dropped.  src: (R, d); dst/gates: (R,)."""
    if _on_cuda("segment_scatter_add", src):
        return scatter_k.segment_scatter_add(
            src.contiguous(), dst.to(torch.int32).contiguous(),
            gates.to(torch.float32).contiguous(), out_rows)
    return ref.segment_scatter_add_ref(src, dst, gates, out_rows)


def fused_swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                 w2: torch.Tensor,
                 counts: torch.Tensor | None = None) -> torch.Tensor:
    """Grouped SwiGLU over the landed buffer, silu(x@w1) * (x@w3) @ w2 per
    (source lane, local expert) group.  x: (S, E, C, d); w1/w3: (E, d, f);
    w2: (E, f, d); counts: (S, E) occupancy or None (all rows live)."""
    if counts is None:
        counts = torch.full(x.shape[:2], x.shape[2], dtype=torch.int32,
                            device=x.device)
    if _on_cuda("fused_swiglu", x):
        return fused_staging.fused_swiglu(
            x.contiguous(), w1.contiguous(), w3.contiguous(), w2.contiguous(),
            counts.to(torch.int32).contiguous())
    return ref.fused_swiglu_ref(x, w1, w3, w2, counts)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_positions: torch.Tensor, k_positions: torch.Tensor,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """Position-safe GQA attention: masked from the actual positions, so a
    shifted query stripe against the gathered k/v is right.  q: (B, Sq, Hq,
    hd); k/v: (B, Sk, Hkv, hd); positions (Sq,)/(Sk,).  Returns (B, Sq, Hq,
    hd) in q's dtype; the block sizes are the kernel's own choice."""
    if _on_cuda("flash_attention", q):
        out, _ = flash_k.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(),
            q_positions.to(torch.int32).contiguous(),
            k_positions.to(torch.int32).contiguous(), causal, window)
        return out
    out, _ = ref.flash_attention_ref(q, k, v, q_positions, k_positions,
                                     causal, window)
    return out
