"""Position-safe, block-skipping GQA flash attention forward, on Hopper.

Port of the Pallas kernel ``repro/kernels/flash_attention.py``
(``_flash_fwd_pallas``).  The CUDA kernel is ``csrc/flash_attention.cu`` (its
header says what bounds it and how it is laid out): one block per (batch row,
kv head, tile of query rows), the kv sequence walked by a loop inside the
block, online softmax in float32, and a kv tile skipped only when the
positions' bounds prove it masked.  bf16 runs on the tensor cores
(``mma.sync``); float32 runs with FMA on the CUDA cores.  Block sizes are the
kernel's own.  :func:`flash_attention_plain` is its plain PyTorch version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref as flash_attention_plain

HEAD_DIMS = (16, 32, 64, 128)     # template instances of csrc/flash_attention.cu


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_positions: torch.Tensor, k_positions: torch.Tensor,
                    causal: bool = True, window: int | None = None):
    """Attention masked from the actual positions, on the card.

    q: (B, Sq, Hq, hd); k/v: (B, Sk, Hkv, hd), Hq % Hkv == 0, hd one of
    :data:`HEAD_DIMS`; all contiguous CUDA tensors of one dtype (float32 or
    bfloat16), 16-byte aligned.  positions: (Sq,)/(Sk,) int32.  Returns the
    output (B, Sq, Hq, hd) in q's dtype and the log-sum-exp (B, Hq, Sq)
    float32."""
    _build.require_cuda("flash_attention", q, k, v, q_positions, k_positions)
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q (B,Sq,Hq,hd), k/v (B,Sk,Hkv,hd); "
                         f"got {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    b, sq, hq, hd = q.shape
    _, sk, hkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != hd or hkv == 0 or hq % hkv != 0:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)} (same B and hd, Hq % Hkv == 0)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in _build.DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must share one dtype of "
                         f"{list(_build.DTYPE_CODE)}")
    if (q_positions.shape != (sq,) or k_positions.shape != (sk,)
            or q_positions.dtype != torch.int32
            or k_positions.dtype != torch.int32):
        raise ValueError(f"flash_attention: positions ({sq},)/({sk},) int32; "
                         f"got {tuple(q_positions.shape)} {q_positions.dtype}, "
                         f"{tuple(k_positions.shape)} {k_positions.dtype}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be 16-byte aligned")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    # bf16 takes the tensor-core form, float32 the FMA form (the C entry
    # chooses by the dtype code)
    fn = _build.bind("flash_attention", "flash_attention_fwd", 7, 9)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    q_positions.data_ptr(), k_positions.data_ptr(),
                    out.data_ptr(), lse.data_ptr(), b, sq, sk, hq, hkv, hd,
                    _build.DTYPE_CODE[q.dtype], int(causal), window or 0,
                    _build.stream_of(q)), "flash_attention")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0
