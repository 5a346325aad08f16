"""Position-safe, block-skipping GQA flash attention forward, on Hopper.

Port of the Pallas kernel ``repro/kernels/flash_attention.py``
(``_flash_fwd_pallas``).  The CUDA kernel is ``csrc/flash_attention.cu`` (its
header says what bounds it and how it is laid out): one block per (batch row,
kv head, tile of query rows), the kv sequence walked by a loop inside the
block, online softmax in float32, and a kv tile skipped only when the
positions' bounds prove it masked.  bf16 runs the Hopper form
(``flash_fwd_wgmma``: TMA into a shared-memory ring, ``wgmma`` on a
consumer warpgroup; :func:`hopper_plan` mirrors its shared-memory plan,
:func:`hopper_tiles` its query tiles) at head dims 64 and 128 and every
group size Hq / Hkv up to 64, every full-width path; the bf16 shapes it
refuses (:func:`hopper_refusal`: the reduced models' hd 16 and 32) run the
tensor-core form (``flash_fwd_tc``, ``mma.sync``).  float32 runs with FMA
on the CUDA cores.
Block sizes are the kernel's own.  :func:`flash_attention_plain` is its
plain PyTorch version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref as flash_attention_plain

HEAD_DIMS = (16, 32, 64, 128)     # template instances of the FMA and mma.sync forms
# the Hopper form of csrc/flash_attention.cu (bf16): CTAs of ROWS (query,
# head-in-group) rows, hopper_tiles(G) of them live, over kv tiles of KEYS
# keys, STAGES[hd] stages of a K and a V tile and the tile's int32 key
# positions, the Q tile resident, SMEM_FIXED bytes of alignment slack,
# barriers and the tile table
HOPPER_HEAD_DIMS = (64, 128)
ROWS = 64
KEYS = 64
THREADS = 160
STAGES = {64: 2, 128: 2}
SMEM_FIXED = 1024 + 256


def hopper_plan(hd: int) -> tuple[int, int]:
    """(stages, dynamic shared-memory bytes) of one Hopper-form CTA at head
    dim ``hd`` (csrc/flash_attention.cu: kFlashStages*, kFlashSmem*)."""
    stages = STAGES[hd]
    return stages, SMEM_FIXED + ROWS * hd * 2 + stages * (2 * KEYS * hd * 2
                                                          + KEYS * 4)


def hopper_tiles(g: int) -> tuple[int, int]:
    """(queries, live rows) of one Hopper-form CTA at group size ``g``: the
    ``g`` heads of ROWS // g queries, the rows of the 64-row wgmma tile
    its Q box fills (csrc/flash_attention.cu: flash_tile_queries).  The
    grid covers Sq in ceil(Sq / queries) tiles."""
    queries = ROWS // g
    return queries, queries * g


def hopper_refusal(hd: int, hq: int, hkv: int, sk: int) -> str | None:
    """Why the Hopper form cannot take a bf16 call of this shape, or None."""
    if hd not in HOPPER_HEAD_DIMS:
        return f"head_dim {hd} not in {HOPPER_HEAD_DIMS}"
    if hq // hkv > ROWS:
        return f"group size {hq // hkv} > {ROWS}"
    if sk < 1:
        return "no keys"
    return None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_positions: torch.Tensor, k_positions: torch.Tensor,
                    causal: bool = True, window: int | None = None):
    """Attention masked from the actual positions, on the card.

    q: (B, Sq, Hq, hd); k/v: (B, Sk, Hkv, hd), Hq % Hkv == 0, hd one of
    :data:`HEAD_DIMS`; all contiguous CUDA tensors of one dtype (float32 or
    bfloat16), 16-byte aligned; bfloat16 needs Sk >= 1.  positions:
    (Sq,)/(Sk,) int32.  Returns the output (B, Sq, Hq, hd) in q's dtype and
    the log-sum-exp (B, Hq, Sq) float32."""
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
    if q.dtype not in _build.DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must share one dtype of "
                         f"{list(_build.DTYPE_CODE)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype == torch.bfloat16 and sk < 1:
        raise ValueError("flash_attention: bf16 needs at least one key")
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
    # bf16 takes the Hopper form where it can, else the tensor-core form
    # (an entry of its own); float32 the FMA form (flash_attention_fwd
    # chooses by the dtype code)
    entry = "flash_attention_fwd"
    if q.dtype == torch.bfloat16 and hopper_refusal(hd, hq, hkv, sk):
        entry = "flash_attention_fwd_tc"
    fn = _build.bind("flash_attention", entry, 7, 9)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    q_positions.data_ptr(), k_positions.data_ptr(),
                    out.data_ptr(), lse.data_ptr(), b, sq, sk, hq, hkv, hd,
                    _build.DTYPE_CODE[q.dtype], int(causal), window or 0,
                    _build.stream_of(q)), "flash_attention")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0
