"""Plain PyTorch versions of the kernels (port of ``repro/kernels/ref.py``,
plus the flash attention forward of ``repro/kernels/flash_attention.py``).

They are what :mod:`repro_torch.kernels.ops` runs for a CPU tensor, what the
CPU tests hold against the JAX package, and what ``chip_smoke.py`` holds each
CUDA kernel against on the card.  Each repeats its kernel's arithmetic: sums
in float32, one cast back to the input dtype at the end.
"""

from __future__ import annotations

import torch


def segment_gather_ref(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = src[idx[i]]; idx == -1 -> zeros.  src: (T, d); idx: (R,)."""
    got = src.index_select(0, idx.long().clamp_min(0))
    return torch.where((idx >= 0)[:, None], got, torch.zeros((), dtype=src.dtype,
                                                             device=src.device))


def segment_scatter_add_ref(src: torch.Tensor, dst: torch.Tensor,
                            gates: torch.Tensor, out_rows: int) -> torch.Tensor:
    """out[dst[i]] += gates[i] * src[i], accumulated in float32 then cast to
    src's dtype; dst == -1 rows are dropped.  src: (R, d); dst/gates: (R,)."""
    w = src.float() * gates.float()[:, None]
    # -1 goes to a dump row past the end (index_add_ would raise on it)
    safe = torch.where(dst < 0, out_rows, dst).long()
    out = torch.zeros((out_rows + 1, src.shape[1]), dtype=torch.float32,
                      device=src.device)
    out.index_add_(0, safe, w)
    return out[:out_rows].to(src.dtype)


def live_rows(counts: torch.Tensor, c: int) -> torch.Tensor:
    """(S, E, C) bool: row c of group (s, e) is live iff c < counts[s, e]."""
    return counts[..., None] > torch.arange(c, device=counts.device)


def fused_swiglu_ref(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                     w2: torch.Tensor,
                     counts: torch.Tensor | None = None) -> torch.Tensor:
    """Grouped SwiGLU: silu(x @ w1) * (x @ w3) @ w2 per (s, e) group.

    x: (S, E, C, d) landed rows; w1/w3: (E, d, f); w2: (E, f, d);
    counts: (S, E) occupancy or None (all rows live).  Rows at positions
    >= counts are zero.  Computed in float32 and cast to x's dtype, as the
    kernel accumulates.
    """
    xf = x.float()
    h = torch.einsum("secd,edf->secf", xf, w1.float())
    u = torch.einsum("secd,edf->secf", xf, w3.float())
    out = torch.einsum("secf,efd->secd", torch.nn.functional.silu(h) * u,
                       w2.float())
    if counts is not None:
        out = torch.where(live_rows(counts, x.shape[2])[..., None], out, 0.0)
    return out.to(x.dtype)


NEG_INF = -1e30


def attention_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                   window: int | None) -> torch.Tensor:
    """(Sq, Sk) bool, True = attend, from the actual positions."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        m &= q_pos[:, None] - k_pos[None, :] < window
    return m


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_positions: torch.Tensor, k_positions: torch.Tensor,
                        causal: bool = True, window: int | None = None,
                        q_block: int = 512):
    """GQA attention masked from the actual positions, one block of queries
    at a time (the function of the position-safe flash forward).

    q: (B, Sq, Hq, hd); k/v: (B, Sk, Hkv, hd), Hq % Hkv == 0; positions
    (Sq,)/(Sk,) int.  Scores, softmax and the product with v in float32.
    Returns the output (B, Sq, Hq, hd) in q's dtype and the log-sum-exp
    (B, Hq, Sq) in float32.  A row that sees no key has no defined output."""
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = hd ** -0.5
    kf = k.float().permute(0, 2, 3, 1)                       # (B, Hkv, hd, Sk)
    vf = v.float().permute(0, 2, 1, 3)                       # (B, Hkv, Sk, hd)
    outs, lses = [], []
    for q0 in range(0, sq, q_block):
        qc = q[:, q0:q0 + q_block]
        n = qc.shape[1]
        qr = qc.reshape(b, n, hkv, g, hd).permute(0, 2, 3, 1, 4).float()
        s = (qr.reshape(b, hkv, g * n, hd) @ kf).reshape(b, hkv, g, n, -1) * scale
        mask = attention_mask(q_positions[q0:q0 + q_block], k_positions,
                              causal, window)
        s = torch.where(mask, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        o = (p.reshape(b, hkv, g * n, -1) @ vf).reshape(b, hkv, g, n, hd) / l
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(b, n, hq, hd))
        lses.append((m + torch.log(l)).reshape(b, hq, n))
    return (torch.cat(outs, dim=1).to(q.dtype),
            torch.cat(lses, dim=2))
