"""Plain PyTorch versions of the staging kernels (port of
``repro/kernels/ref.py``).

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
