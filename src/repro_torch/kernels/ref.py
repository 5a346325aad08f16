"""Plain PyTorch versions of the kernels (port of ``repro/kernels/ref.py``,
plus the flash attention forward of ``repro/kernels/flash_attention.py``),
and the backward formulas of the kernels' VJPs.

The forwards are what :mod:`repro_torch.kernels.ops` runs for a CPU tensor,
what the CPU tests hold against the JAX package, and what ``chip_smoke.py``
holds each CUDA kernel against on the card.  Each repeats its kernel's
arithmetic: sums in float32, one cast back to the input dtype at the end.

The backwards (``*_bwd``) port the reference's custom VJPs
(``repro/kernels/ops.py:62-148``, ``repro/layers/attention.py:171-244``).
``fused_swiglu_bwd`` takes the grouped matmul it calls as an argument:
``ops`` passes its device-dispatching entry (the kernel on the card), the
card's check passes the plain version.  The scatter-add's backward has a
kernel of its own on the card; this one is its CPU path and oracle.
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


def owner_reduce_ref(src: torch.Tensor, gates: torch.Tensor,
                     owners: torch.Tensor, out_rows: int) -> torch.Tensor:
    """The scatter-add read from the output side: out[t] = sum over row t
    of the (out_rows, K) owner table of gates[i] * src[i], entries < 0
    skipped; each product and each partial sum rounded to float32 in the
    row's order, then one cast to src's dtype.  With the lists of ``dst``
    it is :func:`segment_scatter_add_ref` summed in another order."""
    table = owners.long()
    live = (table >= 0)[..., None]
    safe = table.clamp_min(0)
    terms = torch.where(live, src.float()[safe] * gates.float()[safe][..., None],
                        0.0)                                 # (out_rows, K, d)
    out = torch.zeros((out_rows, src.shape[1]), dtype=torch.float32,
                      device=src.device)
    for j in range(table.shape[1]):          # the list's order, as the kernel
        out = out + terms[:, j]
    return out.to(src.dtype)


def owner_table(offsets: torch.Tensor, owners: torch.Tensor) -> torch.Tensor:
    """CSR owner lists as a (out_rows, K) int32 table, K the longest list,
    -1 past each list's end."""
    lengths = (offsets[1:] - offsets[:-1]).long()
    pos = torch.arange(int(lengths.max()) if lengths.numel() else 0,
                       device=offsets.device)
    at = offsets[:-1, None].long() + pos
    live = pos < lengths[:, None]
    got = owners.reshape(-1)[torch.where(live, at, 0)] if owners.numel() else at
    return torch.where(live, got, -1).to(torch.int32)


def build_owners_ref(dst: torch.Tensor, out_rows: int):
    """The owner lists of ``dst`` over [0, out_rows) as CSR: offsets
    (out_rows + 1,) and owners (nnz,) int32, each list ascending (the
    counting build of the kernel)."""
    rows = torch.nonzero((dst >= 0) & (dst < out_rows)).flatten()
    keys = dst[rows].long()
    owners = rows[torch.sort(keys, stable=True).indices].to(torch.int32)
    counts = torch.bincount(keys, minlength=out_rows)
    offsets = torch.zeros(out_rows + 1, dtype=torch.int32, device=dst.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return offsets, owners


def segment_scatter_add_bwd(src: torch.Tensor, dst: torch.Tensor,
                            gates: torch.Tensor, dout: torch.Tensor):
    """VJP of :func:`segment_scatter_add_ref` (reference ops.py:84-98): the
    cotangent gathered back to the rows, times the gates, and per-row
    ``dgates = sum_d back * src`` in float32.  Returns (dsrc, dgates)."""
    back = segment_gather_ref(dout, dst)                     # (R, d)
    dsrc = (back.float() * gates.float()[:, None]).to(src.dtype)
    dgates = (back.float() * src.float()).sum(dim=1).to(gates.dtype)
    return dsrc, dgates


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                       counts: torch.Tensor) -> torch.Tensor:
    """Per-group matmul with row-granular occupancy masking: out[g] =
    x[g] @ w[g % E], rows at positions >= counts[g] zero (the reference's
    ``grouped_matmul_ref``, which has E == G; here the S source lanes of a
    landed (S, E, C, .) buffer may share E weights).  x: (G, C, K); w: (E,
    K, N); counts: (G,).  float32 sums, cast to x's dtype."""
    g, c, k = x.shape
    e, _, n = w.shape
    out = torch.einsum("seck,ekn->secn", x.float().reshape(g // e, e, c, k),
                       w.float()).reshape(g, c, n)
    live = counts.reshape(g, 1) > torch.arange(c, device=x.device)
    return torch.where(live[..., None], out, 0.0).to(x.dtype)


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


def fused_swiglu_bwd(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                     w2: torch.Tensor, counts: torch.Tensor, dy: torch.Tensor,
                     gmm=grouped_matmul_ref):
    """VJP of the grouped SwiGLU: the recompute of the reference's
    ``_fused_swiglu_bwd`` (ops.py:129-148), with its four row-masked product
    families (h = x@w1, u = x@w3, da = dy@w2^T, dx = dh@w1^T + du@w3^T)
    through ``gmm``, the grouped matmul (rows at or past counts come out
    zero, which is the reference's masking of dy to the live rows).  The
    weight gradients contract over the rows and stay plain products.

    ``gmm`` returns x's dtype: in float32 nothing changes against the
    reference; in bf16 h, u and da carry one bf16 rounding each, where the
    reference keeps them in float32.  The elementwise dh/du math is float32.
    Returns (dx, dw1, dw3, dw2)."""
    s, e, c, d = x.shape
    f = w1.shape[-1]
    cnt = counts.reshape(s * e)
    xg = x.reshape(s * e, c, d)
    h = gmm(xg, w1, cnt).float()
    u = gmm(xg, w3, cnt).float()
    da = gmm(dy.to(x.dtype).reshape(s * e, c, d), w2.transpose(1, 2), cnt).float()
    sg = torch.sigmoid(h)
    sh = h * sg                                           # silu(h)
    du = (da * sh).to(x.dtype)
    dh = (da * u * (sg * (1.0 + h * (1.0 - sg)))).to(x.dtype)
    dx = (gmm(dh, w1.transpose(1, 2), cnt).float()
          + gmm(du, w3.transpose(1, 2), cnt).float()).to(x.dtype)
    # rows past counts hold zeros in h, u and da, so they add nothing here
    x4 = x.reshape(s, e, c, d)
    dw1 = torch.einsum("secd,secf->edf", x4, dh.reshape(s, e, c, f))
    dw3 = torch.einsum("secd,secf->edf", x4, du.reshape(s, e, c, f))
    dw2 = torch.einsum("secf,secd->efd", (sh * u).to(x.dtype).reshape(s, e, c, f),
                       dy.to(x.dtype).reshape(s, e, c, d))
    return (dx.reshape(x.shape), dw1.to(w1.dtype), dw3.to(w3.dtype),
            dw2.to(w2.dtype))


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


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_positions: torch.Tensor, k_positions: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, causal: bool = True,
                        window: int | None = None, q_block: int = 512,
                        kv_block: int = 512):
    """Blockwise flash backward (port of the reference's lax ``_flash_bwd``,
    attention.py:171-244, which its Pallas VJP reuses): scores recomputed one
    (query block, key block) pair at a time from the forward's lse (B, Hq,
    Sq) and the same position masks.  Products in the inputs' dtype, as the
    reference's einsums; softmax terms and the dq/dk/dv sums in float32.
    Memory O(S * block).  Returns (dq, dk, dv) in the inputs' dtypes.

    Every block pair is visited (the masks keep a masked pair at zero):
    skipping a pair from its position bounds would need them on the host,
    and the backward would wait on the device for them.  The reference
    skips them (statically when its positions are concrete, by ``lax.cond``
    when traced); at one 512-block per sequence, as trained here, nothing
    is lost."""
    b, sq, hq, hd = q.shape
    _, sk, hkv, _ = k.shape
    g = hq // hkv
    scale = hd ** -0.5
    cd = q.dtype
    # (B, Hkv, S, hd) views of k, v; q/dout per block as (B, Hkv, G * n, hd)
    kh = k.permute(0, 2, 1, 3)
    vh = v.permute(0, 2, 1, 3)
    delta = (dout.float() * out.float()).sum(-1)             # (B, Sq, Hq)
    dq = torch.zeros((b, hkv, g, sq, hd), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, hkv, sk, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)

    def heads(t, q0, n):       # (B, n, Hq, .) -> (B, Hkv, G, n, .)
        return t[:, q0:q0 + n].reshape(b, n, hkv, g, -1).permute(0, 2, 3, 1, 4)

    for q0 in range(0, sq, q_block):
        n = min(q_block, sq - q0)
        qc = heads(q, q0, n).reshape(b, hkv, g * n, hd)
        doc = heads(dout.to(cd), q0, n).reshape(b, hkv, g * n, hd)
        lse_c = lse[:, :, q0:q0 + n].reshape(b, hkv, g, n)
        dlt = heads(delta[..., None], q0, n)[..., 0]         # (B, Hkv, G, n)
        for k0 in range(0, sk, kv_block):
            m = min(kv_block, sk - k0)
            kc, vc = kh[:, :, k0:k0 + m], vh[:, :, k0:k0 + m]
            s = (qc @ kc.transpose(2, 3)).float().reshape(b, hkv, g, n, m) * scale
            mask = attention_mask(q_positions[q0:q0 + n],
                                  k_positions[k0:k0 + m], causal, window)
            s = torch.where(mask, s, NEG_INF)
            p = torch.exp(s - lse_c[..., None])              # (B, Hkv, G, n, m)
            pf = p.reshape(b, hkv, g * n, m)
            dv[:, :, k0:k0 + m] += (pf.to(cd).transpose(2, 3) @ doc).float()
            dp = (doc @ vc.transpose(2, 3)).float().reshape(b, hkv, g, n, m)
            ds = (p * (dp - dlt[..., None]) * scale).reshape(b, hkv, g * n, m).to(cd)
            dq[:, :, :, q0:q0 + n] += (ds @ kc).float().reshape(b, hkv, g, n, hd)
            dk[:, :, k0:k0 + m] += (ds.transpose(2, 3) @ qc).float()
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hd)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))
