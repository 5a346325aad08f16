"""Mamba2, the State-Space Duality (SSD) mixer [arXiv:2405.21060] (port of
``repro/layers/ssm.py``).

Chunked SSD: the sequence split into chunks; inside each chunk the
quadratic, attention-like products, and across chunks the linear
recurrence on the (H, P, N) states.  The reference runs that recurrence as
``lax.associative_scan``; here it is a loop over the chunks: the same
recurrence, its products and sums in another order.  Decode is the O(1)
recurrent update.  Every op keeps the reference's dtypes (the decays and
the cumulative sums in the compute dtype); it is plain torch, as the
reference's is jnp outside any Pallas kernel.

Over a model group the mixer splits by SSM head (:func:`mamba2_mixer`'s
``group``; the leaves' cut is ``parallel/sharding.SSM_DIM``): each rank
projects, convolves and scans its own heads, so neither the SSD nor the
decode step holds a collective (the reference pins the same inner layout
with its ``mid_spec``); the gated RMSNorm's sum of squares and the
``out_proj`` partial products are summed over the group.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import dcomm
from repro_torch.layers.common import rms_norm


def segsum(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular cumulative sums: out[..., i, j] = sum a[..., j+1..i],
    -inf above the diagonal."""
    l = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((l, l), dtype=torch.bool, device=a.device).tril()
    return d.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, chunk: int,
                init_state: torch.Tensor | None = None):
    """SSD forward.

    x:     (B, S, H, P)   inputs (already conv'd and dt-scaled by the caller)
    a_log: (B, S, H)      per-step log decay (negative)
    b, c:  (B, S, G, N)   input / output projections (G groups over the H)
    Returns (y (B, S, H, P), final_state (B, H, P, N)).  Raises ValueError
    unless ``chunk`` divides S (the reference asserts it)."""
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if s % chunk:
        raise ValueError(f"SSD: sequence {s} does not split into chunks of "
                         f"{chunk}")
    nc = s // chunk
    rep = h // g

    xr = x.reshape(bs, nc, chunk, h, p)
    ar = a_log.reshape(bs, nc, chunk, h)
    brh = b.reshape(bs, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    crh = c.reshape(bs, nc, chunk, g, n).repeat_interleave(rep, dim=3)

    a_cum = torch.cumsum(ar, dim=2)                          # (B,nc,q,H)

    # 1. intra-chunk (diagonal blocks)
    ldec = torch.exp(segsum(ar.movedim(-1, 2)))              # (B,nc,H,q,q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", crh, brh)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp",
                          scores * ldec.to(scores.dtype), xr)

    # 2. per-chunk states: the contribution of each chunk to its final state
    decay_to_end = torch.exp(a_cum[:, :, -1:, :] - a_cum)    # (B,nc,q,H)
    states = torch.einsum("bcqhn,bcqhp->bchpn",
                          brh * decay_to_end.to(x.dtype)[..., None], xr)

    # 3. inter-chunk recurrence: S_c = S_{c-1} * exp(A_c) + states_c
    chunk_decay = torch.exp(a_cum[:, :, -1, :])              # (B,nc,H)
    st = (torch.zeros((bs, h, p, n), dtype=x.dtype, device=x.device)
          if init_state is None else init_state)
    prev = []                               # prev[c]: the state before chunk c
    for i in range(nc):
        prev.append(st)
        st = states[:, i] + st * chunk_decay[:, i, :, None, None].to(st.dtype)
    prev_states = torch.stack(prev, 1)                       # (B,nc,H,P,N)

    # 4. state -> output within each chunk
    in_decay = torch.exp(a_cum)                              # (B,nc,q,H)
    y_off = torch.einsum("bcqhn,bchpn->bcqhp",
                         crh * in_decay.to(x.dtype)[..., None], prev_states)

    y = (y_diag + y_off).reshape(bs, s, h, p)
    return y, st


def ssd_decode_step(state: torch.Tensor, x_t: torch.Tensor,
                    a_log_t: torch.Tensor, b_t: torch.Tensor,
                    c_t: torch.Tensor):
    """One-token recurrence.  state: (B, H, P, N); x_t: (B, H, P);
    a_log_t: (B, H); b_t / c_t: (B, G, N)."""
    rep = x_t.shape[1] // b_t.shape[1]
    bh = b_t.repeat_interleave(rep, dim=1)                   # (B,H,N)
    ch = c_t.repeat_interleave(rep, dim=1)
    decay = torch.exp(a_log_t)[..., None, None].to(state.dtype)
    state = state * decay + torch.einsum("bhp,bhn->bhpn", x_t, bh)
    y = torch.einsum("bhpn,bhn->bhp", state, ch)
    return state, y


# -------------------------------------------------------------- full block --

class SsmState(NamedTuple):
    ssd: torch.Tensor     # (B, H, P, N)
    conv: torch.Tensor    # (B, K-1, conv_dim) last inputs of the causal conv


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  prev: torch.Tensor | None = None):
    """Depthwise causal conv as K shifted multiplies (no (B, S, K, C) window
    materialised), then SiLU.  x: (B, S, C); w: (K, C); ``prev``: the K - 1
    inputs before x (zeros if None).  Returns (y, the last K - 1 inputs)."""
    k, s_len = w.shape[0], x.shape[1]
    if prev is None:
        prev = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([prev, x], dim=1)
    y = sum(xp[:, i:i + s_len] * w[i][None, None, :] for i in range(k))
    return F.silu(y), xp[:, -(k - 1):] if k > 1 else prev


def _own_groups(t: torch.Tensor, lo: int, hl: int, rep: int) -> torch.Tensor:
    """The B or C groups (dim -2 of ``t``, ``rep`` heads a group) that the
    heads [lo, lo + hl) read, as groups of equal size over those heads:
    their whole groups, the one group they share, or else one a head."""
    if hl % rep == 0:                       # lo is a multiple of hl, so of rep
        return t[..., lo // rep:(lo + hl) // rep, :]
    if rep % hl == 0:                       # the heads sit in one group
        return t[..., lo // rep:lo // rep + 1, :]
    idx = torch.arange(lo, lo + hl, device=t.device) // rep
    return t.index_select(-2, idx)


def _group_rms_norm(v: torch.Tensor, scale: torch.Tensor, width: int, group,
                    eps: float = 1e-6) -> torch.Tensor:
    """``rms_norm`` of the (..., width) rows whose columns the ranks of
    ``group`` hold in slices: this rank's slice ``v`` and its ``scale``,
    the mean of the squares taken over the whole row (the f32 sums of
    squares summed over the group, ``dcomm.psum``)."""
    xf = v.float()
    var = dcomm.psum(xf.square().sum(dim=-1, keepdim=True), group) / width
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(v.dtype)


def mamba2_mixer(x: torch.Tensor, params, *, d_inner: int, n_heads: int,
                 head_dim: int, d_state: int, n_groups: int, chunk: int,
                 state: SsmState | None = None, single_step: bool = False,
                 group=None):
    """The Mamba2 mixer: in_proj -> causal conv -> SSD -> gated RMSNorm ->
    out_proj.  x: (B, S, d_model); ``state``: the conv inputs and SSD state
    before x (None: zeros); ``single_step``: S is 1 and the SSD runs its
    recurrent step.  Returns (y (B, S, d_model), the new SsmState).

    ``group``: a model group of m > 1 ranks (m dividing ``n_heads``) over
    which the heads split: rank r runs heads [r H / m, (r + 1) H / m) from
    ``params`` cut so (``parallel/sharding.ssm_cut``: its heads' z and x
    columns and the B and C columns whole, its heads' dt, decay, skip and
    norm entries, its rows of ``out_proj``), and ``state`` holds its
    heads' SSD state and its conv inputs (its x columns, B and C).  ``x``
    is whole on every rank.  The gated RMSNorm spans the whole d_inner:
    its f32 sums of squares are summed over the group before this rank's
    slice is normed, and the ``out_proj`` partial products are summed over
    it in f32 (``dcomm.psum``, whose backward sums the ranks' cotangent
    shares, so each rank's heads get the whole cotangent and their leaves
    the whole gradient; the B and C columns', and x's, are this rank's
    share, summed over the group by the train step)."""
    b, s, _ = x.shape
    m, r = dcomm.group_size(group), dcomm.lane_index(group)
    hl, dl = n_heads // m, d_inner // m              # this rank's heads
    zxbc = x @ params["in_proj_zx"]                  # (B,S, 2 dl + 2 G N)
    dt = x @ params["in_proj_dt"]                    # (B,S,hl)
    z, xbc = zxbc[..., :dl], zxbc[..., dl:]
    dt = F.softplus(dt + params["dt_bias"])

    xbc, new_conv = causal_conv1d(xbc, params["conv_w"],
                                  None if state is None else state.conv)
    gn = n_groups * d_state
    xs, bmat, cmat = xbc[..., :dl], xbc[..., dl:dl + gn], xbc[..., dl + gn:]
    xh = xs.reshape(b, s, hl, head_dim)
    bm = bmat.reshape(b, s, n_groups, d_state)
    cm = cmat.reshape(b, s, n_groups, d_state)
    if m > 1:
        rep = n_heads // n_groups
        bm, cm = (_own_groups(t, r * hl, hl, rep) for t in (bm, cm))
    a = -torch.exp(params["a_log"])                          # (hl,) negative
    a_log = dt * a[None, None, :]                            # (B,S,hl)
    xin = xh * dt[..., None].to(xh.dtype)                    # dt-scaled input

    if single_step:
        if s != 1:
            raise ValueError(f"single_step takes one token, got {s}")
        st0 = (x.new_zeros((b, hl, head_dim, d_state)) if state is None
               else state.ssd)
        new_ssd, yh = ssd_decode_step(st0, xin[:, 0], a_log[:, 0], bm[:, 0],
                                      cm[:, 0])
        y = yh[:, None]
    else:
        y, new_ssd = ssd_chunked(xin, a_log, bm, cm, chunk,
                                 None if state is None else state.ssd)

    y = y + xh * params["d_skip"][None, None, :, None]       # D skip
    y = y.reshape(b, s, dl) * F.silu(z)
    if m == 1:
        y = rms_norm(y, params["norm"])                      # gated RMSNorm
        return y @ params["out_proj"], SsmState(new_ssd, new_conv)
    y = _group_rms_norm(y, params["norm"], d_inner, group)
    # the partial products summed in f32, rounded once as the whole product
    out = dcomm.psum((y @ params["out_proj"]).float(), group).to(y.dtype)
    return out, SsmState(new_ssd, new_conv)
