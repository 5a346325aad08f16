"""Attention: GQA with qk-norm, RoPE, position-masked causal attention and
the decode KV cache (port of ``repro/layers/attention.py``, the parts the
moe family's lock-step serving uses).

:func:`causal_attention` stands in for the reference's lax flash attention
(attention.py:35-244), which XLA, not Pallas, computes: plain PyTorch,
materialised per block of queries, masked from the actual positions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.layers.common import rms_norm

NEG_INF = -1e30


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
          window: int | None) -> torch.Tensor:
    """(Sq, Sk) bool, True = attend: causal, and within ``window``."""
    m = q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        m &= q_pos[:, None] - k_pos[None, :] < window
    return m


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_positions: torch.Tensor, k_positions: torch.Tensor,
                     window: int | None = None,
                     q_block: int = 512) -> torch.Tensor:
    """Causal GQA attention with position-based masking, one block of queries
    at a time.  q: (B, Sq, Hq, hd); k/v: (B, Sk, Hkv, hd); positions (Sq,)/(Sk,).
    Scores and softmax in float32; like the flash reference, the
    unnormalised probabilities meet v in v's dtype and the row sums divide
    afterwards.  Returns (B, Sq, Hq, hd)."""
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = hd ** -0.5
    kf = k.float().permute(0, 2, 3, 1)                       # (B, Hkv, hd, Sk)
    vv = v.permute(0, 2, 1, 3)                               # (B, Hkv, Sk, hd)
    outs = []
    for q0 in range(0, sq, q_block):
        qc = q[:, q0:q0 + q_block]
        n = qc.shape[1]
        qr = qc.reshape(b, n, hkv, g, hd).permute(0, 2, 3, 1, 4).float()
        s = (qr.reshape(b, hkv, g * n, hd) @ kf).reshape(b, hkv, g, n, -1) * scale
        mask = _mask(q_positions[q0:q0 + q_block], k_positions, window)
        s = torch.where(mask, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        o = (p.to(v.dtype).reshape(b, hkv, g * n, -1) @ vv).reshape(b, hkv, g, n, hd)
        o = o / l.clamp_min(1e-30).to(o.dtype)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(b, n, hq, hd))
    return torch.cat(outs, dim=1)


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, C, Hkv, hd); C = min(max_len, window)
    v: torch.Tensor
    length: int           # tokens seen so far (lock-step: one for all rows)
    max_len: int


def cache_update(cache: KVCache, k_new: torch.Tensor,
                 v_new: torch.Tensor) -> KVCache:
    """Append one step (B, 1, Hkv, hd) at slot length % C (a ring buffer
    when windowed).  Writes the cache tensors in place, where the reference
    returns new arrays."""
    pos = cache.length % cache.k.shape[1]
    cache.k[:, pos] = k_new[:, 0]
    cache.v[:, pos] = v_new[:, 0]
    return KVCache(cache.k, cache.v, cache.length + 1, cache.max_len)


def decode_attention(q: torch.Tensor, cache: KVCache) -> torch.Tensor:
    """One-token attention against the cache.  q: (B, 1, Hq, hd).  The ring
    holds the last min(length, C) positions; older slots are masked."""
    b, _, hq, hd = q.shape
    hkv = cache.k.shape[2]
    g = hq // hkv
    c = cache.k.shape[1]
    scale = hd ** -0.5
    qr = q.reshape(b, hkv, g, hd).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qr, cache.k.float()) * scale
    slot = torch.arange(c, device=q.device)
    age = (cache.length % c - 1 - slot) % c                 # 0 = newest
    valid = age < min(cache.length, c)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(cache.v.dtype), cache.v)
    return out.reshape(b, 1, hq, hd)


def gqa_project(x, wq, wk, wv, n_heads, n_kv, head_dim,
                q_norm_scale=None, k_norm_scale=None):
    """Project + per-head qk-norm (Qwen3).  x: (B, S, d)."""
    b, s, _ = x.shape
    q = (x @ wq).reshape(b, s, n_heads, head_dim)
    k = (x @ wk).reshape(b, s, n_kv, head_dim)
    v = (x @ wv).reshape(b, s, n_kv, head_dim)
    if q_norm_scale is not None:
        q = rms_norm(q, q_norm_scale)
        k = rms_norm(k, k_norm_scale)
    return q, k, v
