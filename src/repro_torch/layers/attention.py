"""Attention: GQA with qk-norm, RoPE or M-RoPE, position-masked attention,
the attention sub-block with cross-attention over encoder memory, the
head-parallel island over a model group (:func:`sharded_flash_attention`),
and the decode KV cache (port of ``repro/layers/attention.py``, the parts the
serving of the attention families, lock-step or per-slot, and their
training use; the hybrid family's decode masks its window with
``window_len``).

:func:`attention` stands in for the reference's lax flash attention
(attention.py:35-244), which follows the same position contract as the
Pallas flash kernel: it is ``kernels.ops.flash_attention``, the hand-written
kernel on the card and its plain version on the CPU, causal or not,
differentiable through its blockwise backward.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import dcomm
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.layers.common import apply_mrope, apply_rope, rms_norm


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_positions: torch.Tensor, k_positions: torch.Tensor,
              causal: bool = True, window: int | None = None) -> torch.Tensor:
    """GQA attention masked from the actual positions (causal: key position
    <= query position; ``window``: their distance below it).  q: (B, Sq,
    Hq, hd); k/v: (B, Sk, Hkv, hd); positions (Sq,)/(Sk,).  Returns (B, Sq,
    Hq, hd)."""
    return kops.flash_attention(q, k, v, q_positions, k_positions,
                                causal=causal, window=window)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_positions: torch.Tensor, k_positions: torch.Tensor,
                     window: int | None = None) -> torch.Tensor:
    """:func:`attention` with the causal mask."""
    return attention(q, k, v, q_positions, k_positions, True, window)


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, C, Hkv, hd); C = min(max_len, window)
    v: torch.Tensor
    length: torch.Tensor  # int32 on the cache's device: () tokens seen by
                          # every row (lock-step), or (B,) one count a row
                          # (a continuous-batching slot pool)
    max_len: int


def cache_update(cache: KVCache, k_new: torch.Tensor,
                 v_new: torch.Tensor) -> KVCache:
    """Append one step (B, 1, Hkv, hd): row b at slot length[b] % C (a ring
    buffer when windowed), by one ``index_put_`` over (arange(B), slot),
    so neither form of ``length`` is read to the host.  Writes the cache
    tensors in place, where the reference returns new arrays."""
    b, c = cache.k.shape[0], cache.k.shape[1]
    rows = torch.arange(b, device=cache.k.device)
    slot = (cache.length % c).long().expand(b)
    cache.k.index_put_((rows, slot), k_new[:, 0])
    cache.v.index_put_((rows, slot), v_new[:, 0])
    return KVCache(cache.k, cache.v, cache.length + 1, cache.max_len)


def decode_attention(q: torch.Tensor, cache: KVCache,
                     window_len: int | None = None) -> torch.Tensor:
    """One-token attention against the cache.  q: (B, 1, Hq, hd).  Each row
    holds its last min(length, C) positions in the ring and masks the other
    slots; a row at length 0 (a free slot) sees a uniform softmax over its
    masked scores: finite values, which the serving engine drops.
    ``window_len`` also masks the slots older than it (the hybrid family's
    sliding-window layers, whose cache holds every position for the global
    layers' sake)."""
    b, _, hq, hd = q.shape
    hkv = cache.k.shape[2]
    g = hq // hkv
    c = cache.k.shape[1]
    scale = hd ** -0.5
    qr = q.reshape(b, hkv, g, hd).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qr, cache.k.float()) * scale
    length = cache.length.expand(b)[:, None]
    slot = torch.arange(c, device=q.device)[None, :]
    age = (length % c - 1 - slot) % c                       # (B, C), 0 = newest
    valid = age < length.clamp(max=c)
    if window_len is not None:
        valid &= age < window_len
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
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


def rotate(x: torch.Tensor, positions: torch.Tensor, theta: float,
           mrope_sections=None) -> torch.Tensor:
    """RoPE of (..., S, H, hd) ``x`` at ``positions`` (..., S), or M-RoPE at
    (3, ..., S) positions where ``mrope_sections`` is given."""
    if mrope_sections is not None:
        return apply_mrope(x, positions, mrope_sections, theta)
    return apply_rope(x, positions, theta)


def mask_positions(positions: torch.Tensor, mrope_sections=None):
    """The positions attention masks by: the temporal row ``positions[0]``
    under M-RoPE (the reference's attention.py:431), else ``positions``."""
    return positions[0] if mrope_sections is not None else positions


def sharded_flash_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, q_positions: torch.Tensor,
                            k_positions: torch.Tensor, *, group,
                            causal: bool = True, window: int | None = None,
                            q_norm=None, k_norm=None, rope_theta=None,
                            mrope_sections=None,
                            rope_positions=None) -> torch.Tensor:
    """Head-parallel attention over the model group ``group`` (the
    reference's island, attention.py:247-307): q (B, Sq, Hq, hd) and k/v
    (B, Sk, Hkv, hd) whole on every rank (the replicated layout), the q
    heads zero-padded up to a multiple of the group's size m; rank r takes
    heads [r hl, (r + 1) hl) and the kv head of each,
    ``min(head // g, Hkv - 1)`` (g = Hq / Hkv: a padded head reads the last
    one), so :func:`attention` runs at group size 1.  ``q_norm`` /
    ``k_norm`` (qk-norm) and RoPE at ``rope_positions`` (M-RoPE with
    ``mrope_sections``; none without ``rope_theta``) act on this rank's
    heads only.  The heads' outputs are all-gathered over the group
    (``dcomm.gather_dim``, whose backward sums the ranks' cotangents and
    gives each its heads': each rank differentiates its copy of the loss)
    and the padding dropped.  Returns (B, Sq, Hq, hd) on every rank."""
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    m, r = dcomm.group_size(group), dcomm.lane_index(group)
    hl = -(-hq // m)
    lo, hi = r * hl, (r + 1) * hl
    ql = q[:, :, min(lo, hq):min(hi, hq)]
    if ql.shape[2] < hl:
        ql = torch.cat([ql, ql.new_zeros((b, sq, hl - ql.shape[2], hd))], 2)
    idx = (torch.arange(lo, hi, device=q.device) // (hq // hkv)).clamp(
        max=hkv - 1)
    ks, vs = k.index_select(2, idx), v.index_select(2, idx)
    if q_norm is not None:
        ql, ks = rms_norm(ql, q_norm), rms_norm(ks, k_norm)
    if rope_theta is not None:
        ql = rotate(ql, rope_positions, rope_theta, mrope_sections)
        ks = rotate(ks, rope_positions, rope_theta, mrope_sections)
    out = attention(ql, ks, vs, q_positions, k_positions, causal, window)
    out = dcomm.gather_dim(out, 2, dcomm.process_group(group))
    return out[:, :, :hq]


def attention_block(x, params, *, n_heads, n_kv, head_dim, rope_theta,
                    positions, causal=True, window=None, qk_norm=False,
                    mrope_sections=None, kv_override=None, group=None):
    """The attention sub-block (the reference's attention.py:420-471;
    pre-norm is the caller's): the GQA projection and optional qk-norm,
    RoPE (M-RoPE with ``mrope_sections``, masking by the temporal row) at
    ``positions``, :func:`attention`, then ``wo``.  x: (B, S, d).

    ``kv_override`` = (k, v), (B, Sk, Hkv, hd): cross-attention over encoder
    memory.  Only q is projected (the reference projects k and v too and
    drops them); neither side is rotated, the keys sit at arange(Sk), and
    the block is never causal.

    ``group``: a model group of more than one rank runs the attention as
    the reference's island (:func:`sharded_flash_attention`, the
    reference's ``shard_ctx``): self-attention with its qk-norm and RoPE
    inside, cross-attention as it is (attention.py:432-444, 462-465)."""
    b, s, _ = x.shape
    mask = mask_positions(positions, mrope_sections)
    island = dcomm.group_size(group) > 1
    if kv_override is None and island:
        q, k, v = gqa_project(x, params["wq"], params["wk"], params["wv"],
                              n_heads, n_kv, head_dim)
        out = sharded_flash_attention(
            q, k, v, mask, mask, group=group, causal=causal, window=window,
            q_norm=params.get("q_norm") if qk_norm else None,
            k_norm=params.get("k_norm") if qk_norm else None,
            rope_theta=rope_theta, mrope_sections=mrope_sections,
            rope_positions=positions)
        return out.reshape(b, s, n_heads * head_dim) @ params["wo"]
    if kv_override is None:
        q, k, v = gqa_project(
            x, params["wq"], params["wk"], params["wv"], n_heads, n_kv,
            head_dim, params.get("q_norm") if qk_norm else None,
            params.get("k_norm") if qk_norm else None)
        q = rotate(q, positions, rope_theta, mrope_sections)
        k = rotate(k, positions, rope_theta, mrope_sections)
        k_positions = mask
    else:
        q = (x @ params["wq"]).reshape(b, s, n_heads, head_dim)
        if qk_norm:
            q = rms_norm(q, params["q_norm"])
        k, v = kv_override
        k_positions = torch.arange(k.shape[1], device=x.device)
    if island:
        out = sharded_flash_attention(q, k, v, mask, k_positions, group=group,
                                      causal=False, window=window)
    else:
        out = attention(q, k, v, mask, k_positions,
                        causal and kv_override is None, window)
    return out.reshape(b, s, n_heads * head_dim) @ params["wo"]
