"""Megatron-SP tensor-parallel blocks over the model group (port of
``repro/parallel/tp_blocks.py``).

Between blocks each rank holds its stripe (B, S / m, d) of the sequence; a
block gathers the sequence once, computes this rank's share of the products
and reduce-scatters the partial outputs back to the stripes: per sub-block
exactly one sequence all-gather in and one sequence reduce-scatter out
(``core/dcomm.all_gather_seq`` / ``reduce_scatter_seq``), whose transposes
are each other, so the backward runs the same pair.  The weights are this
rank's TP shards (``parallel/sharding.TP_DIM``): ``wq``, ``w_gate`` and
``w_up`` column-split, ``wo`` and ``w_down`` row-split; ``wk``, ``wv`` and
the qk-norms whole, as the reference's ``in_specs`` read them.

Plain functions on tensors: the reference wraps the same products in
``shard_map``; here the caller's rank is the shard.
"""

from __future__ import annotations

import torch

from repro_torch.core import dcomm
from repro_torch.layers.attention import causal_attention
from repro_torch.layers.common import apply_rope, rms_norm


def kv_heads(n_heads: int, n_kv: int, m: int, r: int) -> tuple[range, list | None]:
    """The kv heads model rank ``r`` of ``m`` reads for its ``n_heads / m``
    query heads, as (the contiguous range of them, None) where its heads
    make whole groups (hl % g == 0: the kernel runs at group size g) or
    share one kv head (g % hl == 0: group size hl); otherwise (the range,
    each local head's index into it): the kv heads repeated one a q head,
    as the reference's ``jnp.take`` pairs them (group size 1).  hl is
    n_heads / m, g is n_heads / n_kv."""
    hl, g = n_heads // m, n_heads // n_kv
    lo, hi = (r * hl) // g, ((r + 1) * hl - 1) // g + 1
    if hl % g == 0 or g % hl == 0:
        return range(lo, hi), None
    return range(lo, hi), [j // g - lo for j in range(r * hl, (r + 1) * hl)]


def megatron_attention(x: torch.Tensor, p, *, group, n_heads: int, n_kv: int,
                       head_dim: int, rope_theta: float,
                       positions: torch.Tensor, window: int | None = None,
                       qk_norm: bool = False) -> torch.Tensor:
    """x: this rank's (B, S / m, d) stripe; ``p`` the layer's attention
    leaves with ``wq`` (d, hl * hd) and ``wo`` (hl * hd, d) this rank's
    shards; ``positions`` (S,) the whole sequence's.  Gathers the sequence,
    projects this rank's hl query heads and the kv heads they read
    (:func:`kv_heads`; only those columns of ``wk`` and ``wv``), runs the
    flash forward (``kernels/ops``: the hand-written kernel on a CUDA
    tensor) and reduce-scatters the output projection back to the stripe.
    Returns (B, S / m, d)."""
    m, r = dcomm.group_size(group), dcomm.lane_index(group)
    if n_heads % m:
        raise ValueError(f"{n_heads} heads do not split over a model group "
                         f"of {m}")
    hl, hd = n_heads // m, head_dim
    xg = dcomm.all_gather_seq(x, group)
    b, s, _ = xg.shape
    kv, idx = kv_heads(n_heads, n_kv, m, r)
    cols = slice(kv.start * hd, kv.stop * hd)
    q = (xg @ p["wq"]).reshape(b, s, hl, hd)
    k = (xg @ p["wk"][:, cols]).reshape(b, s, len(kv), hd)
    v = (xg @ p["wv"][:, cols]).reshape(b, s, len(kv), hd)
    if qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    if idx is not None:
        k, v = k[:, :, idx], v[:, :, idx]
    o = causal_attention(q, k, v, positions, positions, window=window)
    return dcomm.reduce_scatter_seq(o.reshape(b, s, hl * hd) @ p["wo"], group)


def megatron_mlp(x: torch.Tensor, p, *, group) -> torch.Tensor:
    """The SwiGLU MLP over this rank's (B, S / m, d) stripe: the sequence
    gathered, column-parallel ``w_gate`` / ``w_up`` (d, f / m), row-parallel
    ``w_down`` (f / m, d), the partial output reduce-scattered back to the
    stripe."""
    xg = dcomm.all_gather_seq(x, group)
    h = torch.nn.functional.silu(xg @ p["w_gate"]) * (xg @ p["w_up"])
    return dcomm.reduce_scatter_seq(h @ p["w_down"], group)
