"""Gradient compression with error feedback (port of
``repro/parallel/compress.py``).

Int8 per-block uniform quantisation for a gradient reduction over a slow
link: each leaf is quantised in blocks of ``block`` elements to int8 with
one f32 scale a block, and the quantisation error is fed back into the next
step's gradient (EF-SGD), which keeps the accumulated signal unbiased.

Trees are the port's nested dictionaries: leaves are taken in
``optim/adamw.leaves``' order (insertion order, where the reference's
``tree_flatten`` sorts dict keys), and the "treedef" is the tree with
``None`` at every leaf, which ``adamw.unflatten`` and ``adamw.paths`` read.
Plain torch on whatever device the tensors are on: the reference's are jnp,
not a kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.optim import adamw

F32 = torch.float32


class EFState(NamedTuple):
    error: dict         # a tree like the gradients', f32


def init_error(grads) -> EFState:
    return EFState(adamw.tree_map(
        lambda g: torch.zeros(g.shape, dtype=F32, device=g.device), grads))


def quantize(x: torch.Tensor, block: int = 256):
    """Per-block symmetric int8: ``x`` in f32, flattened and padded with
    zeros to a multiple of ``block``, each block scaled by its max |x| / 127
    and rounded half to even.  Returns (q (n_blocks, block) int8, scales
    (n_blocks, 1) f32)."""
    flat = x.to(F32).reshape(-1)
    blocks = torch.nn.functional.pad(
        flat, (0, (-flat.numel()) % block)).reshape(-1, block)
    # the divisor a tensor on the blocks' device (filled there, no copy from
    # the host): CUDA turns a division by a host scalar into a product by
    # its reciprocal, which can land a unit in the last place off the
    # quotient the reference rounds
    scale = blocks.abs().amax(dim=1, keepdim=True) / torch.full(
        (), 127.0, dtype=F32, device=blocks.device)
    q = torch.clamp(torch.round(blocks / torch.clamp_min(scale, 1e-12)),
                    -127, 127)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape,
               block: int = 256) -> torch.Tensor:
    flat = (q.to(F32) * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def compress_grads(grads, ef: EFState, block: int = 256):
    """grads + error feedback -> ([(q, scale)] in leaf order, the treedef,
    the new EFState): each leaf's ``g + e`` in f32 quantised, its new error
    ``g + e - dequantize(q)``."""
    qs, new_err = [], []
    for g, e in zip(adamw.leaves(grads), adamw.leaves(ef.error), strict=True):
        val = g.to(F32) + e
        q, s = quantize(val, block)
        qs.append((q, s))
        new_err.append(val - dequantize(q, s, g.shape, block))
    treedef = adamw.tree_map(lambda _: None, grads)
    return qs, treedef, EFState(adamw.unflatten(treedef, new_err))


def decompress_grads(qs, treedef, like_leaves, block: int = 256):
    """The tree of ``treedef`` holding each ``(q, scale)`` dequantised to
    its like-leaf's shape and dtype."""
    return adamw.unflatten(treedef, [
        dequantize(q, s, ref.shape, block).to(ref.dtype)
        for (q, s), ref in zip(qs, like_leaves, strict=True)])
