"""Hymba's hybrid-head mixer: attention and SSM heads in parallel
[arXiv:2411.13676] (port of ``repro/layers/hybrid.py``).

Both branches read the same normed input; each branch's output is
RMS-normed and the two are averaged.  Most layers attend over a sliding
window, a few globally: the caller passes each layer's window (None on a
global layer).  Hymba's learnable meta tokens are omitted, as in the
reference.  The attention branch projects q, k and v once a layer; the
reference projects k and v a second time for the prefill's cache, which
gives the same values.

Over a model group (``group``) the attention of a prefill or a training
step runs as the reference's head-parallel island
(``layers/attention.sharded_flash_attention``, its ``shard_ctx``) and
the cache's k and v are projected again outside it, as the reference's
prefill does (lm.py:856-868); a decode step's attention runs whole on every
rank.  The SSM branch splits by head where ``ssm_args`` carries its group
(``layers/ssm.mamba2_mixer``).
"""

from __future__ import annotations

import torch

from repro_torch.core import dcomm
from repro_torch.layers.attention import (KVCache, attention_block,
                                          cache_update, causal_attention,
                                          decode_attention, gqa_project)
from repro_torch.layers.common import apply_rope, rms_norm
from repro_torch.layers.ssm import SsmState, mamba2_mixer


def hymba_mixer(x: torch.Tensor, params, *, n_heads: int, n_kv: int,
                head_dim: int, rope_theta: float, positions: torch.Tensor,
                window: int | None, ssm_args: dict,
                attn_cache: KVCache | None = None,
                ssm_state: SsmState | None = None, single_step: bool = False,
                group=None, return_kv: bool = True):
    """x: (B, S, d), ``params`` one layer's (``attn``, ``ssm``,
    ``attn_out_norm``, ``ssm_out_norm``), ``window`` this layer's (None:
    global attention).  Prefill or training: the attention branch through
    the flash forward (``causal_attention``), returning its RoPE'd k and v
    (B, S, Hkv, hd) for the cache.  ``single_step`` (decode): one token
    written into ``attn_cache`` at each row's position and attended with
    the slots older than ``window`` masked, returning the cache.  The SSM
    branch is ``mamba2_mixer`` from ``ssm_state`` (``ssm_args`` its dims
    and its ``group``).  ``group``: the model group the attention of a
    prefill or a training step runs head-parallel over (None or one rank:
    whole); there the k and v come from a second projection, made only
    with ``return_kv`` (None without).  Returns (y, the k and v or the
    cache, the new SsmState)."""
    b, s, _ = x.shape
    ap = params["attn"]
    if not single_step and dcomm.group_size(group) > 1:
        attn_out = attention_block(
            x, ap, n_heads=n_heads, n_kv=n_kv, head_dim=head_dim,
            rope_theta=rope_theta, positions=positions, causal=True,
            window=window, group=group)
        kv = None
        if return_kv:
            k = (x @ ap["wk"]).reshape(b, s, n_kv, head_dim)
            kv = (apply_rope(k, positions, rope_theta),
                  (x @ ap["wv"]).reshape(b, s, n_kv, head_dim))
    else:
        q, k, v = gqa_project(x, ap["wq"], ap["wk"], ap["wv"], n_heads, n_kv,
                              head_dim)
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
        if single_step:
            kv = cache_update(attn_cache, k, v)
            a = decode_attention(q, kv, window_len=window)
        else:
            kv = (k, v)
            a = causal_attention(q, k, v, positions, positions, window=window)
        attn_out = a.reshape(b, s, n_heads * head_dim) @ ap["wo"]

    ssm_out, new_ssm = mamba2_mixer(x, params["ssm"], state=ssm_state,
                                    single_step=single_step, **ssm_args)
    y = 0.5 * (rms_norm(attn_out, params["attn_out_norm"])
               + rms_norm(ssm_out, params["ssm_out_norm"]))
    return y, kv, new_ssm
