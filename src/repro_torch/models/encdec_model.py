"""Encoder-decoder backbone, the ``encdec`` family (Seamless-M4T v2's
transformer core; port of ``repro/models/encdec_model.py``).

The audio frontend is a stub: a batch carries precomputed frame embeddings
(B, S_enc, d).  The encoder is a stack of bidirectional self-attention
blocks at positions arange(S_enc); the decoder's blocks are causal
self-attention, cross-attention over the encoder's memory (its keys at
arange(S_enc), neither side rotated) and the SwiGLU MLP.  Every attention
of the encoder and of the teacher-forced decoder is
``layers/attention.attention_block``, so the flash forward
(``kernels.ops.flash_attention``): bidirectional in the encoder, causal in
the decoder's self-attention, non-causal over encoder keys in its
cross-attention.  Decode keeps a self-attention KV cache written in place
and each layer's cross K/V, projected once in :func:`prefill`; its
attention is ``decode_attention`` (plain torch, as the reference's jnp).

The reference scans its layers; here a Python loop walks the stacked
(L, ...) leaves, as ``models/lm`` does, so ``convert.params_from_jax`` maps
the reference's tree leaf for leaf.

Over a model group (``lm.make_context``) every attention of the encoder
and of the teacher-forced decoder, cross-attention too, runs as the
reference's head-parallel island (``lm.island_group``,
``layers/attention.sharded_flash_attention``), the rest of each layer whole
on every rank; a training context holds ``embed`` and ``lm_head`` split
over the group (``lm.vocab_parallel``: the vocab, or d where the group does
not divide it).  Over a data group each rank trains on its rows of the
batch and prefills its rows (``lm.data_rows``); decode stays whole, as the
reference's.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.layers.attention import (KVCache, attention_block,
                                          cache_update, decode_attention,
                                          gqa_project)
from repro_torch.layers.common import (apply_rope, dense_init, embed_init,
                                       rms_norm)
from repro_torch.models import lm
from repro_torch.models.lm import (ModelContext, _length, _mlp,
                                   _traffic_needs_moe, _unstack)

ATTN = ("wq", "wk", "wv", "wo")
MLP = ("w_gate", "w_up", "w_down")


def init_params(cfg: ArchConfig, ctx: ModelContext, gen: torch.Generator,
                dtype=torch.bfloat16) -> dict:
    """Random parameters from ``gen`` in the reference's tree and layouts
    (encdec_model.py:23-52): ``embed``; ``encoder`` (``ln1``, ``attn``,
    ``ln2``, ``mlp``) of ``cfg.encoder_layers``; ``enc_norm``; ``decoder``
    (``ln1``, ``self_attn``, ``ln_x``, ``cross_attn``, ``ln2``, ``mlp``)
    of ``cfg.n_layers``; ``final_norm``; ``lm_head``; layers stacked on a
    leading (L,) axis.  Under ``lm.vocab_parallel`` the vocab pair is drawn
    whole and cut to this model rank's shard, as ``lm.init_params`` cuts
    it."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    init = lambda shape: dense_init(gen, shape, dtype=dtype, device=ctx.device)
    ones = lambda shape: torch.ones(shape, dtype=dtype, device=ctx.device)

    def attn(L):
        return {"wq": init((L, d, cfg.n_heads * hd)),
                "wk": init((L, d, cfg.n_kv_heads * hd)),
                "wv": init((L, d, cfg.n_kv_heads * hd)),
                "wo": init((L, cfg.n_heads * hd, d))}

    def mlp(L):
        return {"w_gate": init((L, d, f)), "w_up": init((L, d, f)),
                "w_down": init((L, f, d))}

    le, ld = cfg.encoder_layers, cfg.n_layers
    return {
        "embed": lm._tp_own("embed", embed_init(gen, cfg.vocab, d, dtype,
                                                ctx.device), ctx),
        "encoder": {"ln1": ones((le, d)), "attn": attn(le),
                    "ln2": ones((le, d)), "mlp": mlp(le)},
        "enc_norm": ones((d,)),
        "decoder": {"ln1": ones((ld, d)), "self_attn": attn(ld),
                    "ln_x": ones((ld, d)), "cross_attn": attn(ld),
                    "ln2": ones((ld, d)), "mlp": mlp(ld)},
        "final_norm": ones((d,)),
        "lm_head": lm._tp_own("lm_head", init((d, cfg.vocab)), ctx),
    }


def param_count(cfg: ArchConfig) -> int:
    """The parameters of :func:`init_params`' tree, reckoned from the
    config."""
    d, hd = cfg.d_model, cfg.hd
    attn = d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    mlp = 3 * d * cfg.d_ff
    enc = cfg.encoder_layers * (2 * d + attn + mlp)
    dec = cfg.n_layers * (3 * d + 2 * attn + mlp)
    return enc + dec + 2 * cfg.vocab * d + 2 * d


def _attn_args(ctx: ModelContext) -> dict:
    cfg = ctx.cfg
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
                rope_theta=cfg.rope_theta, group=lm.island_group(ctx))


def encode(params, frames: torch.Tensor, ctx: ModelContext) -> torch.Tensor:
    """(B, S_enc, d) frame embeddings to the encoder's memory (B, S_enc, d)
    in the compute dtype: bidirectional self-attention at arange(S_enc),
    then the MLP, a layer at a time, then ``enc_norm``."""
    cfg, cd = ctx.cfg, ctx.compute_dtype
    h = frames.to(cd)
    positions = torch.arange(h.shape[1], device=h.device)
    for lp in _unstack(params["encoder"], cd):
        h = h + attention_block(rms_norm(h, lp["ln1"]), lp["attn"],
                                positions=positions, causal=False,
                                **_attn_args(ctx))
        h = h + _mlp(rms_norm(h, lp["ln2"]), lp["mlp"])
    return rms_norm(h, params["enc_norm"].to(cd))


def _cross_kv(memory: torch.Tensor, ap, cfg: ArchConfig):
    """The cross-attention's k and v (B, S_enc, Hkv, hd) of ``memory``
    (only these two: the reference's ``gqa_project`` also computes a q it
    drops)."""
    b, s, _ = memory.shape
    return ((memory @ ap["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.hd),
            (memory @ ap["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.hd))


def decode_train(params, memory: torch.Tensor, tokens: torch.Tensor,
                 ctx: ModelContext) -> torch.Tensor:
    """Teacher-forced decoder forward: (B, S_dec) tokens over ``memory`` to
    the final-normed hidden states (B, S_dec, d): causal self-attention at
    arange(S_dec), cross-attention over the memory, the MLP."""
    cfg, cd = ctx.cfg, ctx.compute_dtype
    h = lm._embed(params["embed"].to(cd), tokens, ctx)
    positions = torch.arange(tokens.shape[1], device=h.device)
    for lp in _unstack(params["decoder"], cd):
        h = h + attention_block(rms_norm(h, lp["ln1"]), lp["self_attn"],
                                positions=positions, causal=True,
                                **_attn_args(ctx))
        h = h + attention_block(
            rms_norm(h, lp["ln_x"]), lp["cross_attn"], positions=positions,
            kv_override=_cross_kv(memory, lp["cross_attn"], cfg),
            **_attn_args(ctx))
        h = h + _mlp(rms_norm(h, lp["ln2"]), lp["mlp"])
    return rms_norm(h, params["final_norm"].to(cd))


def encdec_loss(params, batch, ctx: ModelContext, traffic=None):
    """Next-token CE of ``batch`` {"frames" (B, S_enc, d), "tokens",
    "labels" (B, S_dec)}, labels already shifted, -1 for none (the
    reference's ``encdec_loss``, encdec_model.py:117-139), chunked and
    checkpointed as ``lm.lm_loss`` (``lm.head_loss``: through this rank's
    shard of ``lm_head`` under the vocab split).  Returns (loss, metrics).
    ``traffic`` must be None: the family has no MoE layer."""
    _traffic_needs_moe(ctx.cfg, traffic)
    memory = encode(params, batch["frames"], ctx)
    h = decode_train(params, memory, batch["tokens"], ctx)
    return lm.head_loss(h, params["lm_head"], batch["labels"], ctx)


class EncDecState(NamedTuple):
    self_kv: Any             # {"k", "v"}: (L, B, max_len, Hkv, hd) caches
    cross_k: torch.Tensor    # (L, B, S_enc, Hkv, hd), fixed per request
    cross_v: torch.Tensor
    length: torch.Tensor     # () int32 on the device: tokens decoded


def prefill(params, frames: torch.Tensor, bos_tokens: torch.Tensor,
            ctx: ModelContext, max_len: int):
    """Encode the frames, project each decoder layer's cross K/V of the
    memory once, then decode the (B,) ``bos_tokens`` as the first step.
    On a grid ``frames`` and ``bos_tokens`` are the global batch's, and
    each rank runs and returns its rows (``lm.data_rows``; the data ranks
    must divide B, else ValueError).  Returns (logits (B, V) float32,
    :class:`EncDecState`)."""
    cfg, cd = ctx.cfg, ctx.compute_dtype
    lm._serves_whole(ctx)
    b, n = frames.shape[0], lm.data_size(ctx)
    if b % n:
        raise ValueError(f"a prefill batch of {b} rows does not split over "
                         f"{n} data ranks")
    rows = lm.data_rows(ctx, b)
    frames, bos_tokens = frames[rows], bos_tokens[rows]
    memory = encode(params, frames, ctx)
    cross = [_cross_kv(memory, lp["cross_attn"], cfg)
             for lp in _unstack(params["decoder"], cd)]
    b = frames.shape[0]
    shape = (cfg.n_layers, b, max_len, cfg.n_kv_heads, cfg.hd)
    kv = {n: torch.zeros(shape, dtype=cd, device=memory.device)
          for n in ("k", "v")}
    state = EncDecState(kv, torch.stack([k for k, _ in cross]),
                        torch.stack([v for _, v in cross]),
                        _length(0, memory.device))
    return decode_step(params, state, bos_tokens, ctx, max_len)


def decode_step(params, state: EncDecState, tokens: torch.Tensor,
                ctx: ModelContext, max_len: int):
    """One decoder token for every row at ``state.length``: self-attention
    through the cache (written in place, as ``lm.decode_step`` writes its
    own), cross-attention by ``decode_attention`` over the full cache of
    S_enc slots, the MLP.  tokens: (B,), the rows of ``state`` (this
    rank's on a grid).  Returns (logits (B, V) float32,
    the state, holding the same tensors)."""
    cfg, cd = ctx.cfg, ctx.compute_dtype
    lm._serves_whole(ctx)
    h = params["embed"].to(cd)[tokens][:, None, :]
    b = h.shape[0]
    pos = state.length
    positions = pos[None]
    s_enc = state.cross_k.shape[2]
    full = _length(s_enc, h.device)
    out = lambda a, ap: a.reshape(b, 1, cfg.n_heads * cfg.hd) @ ap["wo"]
    for i, lp in enumerate(_unstack(params["decoder"], cd)):
        ap = lp["self_attn"]
        q, k, v = gqa_project(rms_norm(h, lp["ln1"]), ap["wq"], ap["wk"],
                              ap["wv"], cfg.n_heads, cfg.n_kv_heads, cfg.hd)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        cache = cache_update(KVCache(state.self_kv["k"][i],
                                     state.self_kv["v"][i], pos, max_len),
                             k, v)
        h = h + out(decode_attention(q, cache), ap)
        ap = lp["cross_attn"]
        q = (rms_norm(h, lp["ln_x"]) @ ap["wq"]).reshape(b, 1, cfg.n_heads,
                                                         cfg.hd)
        cross = KVCache(state.cross_k[i], state.cross_v[i], full, s_enc)
        h = h + out(decode_attention(q, cross), ap)
        h = h + _mlp(rms_norm(h, lp["ln2"]), lp["mlp"])
    h = rms_norm(h, params["final_norm"].to(cd))
    logits = (h[:, 0] @ params["lm_head"].to(cd)).float()
    pos += 1
    return logits, state
