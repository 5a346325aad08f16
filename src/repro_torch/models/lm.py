"""Decoder-only LM, ``moe`` family: parameters, prefill and single-token
decode (port of ``repro/models/lm.py``, the lock-step serving path).

Prefill runs every MoE layer through the FUSCO shuffle (``layers/moe.moe_block``);
decode uses the replicated-token MoE (``layers/moe.moe_decode_block``).  The
reference scans one compiled layer body; here a Python loop walks the layers
of the stacked (L, ...) parameter tree, which keeps the reference's layout so
``convert.params_from_jax`` maps one onto the other leaf by leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.core.dcomm import DcommConfig, group_size
from repro_torch.core.routing import ExpertPlacement
from repro_torch.layers.attention import (KVCache, cache_update,
                                          causal_attention, decode_attention,
                                          gqa_project)
from repro_torch.layers.common import apply_rope, dense_init, embed_init, rms_norm
from repro_torch.layers.moe import moe_block, moe_decode_block


@dataclasses.dataclass(frozen=True)
class ModelContext:
    cfg: ArchConfig
    device: torch.device
    ep_group: dist.ProcessGroup | None
    placement: ExpertPlacement
    dcfg: DcommConfig
    compute_dtype: torch.dtype = torch.bfloat16


def make_context(cfg: ArchConfig, device="cuda", *,
                 ep_group: dist.ProcessGroup | None = None,
                 engine: str = "fused_flat", capacity_factor: float = 2.0,
                 compute_dtype: torch.dtype = torch.bfloat16) -> ModelContext:
    """Context of a ``moe``-family model whose EP domain is ``ep_group``
    (None: one lane).  Raises if ``device`` is CUDA and no card is there."""
    if cfg.family != "moe":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (moe only): ROADMAP "
            "queue 1 items 3 and 8")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for, but torch sees no CUDA "
                           "device (pass device='cpu' to run the plain path)")
    ep = group_size(ep_group)
    ns = max(1, ep // 2)      # as the reference's serve driver picks it
    placement = ExpertPlacement(n_experts=cfg.moe.n_experts, ep=ep, node_size=ns)
    dcfg = DcommConfig(engine=engine, capacity_factor=capacity_factor)
    return ModelContext(cfg, device, ep_group, placement, dcfg, compute_dtype)


def init_params(cfg: ArchConfig, ctx: ModelContext, gen: torch.Generator,
                dtype=torch.bfloat16) -> dict:
    """Random parameters from ``gen`` in the reference's tree and layouts
    (lm.py:210-233): layers stacked on a leading (L,) axis, expert weights
    lane-major (L, EP, E_local, d, f)."""
    L, d, hd = cfg.n_layers, cfg.d_model, cfg.hd
    fe, el = cfg.moe.d_ff_expert, ctx.placement.experts_per_lane
    ep = ctx.placement.ep
    init = lambda shape: dense_init(gen, shape, dtype=dtype, device=ctx.device)
    ones = lambda shape: torch.ones(shape, dtype=dtype, device=ctx.device)
    attn = {"wq": init((L, d, cfg.n_heads * hd)),
            "wk": init((L, d, cfg.n_kv_heads * hd)),
            "wv": init((L, d, cfg.n_kv_heads * hd)),
            "wo": init((L, cfg.n_heads * hd, d))}
    if cfg.qk_norm:
        attn["q_norm"] = ones((L, hd))
        attn["k_norm"] = ones((L, hd))
    moe = {"router": init((L, d, cfg.moe.n_experts)),
           "w1": init((L, ep, el, d, fe)),
           "w3": init((L, ep, el, d, fe)),
           "w2": init((L, ep, el, fe, d))}
    return {
        "embed": embed_init(gen, cfg.vocab, d, dtype, ctx.device),
        "layers": {"ln1": ones((L, d)), "attn": attn, "ln2": ones((L, d)),
                   "moe": moe},
        "final_norm": ones((d,)),
        "lm_head": init((d, cfg.vocab)),
    }


def _layer(tree, i: int, cd: torch.dtype):
    """Layer ``i`` of a stacked parameter tree, float leaves in ``cd``."""
    if isinstance(tree, dict):
        return {k: _layer(v, i, cd) for k, v in tree.items()}
    leaf = tree[i]
    return leaf.to(cd) if leaf.is_floating_point() else leaf


def _attn_qkv(x, ap, cfg: ArchConfig, positions):
    q, k, v = gqa_project(x, ap["wq"], ap["wk"], ap["wv"], cfg.n_heads,
                          cfg.n_kv_heads, cfg.hd,
                          ap.get("q_norm") if cfg.qk_norm else None,
                          ap.get("k_norm") if cfg.qk_norm else None)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


class DecodeState(NamedTuple):
    kv: Any          # {"k", "v"}: (L, B, C, Hkv, hd)
    length: int      # positions seen so far, one for every row (lock-step)


def _kv_capacity(cfg: ArchConfig, max_len: int) -> int:
    return min(max_len, cfg.window) if cfg.window else max_len


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int, dtype,
                      ctx: ModelContext) -> DecodeState:
    c = _kv_capacity(cfg, max_len)
    shape = (cfg.n_layers, batch, c, cfg.n_kv_heads, cfg.hd)
    return DecodeState({"k": torch.zeros(shape, dtype=dtype, device=ctx.device),
                        "v": torch.zeros(shape, dtype=dtype, device=ctx.device)},
                       0)


def prefill(params, inputs: torch.Tensor, positions: torch.Tensor,
            ctx: ModelContext, max_len: int):
    """Full-sequence forward over (B, S) tokens; returns the last position's
    logits (B, V) in float32 and the decode state with every layer's RoPE'd
    k and v in its cache (the last ``cap`` positions, at slot p % cap)."""
    cfg, cd = ctx.cfg, ctx.compute_dtype
    h = params["embed"].to(cd)[inputs]
    b, s, _ = h.shape
    cap = _kv_capacity(cfg, max_len)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i, cd)
        x = rms_norm(h, lp["ln1"])
        q, k, v = _attn_qkv(x, lp["attn"], cfg, positions)
        o = causal_attention(q, k, v, positions, positions, window=cfg.window)
        h = h + o.reshape(b, s, cfg.n_heads * cfg.hd) @ lp["attn"]["wo"]
        if s >= cap:
            k = torch.roll(k[:, -cap:], s % cap, dims=1)
            v = torch.roll(v[:, -cap:], s % cap, dims=1)
        else:
            pad = (0, 0, 0, 0, 0, cap - s)
            k = torch.nn.functional.pad(k, pad)
            v = torch.nn.functional.pad(v, pad)
        ks.append(k)
        vs.append(v)
        x = rms_norm(h, lp["ln2"])
        h = h + moe_block(x, lp["moe"], placement=ctx.placement, dcfg=ctx.dcfg,
                          top_k=cfg.moe.top_k, norm_topk=cfg.moe.norm_topk,
                          group=ctx.ep_group)
    h = rms_norm(h, params["final_norm"].to(cd))
    logits = (h[:, -1] @ params["lm_head"].to(cd)).float()
    return logits, DecodeState({"k": torch.stack(ks), "v": torch.stack(vs)}, s)


def decode_step(params, state: DecodeState, inputs: torch.Tensor,
                ctx: ModelContext, max_len: int):
    """One-token decode for the whole batch.  inputs: (B,) int tokens.
    Returns (logits (B, V) float32, new DecodeState).  The caches in
    ``state.kv`` are written in place."""
    cfg, cd = ctx.cfg, ctx.compute_dtype
    h = params["embed"].to(cd)[inputs][:, None, :]
    b = h.shape[0]
    pos = state.length
    positions = torch.tensor([pos], dtype=torch.int32, device=h.device)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i, cd)
        x = rms_norm(h, lp["ln1"])
        q, k, v = _attn_qkv(x, lp["attn"], cfg, positions)
        cache = cache_update(KVCache(state.kv["k"][i], state.kv["v"][i], pos,
                                     max_len), k, v)
        a = decode_attention(q, cache)
        h = h + a.reshape(b, 1, cfg.n_heads * cfg.hd) @ lp["attn"]["wo"]
        x = rms_norm(h, lp["ln2"])
        h = h + moe_decode_block(x, lp["moe"], placement=ctx.placement,
                                 dcfg=ctx.dcfg, top_k=cfg.moe.top_k,
                                 norm_topk=cfg.moe.norm_topk,
                                 group=ctx.ep_group)
    h = rms_norm(h, params["final_norm"].to(cd))
    logits = (h[:, 0] @ params["lm_head"].to(cd)).float()
    return logits, DecodeState(state.kv, pos + 1)
