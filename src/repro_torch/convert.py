"""Parameters of the JAX package -> parameters of the port.

``params_from_jax`` takes the tree that ``repro.models.lm.init_params``
builds (lm.py:210-233) for a ``dense``-, ``moe``-, ``moe_tx``-,
``moe_ffn``-, ``ssm``-, ``hybrid``- or ``vlm``-family model, or that of
``repro.models.encdec_model.init_params`` (encdec) (its keys by family,
:data:`KEYS`; the q/k norms
where the config has them), as numpy arrays (e.g.
``jax.tree.map(np.asarray, params)``), and returns the port's tree: the same
keys and the same layouts, leaf for leaf, as torch tensors on ``device``;
with ``lane``, one rank's shard of it over an EP group (the expert leaves
cut to that lane, ``models/lm.lane_cut``), with ``data`` = (DP, d) the
f-slice data rank d of DP holds under FSDP of the experts
(``parallel/sharding``), and with ``model`` = (m, r) the shards model rank
r of m holds in training (``models/lm.tp_cut``): the vocab pair's (on the
dim ``sharding.vocab_dim`` gives its shape), the Mamba2 leaves' cut by SSM
head where m divides the heads (``sharding.ssm_cut``; their sizes read
from the tree itself) and, with ``tp``, the TP leaves' under Megatron TP.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.encdec_model import ATTN, MLP
from repro_torch.models.lm import (FAMILY_PARTS, HYBRID_NORMS, lane_cut,
                                   lane_sharded, tp_cut)
from repro_torch.parallel import sharding

_COMMON = {"embed", "final_norm", "lm_head", "layers/ln1"}
_PART_KEYS = {
    "attn": {"layers/ln2", "layers/attn/wq", "layers/attn/wk",
             "layers/attn/wv", "layers/attn/wo"},
    "mlp": {"layers/mlp/w_gate", "layers/mlp/w_up", "layers/mlp/w_down"},
    "moe": {"layers/moe/router", "layers/moe/w1", "layers/moe/w3",
            "layers/moe/w2"},
    "ssm": {f"layers/ssm/{k}" for k in (
        "in_proj_zx", "in_proj_dt", "conv_w", "dt_bias", "a_log", "d_skip",
        "norm", "out_proj")}}
# the leaves of each family's tree, from its sub-layers (lm.FAMILY_PARTS),
# and the hybrid family's two branch norms
KEYS = {f: _COMMON.union(*(_PART_KEYS[p] for p in parts))
        for f, parts in FAMILY_PARTS.items()}
KEYS["hybrid"] = KEYS["hybrid"] | {f"layers/{n}" for n in HYBRID_NORMS}
# the encoder-decoder's (models/encdec_model.init_params)
KEYS["encdec"] = {"embed", "enc_norm", "final_norm", "lm_head"}.union(
    {f"encoder/{n}" for n in ("ln1", "ln2")},
    {f"encoder/attn/{w}" for w in ATTN}, {f"encoder/mlp/{w}" for w in MLP},
    {f"decoder/{n}" for n in ("ln1", "ln_x", "ln2")},
    {f"decoder/{a}/{w}" for a in ("self_attn", "cross_attn") for w in ATTN},
    {f"decoder/mlp/{w}" for w in MLP})
_OPTIONAL = {"layers/attn/q_norm", "layers/attn/k_norm"}


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()
                                ).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flatten(v, path + "/")
        else:
            yield path, v


def params_from_jax(tree: dict, device="cuda", lane: int | None = None,
                    data: tuple[int, int] | None = None,
                    model: tuple[int, int] | None = None,
                    tp: bool = True) -> dict:
    """Map the reference's parameter tree of a family of :data:`KEYS` onto
    the port's, on ``device`` (pass ``"cpu"`` for the plain path); the
    family is the one whose keys the tree holds (ValueError if none).  With
    ``lane``: the tree rank ``lane`` of an EP group holds, its expert leaves
    (L, EP, E_local, ...) cut to (L, 1, E_local, ...) of that lane.  With
    ``data`` = (DP, d): their f dim cut to data rank d's slice of DP (FSDP,
    ``sharding.data_cut``).  With ``model`` = (m, r): the vocab pair
    (``sharding.vocab_dim``: the vocab where m divides it, else d) and,
    with ``tp``, the TP leaves (``sharding.TP_DIM``) cut to model rank r's
    shard of m, the reference's shard r of its ``model`` axis, and the
    Mamba2 leaves cut by SSM head (``sharding.ssm_cut``, not the reference's
    contiguous cut of ``in_proj_zx`` and ``conv_w``): the tree a training
    context over a model group of m holds (``models/lm.model_dim``;
    ``tp``: ``lm.tensor_parallel``, never on for the vlm, encdec, ssm and
    hybrid trees, whose model rank holds the vocab pair's shard and its
    SSM heads' alone)."""
    paths = {p for p, _ in _flatten(tree)} - _OPTIONAL
    if paths not in KEYS.values():
        near = min(KEYS, key=lambda f: len(KEYS[f] ^ paths))
        raise ValueError(
            f"not the parameter tree of a ported family ({sorted(KEYS)}): "
            f"against {near!r} missing {sorted(KEYS[near] - paths)}, "
            f"unexpected {sorted(paths - KEYS[near])}")

    flat = dict(_flatten(tree))
    ssm = None
    if "layers/ssm/a_log" in flat:        # the Mamba2 leaves' sizes
        din = np.shape(flat["layers/ssm/norm"])[-1]
        ssm = sharding.SsmDims(din, np.shape(flat["layers/ssm/a_log"])[-1],
                               np.shape(flat["layers/ssm/conv_w"])[-1] - din)

    def leaf(path, a):
        if lane is not None and lane_sharded(path):   # (L, EP, E_local, ...)
            a = lane_cut(path, np.asarray(a), np.shape(a)[1],
                         range(lane, lane + 1))
        if data is not None and sharding.fsdp_sharded(path):
            a = sharding.data_cut(np.asarray(a), sharding.fsdp_dim(path),
                                  *data)
        if model is not None:
            a = tp_cut(path, np.asarray(a), *model, tp=tp, ssm=ssm)
        return _tensor(a, device)

    def conv(t, prefix=""):
        return {k: conv(v, f"{prefix}{k}/") if isinstance(v, dict)
                else leaf(prefix + k, v) for k, v in t.items()}

    return conv(tree)
