"""Parameters of the JAX package -> parameters of the port.

``params_from_jax`` takes the tree that ``repro.models.lm.init_params``
builds (lm.py:210-233) for a ``moe``- or ``moe_tx``-family model (the same
keys; moe_tx has no q/k norms), as numpy arrays (e.g.
``jax.tree.map(np.asarray, params)``), and returns the port's tree: the same
keys and the same layouts, leaf for leaf, as torch tensors on ``device``;
with ``lane``, one rank's shard of it over an EP group (the expert leaves
cut to that lane, ``models/lm.lane_cut``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.lm import lane_cut, lane_sharded

_MOE_KEYS = {
    "embed", "final_norm", "lm_head",
    "layers/ln1", "layers/ln2",
    "layers/attn/wq", "layers/attn/wk", "layers/attn/wv", "layers/attn/wo",
    "layers/moe/router", "layers/moe/w1", "layers/moe/w3", "layers/moe/w2",
}
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


def params_from_jax(tree: dict, device="cuda",
                    lane: int | None = None) -> dict:
    """Map the reference's moe- or moe_tx-family parameter tree onto the
    port's, on ``device`` (pass ``"cpu"`` for the plain path).  With
    ``lane``: the tree rank ``lane`` of an EP group holds, its expert leaves
    (L, EP, E_local, ...) cut to (L, 1, E_local, ...) of that lane."""
    paths = {p for p, _ in _flatten(tree)}
    missing = _MOE_KEYS - paths
    extra = paths - _MOE_KEYS - _OPTIONAL
    if missing or extra:
        raise ValueError(f"not a moe-family parameter tree: missing "
                         f"{sorted(missing)}, unexpected {sorted(extra)}")

    def leaf(path, a):
        if lane is not None and lane_sharded(path):   # (L, EP, E_local, ...)
            a = lane_cut(path, np.asarray(a), np.shape(a)[1],
                         range(lane, lane + 1))
        return _tensor(a, device)

    def conv(t, prefix=""):
        return {k: conv(v, f"{prefix}{k}/") if isinstance(v, dict)
                else leaf(prefix + k, v) for k, v in t.items()}

    return conv(tree)
