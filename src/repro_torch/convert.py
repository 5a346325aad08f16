"""Parameters of the JAX package -> parameters of the port.

``params_from_jax`` takes the tree that ``repro.models.lm.init_params``
builds (lm.py:210-233) for a ``moe``- or ``moe_tx``-family model (the same
keys; moe_tx has no q/k norms), as numpy arrays (e.g.
``jax.tree.map(np.asarray, params)``), and returns the port's tree: the same
keys and the same layouts, leaf for leaf, as torch tensors on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

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


def params_from_jax(tree: dict, device="cuda") -> dict:
    """Map the reference's moe- or moe_tx-family parameter tree onto the
    port's, on ``device`` (pass ``"cpu"`` for the plain path)."""
    paths = {p for p, _ in _flatten(tree)}
    missing = _MOE_KEYS - paths
    extra = paths - _MOE_KEYS - _OPTIONAL
    if missing or extra:
        raise ValueError(f"not a moe-family parameter tree: missing "
                         f"{sorted(missing)}, unexpected {sorted(extra)}")

    def conv(t):
        return {k: conv(v) if isinstance(v, dict) else _tensor(v, device)
                for k, v in t.items()}

    return conv(tree)
