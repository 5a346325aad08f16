"""Which group holds which dim of each parameter (port of ``param_specs``
in ``repro/parallel/sharding.py``, for what the port shards).

The reference gives every leaf a ``PartitionSpec`` over its (data, model)
mesh.  The port's ranks hold their parts as plain tensors, so the rule here
names, by leaf path, the dim split over the EP group (one lane a rank) and
the dim split over the data group (``fsdp_experts``: ZeRO-3 of the expert
weights, the reference's ``lay(ep, None, None, "data")`` and ``lay(ep, None,
"data", None)``):

- ``layers/moe/w1``, ``w3``: (L, lanes, E_local, d, f), lanes over EP, f
  (dim -1) over the data group under FSDP;
- ``layers/moe/w2``: (L, lanes, E_local, f, d), lanes over EP, f (dim -2)
  over the data group under FSDP;
- every other leaf replicated.

The reference's Megatron TP entries (attention heads, the dense MLP's
columns) and its vocab-sharded embedding and head over the model axis are
not ported: asking for them (``tensor_parallel``) raises.
"""

from __future__ import annotations

from typing import NamedTuple

EXPERT_LEAVES = ("layers/moe/w1", "layers/moe/w3", "layers/moe/w2")
LANE_DIM = 1                 # the lane axis of the (L, lanes, ...) experts
# the f dim of each expert leaf, the one FSDP splits over the data group,
# counted from the end: the same dim of the stacked (L, lanes, E_local, ...)
# leaf, of one layer's and of one lane's
FSDP_DIM = {"layers/moe/w1": -1, "layers/moe/w3": -1, "layers/moe/w2": -2}
# the leaves the reference shards over its model axis by TP or by vocab
_TP_SUFFIXES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_VOCAB = ("embed", "lm_head")


class Spec(NamedTuple):
    """The dim of a leaf split over the EP group and over the data group
    (None: not split over it)."""
    ep: int | None = None
    data: int | None = None


REPLICATED = Spec()


def param_spec(path: str, *, fsdp_experts: bool = False,
               tensor_parallel: bool = False) -> Spec:
    """The :class:`Spec` of the leaf at ``path`` ("a/b/c", as
    ``optim/adamw.paths`` names it)."""
    if path in EXPERT_LEAVES:
        return Spec(LANE_DIM, FSDP_DIM[path] if fsdp_experts else None)
    if tensor_parallel and (path.endswith(_TP_SUFFIXES)
                            or path.split("/")[0] in _VOCAB):
        raise NotImplementedError(
            f"{path}: tensor parallelism over the model axis and the "
            "vocab-sharded embedding and head are not ported (ROADMAP queue "
            "1 item 8)")
    return REPLICATED


def param_specs(tree, *, fsdp_experts: bool = False,
                tensor_parallel: bool = False, prefix: str = "") -> dict:
    """A tree shaped like ``tree`` (nested dicts of tensors) of each leaf's
    :func:`param_spec`."""
    return {k: param_specs(v, fsdp_experts=fsdp_experts,
                           tensor_parallel=tensor_parallel,
                           prefix=f"{prefix}{k}/")
            if isinstance(v, dict) else
            param_spec(prefix + k, fsdp_experts=fsdp_experts,
                       tensor_parallel=tensor_parallel)
            for k, v in tree.items()}


def lane_sharded(path: str) -> bool:
    """Whether the leaf at ``path`` is split over the EP group."""
    return param_spec(path).ep is not None


def fsdp_sharded(path: str) -> bool:
    """Whether the leaf at ``path`` is split over the data group when
    ``fsdp_experts`` is on."""
    return param_spec(path, fsdp_experts=True).data is not None


def fsdp_dim(path: str) -> int:
    """The dim of an FSDP leaf (:func:`fsdp_sharded`) split over the data
    group, from the end."""
    return param_spec(path, fsdp_experts=True).data


def data_cut(t, dim: int, dp: int, d: int):
    """Data rank ``d``'s slice of ``t`` (a tensor or an array) on ``dim``
    (negative: from the end), of ``dp`` equal slices (a view)."""
    dim %= t.ndim
    n = t.shape[dim]
    if n % dp:
        raise ValueError(f"dim {dim} of {n} does not split over {dp} data "
                         "ranks")
    k = n // dp
    return t[(slice(None),) * dim + (slice(d * k, (d + 1) * k),)]
