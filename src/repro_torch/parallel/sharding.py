"""Which group holds which dim of each parameter (port of ``param_specs``
in ``repro/parallel/sharding.py``, for what the port shards).

The reference gives every leaf a ``PartitionSpec`` over its (data, model)
mesh.  The port's ranks hold their parts as plain tensors, so the rule here
names, by leaf path (and, for the vocab pair, the leaf's whole shape and the
model group's size), the dim split over the EP group (one lane a rank), the
dim split over the model group by Megatron tensor parallelism (the
reference's TP entries, ``tensor_parallel``) or by the vocab split of
training (``vocab_parallel``), and the dim split over the data group
(``fsdp_experts``: ZeRO-3 of the expert weights, the reference's
``lay(ep, None, None, "data")`` and ``lay(ep, None, "data", None)``):

- ``layers/moe/w1``, ``w3``: (L, lanes, E_local, d, f), lanes over EP, f
  (dim -1) over the data group under FSDP;
- ``layers/moe/w2``: (L, lanes, E_local, f, d), lanes over EP, f (dim -2)
  over the data group under FSDP;
- under TP, column-split over the model group (dim -1):
  ``layers/attn/wq`` (heads), ``layers/mlp/w_gate`` and ``w_up``; row-split
  (dim -2): ``layers/attn/wo`` and ``layers/mlp/w_down``
  (``parallel/tp_blocks.py`` reads them so);
- in training over a model group of m > 1 ranks (every family, TP or not:
  the reference's train applies its specs whenever it trains over a model
  axis, ``launch/train.py:284-289``; its serve applies none), ``embed``
  (V, d) split on its vocab rows (dim 0) and ``lm_head`` (d, V) on its
  vocab columns (dim -1) where m divides V; where it does not, the
  reference's divisibility fallback (``lay``, ``sharding.py:27-42``):
  ``embed`` on d (dim -1) and ``lm_head`` on its d rows (dim 0); where m
  divides neither, both whole (:func:`vocab_dim`).  ``models/lm.py`` reads
  the vocab pair so (``core/dcomm``'s vocab-parallel embed, head and CE);
- over a model group of m > 1 ranks that divides the SSM heads (training
  and serving), the Mamba2 leaves split by SSM head (:data:`SSM_DIM`,
  ``layers/ssm.py``'s split mixer): rank r holds heads [r H / m, (r + 1) H
  / m), and in ``in_proj_zx`` and ``conv_w`` their z and x columns beside
  the B and C columns whole.  The reference cuts the concatenated
  ``[z | x | B | C]`` columns contiguously over ``model``
  (``sharding.py:43-44, :62-63``), a cut that is not head-aligned; under
  GSPMD it computes the single-device function all the same, which the
  port computes on this layout.  Where m does not divide the heads every
  rank holds the leaves whole (the reference's undividable dims stay
  unsplit, ``sharding.py:25-33``).  :func:`ssm_cut` and
  :func:`ssm_gather` are the one cut and the one gather-whole of them;
  a whole tree keeps the reference's shapes;
- every other leaf replicated.  That includes ``wk`` and ``wv``: the
  reference's storage spec splits their columns too, but its
  ``megatron_attention`` reads them whole on every model rank
  (``tp_blocks.py:66-69``), and the port holds what the block reads.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

EXPERT_LEAVES = ("layers/moe/w1", "layers/moe/w3", "layers/moe/w2")
LANE_DIM = 1                 # the lane axis of the (L, lanes, ...) experts
# the f dim of each expert leaf, the one FSDP splits over the data group,
# counted from the end: the same dim of the stacked (L, lanes, E_local, ...)
# leaf, of one layer's and of one lane's
FSDP_DIM = {"layers/moe/w1": -1, "layers/moe/w3": -1, "layers/moe/w2": -2}
# the dim of each leaf Megatron TP splits over the model group, from the
# end: the column-parallel products' outputs and the row-parallel ones'
# inputs (the reference's param_specs, sharding.py:42-51)
TP_DIM = {"layers/attn/wq": -1, "layers/mlp/w_gate": -1,
          "layers/mlp/w_up": -1, "layers/attn/wo": -2,
          "layers/mlp/w_down": -2}
# the vocab pair's dims over the model group in training, from the end:
# (its vocab dim, its d dim), the second where the group does not divide the
# vocab (the reference's param_specs, sharding.py:34-42)
VOCAB_DIM = {"embed": (-2, -1), "lm_head": (-1, -2)}
# the Mamba2 leaves split over a model group by SSM head: each leaf's dim,
# from the end, and the segments along it in order, by what they hold:
# "inner" d_inner's columns, head-major (head h owns [h P, (h + 1) P)),
# split by head; "heads" one entry a head, split by head; "groups" the B
# and C columns (2 G N), which every rank holds whole
SSM_DIM = {
    "layers/ssm/in_proj_zx": (-1, ("inner", "inner", "groups")),  # z, x, B C
    "layers/ssm/conv_w": (-1, ("inner", "groups")),               # x, B C
    "layers/ssm/in_proj_dt": (-1, ("heads",)),
    "layers/ssm/dt_bias": (-1, ("heads",)),
    "layers/ssm/a_log": (-1, ("heads",)),
    "layers/ssm/d_skip": (-1, ("heads",)),
    "layers/ssm/norm": (-1, ("inner",)),
    "layers/ssm/out_proj": (-2, ("inner",)),
}
WHOLE_SEGMENT = "groups"


class SsmDims(NamedTuple):
    """The sizes of the :data:`SSM_DIM` segments of a config."""
    inner: int       # d_inner
    heads: int       # SSM heads
    groups: int      # the B and C columns, 2 G N


class Spec(NamedTuple):
    """The dim of a leaf split over the EP group, over the data group and
    over the model group by TP or the vocab split (None: not split over
    it)."""
    ep: int | None = None
    data: int | None = None
    model: int | None = None


REPLICATED = Spec()


def vocab_dim(path: str, shape, m: int) -> int | None:
    """The dim, from the end, of the vocab pair's leaf at ``path`` of whole
    ``shape`` split over a model group of ``m`` in training: its vocab dim
    where ``m`` divides it, else its d dim where ``m`` divides that, else
    None (whole); None for any other leaf and for ``m`` of 1."""
    if path not in VOCAB_DIM or m <= 1:
        return None
    return next((dim for dim in VOCAB_DIM[path] if shape[dim] % m == 0),
                None)


def param_spec(path: str, shape=None, *, fsdp_experts: bool = False,
               tensor_parallel: bool = False, model_size: int = 1) -> Spec:
    """The :class:`Spec` of the leaf at ``path`` ("a/b/c", as
    ``optim/adamw.paths`` names it) of whole ``shape``;
    ``tensor_parallel``: the TP entries (:data:`TP_DIM`) are split over the
    model group; ``model_size`` > 1 (a training context's model group):
    the vocab pair is split over it by :func:`vocab_dim`, which needs
    ``shape``."""
    if path in EXPERT_LEAVES:
        return Spec(LANE_DIM, FSDP_DIM[path] if fsdp_experts else None)
    if tensor_parallel and path in TP_DIM:
        return Spec(model=TP_DIM[path])
    if path in VOCAB_DIM and model_size > 1:
        return Spec(model=vocab_dim(path, shape, model_size))
    return REPLICATED


def param_specs(tree, *, fsdp_experts: bool = False,
                tensor_parallel: bool = False, model_size: int = 1,
                prefix: str = "") -> dict:
    """A tree shaped like ``tree`` (nested dicts of whole tensors) of each
    leaf's :func:`param_spec`."""
    return {k: param_specs(v, fsdp_experts=fsdp_experts,
                           tensor_parallel=tensor_parallel,
                           model_size=model_size, prefix=f"{prefix}{k}/")
            if isinstance(v, dict) else
            param_spec(prefix + k, tuple(v.shape), fsdp_experts=fsdp_experts,
                       tensor_parallel=tensor_parallel,
                       model_size=model_size)
            for k, v in tree.items()}


def tp_sharded(path: str) -> bool:
    """Whether the leaf at ``path`` is split over the model group under
    Megatron TP."""
    return param_spec(path, tensor_parallel=True).model is not None


def tp_dim(path: str) -> int:
    """The dim of a TP leaf (:func:`tp_sharded`) split over the model
    group, from the end."""
    return param_spec(path, tensor_parallel=True).model


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


def ssm_split(dims: SsmDims | None, m: int) -> bool:
    """Whether a model group of ``m`` splits the Mamba2 leaves of ``dims``
    (None: a model without them) by head: m > 1 divides the heads."""
    return dims is not None and m > 1 and dims.heads % m == 0


def ssm_segments(path: str, dims: SsmDims | None, m: int):
    """(dim from the end, [(whole size, split by head)]) of the leaf at
    ``path`` over a model group of ``m`` (:data:`SSM_DIM`); None for a
    leaf not split so (:func:`ssm_split`)."""
    if path not in SSM_DIM or not ssm_split(dims, m):
        return None
    dim, names = SSM_DIM[path]
    return dim, [(getattr(dims, n), n != WHOLE_SEGMENT) for n in names]


def ssm_columns(path: str, dims: SsmDims, m: int, r: int) -> list[int]:
    """The indices, on its :data:`SSM_DIM` dim, of the whole leaf at
    ``path`` that model rank ``r`` of ``m`` holds, in its shard's order:
    of each segment the slice of its heads, or all of it (B and C)."""
    _, segs = ssm_segments(path, dims, m)
    out, start = [], 0
    for size, split in segs:
        k = size // m
        out += (range(start + r * k, start + (r + 1) * k) if split
                else range(start, start + size))
        start += size
    return out


def ssm_cut(path: str, t, dims: SsmDims | None, m: int, r: int):
    """Model rank ``r``'s shard of the whole leaf ``t`` (a tensor or an
    array) at ``path`` over a model group of ``m`` (a copy); ``t`` as it
    is for a leaf not split (:func:`ssm_segments`)."""
    seg = ssm_segments(path, dims, m)
    if seg is None:
        return t
    dim, cols = seg[0] % t.ndim, ssm_columns(path, dims, m, r)
    if isinstance(t, torch.Tensor):
        return t.index_select(dim, torch.tensor(cols, device=t.device))
    return np.take(t, cols, axis=dim)


def ssm_gather(path: str, parts: list, dims: SsmDims):
    """The whole leaf at ``path`` from every model rank's shard ``parts``
    (tensors, in rank order; the converse of :func:`ssm_cut`): the split
    segments joined by rank, the whole ones taken from rank 0."""
    m = len(parts)
    dim, segs = ssm_segments(path, dims, m)
    dim %= parts[0].ndim
    shape = list(parts[0].shape)
    shape[dim] = sum(size for size, _ in segs)
    whole = parts[0].new_empty(shape)
    for r in reversed(range(m)):          # rank 0's whole segments last
        idx = torch.tensor(ssm_columns(path, dims, m, r),
                           device=whole.device)
        whole.index_copy_(dim, idx, parts[r])
    return whole


def ssm_whole(path: str, dims: SsmDims | None, m: int):
    """(dim from the end, [(start, stop)]) of the columns of a model rank's
    shard of the leaf at ``path`` that every rank of ``m`` holds alike (the
    B and C columns); None for a leaf without them or not split."""
    seg = ssm_segments(path, dims, m)
    if seg is None:
        return None
    spans, start = [], 0
    for size, split in seg[1]:
        n = size // m if split else size
        if not split:
            spans.append((start, start + n))
        start += n
    return (seg[0], spans) if spans else None
