"""Decoder-only LM, ``dense``, ``moe``, ``moe_tx``, ``moe_ffn``, ``ssm``,
``hybrid`` and ``vlm`` families: parameters, prefill and single-token
decode (port of ``repro/models/lm.py``, the serving path: a lock-step batch
or a continuous-batching slot pool with per-row positions), the training
forward and chunked CE loss, and the online traffic statistics threaded
through the prefill and the training forward of the MoE families.

Prefill runs every MoE layer through the FUSCO shuffle: ``layers/moe.moe_block``
(moe: sequential blocks), ``layers/moe.stream_tx_layers`` (moe_tx: parallel
attention+MoE blocks) or ``layers/moe.stream_moe_layers`` (moe_ffn: the
attention-free chain of MoE layers, in cross-layer stream blocks), each EP
rank on its stripe of the sequence, as the reference's islands shard it.
The dense family's blocks are attention then the SwiGLU MLP, whose products
are ``torch.matmul`` (the reference's are jnp, outside any Pallas kernel).
The ssm family's layers are ``h + mamba2(ln1 h)`` (``layers/ssm.py``), the
hybrid family's Hymba's parallel attention and SSM heads
(``layers/hybrid.py``) then the SwiGLU MLP, its attention windowed on
every layer but ``cfg.global_layers``; their decode state carries each
layer's SSD state and conv inputs (``DecodeState.ssm``).  Over a model
group (:func:`ssm_group`) their Mamba2 mixers split by SSM head
(``layers/ssm.mamba2_mixer``'s ``group``, each rank holding its heads'
cut of the leaves, ``parallel/sharding.SSM_DIM``) in training, prefill
and decode, and Hymba's attention runs as the head-parallel island in
training and the prefill (:func:`island_group`); its MLP, and its
decode's attention, stay whole on every rank.  The vlm family
is the dense family's layers under M-RoPE: its inputs are (B, S, d)
embeddings (a stubbed vision frontend's patches) with (3, S) position ids,
whose temporal row masks attention.  Over a model group its attention, in
training and in the prefill, runs as the reference's head-parallel island
(``layers/attention.sharded_flash_attention``, M-RoPE inside), as does the
encoder-decoder family's of ``models/encdec_model.py``, whose context this
module builds too (:data:`ISLAND_FAMILIES`); both also run over a data
group, as the ssm and hybrid families do.
Decode uses the replicated-token MoE (``layers/moe.moe_decode_block``).
Training over a model group (an EP group, or that of a (data, model)
grid) runs the dense and moe families' attention and the dense MLP as
Megatron-SP tensor parallelism over it (``parallel/tp_blocks.py``, :func:`tensor_parallel`): the
residual stream stays a (B, S / m, d) stripe of the sequence between
blocks, and each rank holds its TP shards of ``wq``, ``wo`` and the MLP
(``parallel/sharding.TP_DIM``).  Every family training over a model group
holds ``embed`` and ``lm_head`` split over it (:func:`vocab_parallel`: the
vocab, or d where the group does not divide it), looked up and taken
through the CE vocab-parallel (``core/dcomm.vocab_embed``,
``vocab_parallel_ce``); serving contexts read them whole.  Serving over a
(data, model) grid splits the batch rows over the data group in blocks
(:func:`data_rows`): each rank prefills and decodes its rows, its EP group
routes them, and under ``fsdp_experts`` each MoE layer gathers the expert
weights over the data group.
The reference scans one compiled layer body; here a Python loop walks the
layers of the stacked (L, ...) parameter tree, which keeps the reference's
layout so ``convert.params_from_jax`` maps one onto the other leaf by leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
import torch.distributed as dist
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import calibrate, dcomm, relayout
from repro_torch.core import traffic as traffic_lib
from repro_torch.core.dcomm import (DcommConfig, all_gather_seq, group_size,
                                    seq_stripe)
from repro_torch.core.routing import ExpertPlacement
from repro_torch.layers.attention import (KVCache, attention_block,
                                          cache_update, causal_attention,
                                          decode_attention, gqa_project,
                                          mask_positions, rotate)
from repro_torch.layers.common import dense_init, embed_init, rms_norm
from repro_torch.layers.hybrid import hymba_mixer
from repro_torch.layers.ssm import SsmState, mamba2_mixer
from repro_torch.parallel import sharding, tp_blocks
from repro_torch.layers.moe import (moe_block, moe_decode_block,
                                    stream_moe_layers, stream_tx_layers)


@dataclasses.dataclass(frozen=True)
class ModelContext:
    cfg: ArchConfig
    device: torch.device
    ep_group: Any                  # None, the EP group, or its dcomm.EPGroups
    # the arithmetic ExpertPlacement or a relayout.TablePlacement (swapped in
    # with dataclasses.replace); None: a family without MoE (dense)
    placement: ExpertPlacement | relayout.TablePlacement | None
    dcfg: DcommConfig | None
    compute_dtype: torch.dtype = torch.bfloat16
    # moe_tx / moe_ffn families: layers per stream block (<= 1: one layer a
    # block)
    moe_stream: int = 0
    # EMA decay of the online traffic statistics (when a TrafficState is
    # threaded through the prefill)
    traffic_decay: float = 0.99
    # the launch.mesh.HostMesh of a (data, model) training grid whose EP
    # group is ``ep_group``'s (None: no data group)
    mesh: Any = None
    # moe_tx / moe_ffn families: token micro-batch lanes (batch chunks)
    # round-robin through each fused_pipe stream block (1: the plain stream)
    moe_interleave: int = 1
    # moe family: each layer's engine, from the comm-path policy
    # (``core/commplan.plan_paths``), n_layers names; None: ``dcfg.engine``
    # everywhere.  Only the training forward reads it (the reference's
    # lm.py:62-68); the stream families share one schedule per block and
    # keep the single-engine dcfg
    engines: tuple | None = None
    # the MoE families: the expert weights' f dim split over the data group
    # (ZeRO-3 of the experts, the reference's ``fsdp_experts``); at one data
    # rank it changes nothing
    fsdp_experts: bool = False
    # the dense and moe families over a model group: Megatron-SP tensor
    # parallelism where :meth:`tp_eligible` holds (the reference's default,
    # lm.py:49); False keeps every rank's attention (and the dense MLP) whole
    # over the whole sequence, as serving reads it
    explicit_tp: bool = True
    # a training context: over a model group the vocab pair (embed, lm_head)
    # is split over it (:func:`vocab_parallel`, the reference's train-time
    # specs); a serving context passes False and reads both whole, as the
    # reference's serve applies no specs
    split_vocab: bool = True

    def tp_eligible(self) -> bool:
        """The reference's rule (lm.py:70-77): explicit TP, a family of
        sequential attention blocks (dense, moe) whose head count the model
        group divides; in the port also a plain "model" EP axis (the TP
        group of a (pod, model) axis is not ported)."""
        cfg = self.cfg
        return (self.explicit_tp and cfg.n_heads > 0
                and cfg.n_heads % group_size(self.ep_group) == 0
                and cfg.family in ("dense", "moe")
                and (self.dcfg is None or self.dcfg.pod_axis is None))


# the sub-layers of each ported family's layer, besides ``ln1`` (the
# reference's init_params by family, lm.py:214-225): ``attn`` brings ``ln2``;
# the hybrid family's layers also hold ``attn_out_norm`` and
# ``ssm_out_norm`` (:data:`HYBRID_NORMS`)
FAMILY_PARTS = {"dense": ("attn", "mlp"), "moe": ("attn", "moe"),
                "moe_tx": ("attn", "moe"), "moe_ffn": ("moe",),
                "ssm": ("ssm",), "hybrid": ("attn", "mlp", "ssm"),
                "vlm": ("attn", "mlp")}
FAMILIES = tuple(FAMILY_PARTS)
HYBRID_NORMS = ("attn_out_norm", "ssm_out_norm")
# the families whose layers hold a Mamba2 mixer: their stack is
# :func:`_whole_stack`, whose mixers split by SSM head over a model group
# (:func:`ssm_group`)
SSM_FAMILIES = ("ssm", "hybrid")
# the families whose attention runs as the head-parallel island over a
# model group (the reference's ``shard_ctx``, :func:`island_group`); the
# rest of their layers stays whole on every rank, and over a (pod, model)
# EP axis they raise (:func:`make_context`); encdec's model is
# ``models/encdec_model.py``
ISLAND_FAMILIES = ("vlm", "encdec")


def has_attention(cfg: ArchConfig) -> bool:
    """Whether ``cfg``'s layers hold attention (and a KV cache): the
    encoder-decoder's do too."""
    return cfg.family == "encdec" or "attn" in FAMILY_PARTS[cfg.family]


def has_mlp(cfg: ArchConfig) -> bool:
    """Whether ``cfg``'s layers hold a dense SwiGLU MLP."""
    return "mlp" in FAMILY_PARTS[cfg.family]


def has_ssm(cfg: ArchConfig) -> bool:
    """Whether ``cfg``'s layers hold a Mamba2 mixer (and an SSM state)."""
    return "ssm" in FAMILY_PARTS[cfg.family]


def seq_multiple(cfg: ArchConfig) -> int:
    """The multiple every prefill or training sequence of ``cfg`` must be:
    the SSD's chunk for a family with a Mamba2 mixer, else 1."""
    return cfg.ssm.chunk if has_ssm(cfg) else 1


def ssm_args(cfg: ArchConfig) -> dict:
    """``mamba2_mixer``'s dims of ``cfg`` (the reference's ``_ssm_args``,
    lm.py:236-240)."""
    s = cfg.ssm
    din, h, _ = _ssm_dims(cfg)
    return dict(d_inner=din, n_heads=h, head_dim=s.head_dim,
                d_state=s.d_state, n_groups=s.n_groups, chunk=s.chunk)


def _ssm_dims(cfg: ArchConfig) -> tuple[int, int, int]:
    """(d_inner, SSM heads, conv_dim) of ``cfg``."""
    s = cfg.ssm
    din = s.expand * cfg.d_model
    return din, din // s.head_dim, din + 2 * s.n_groups * s.d_state


def ssm_dims(cfg: ArchConfig) -> sharding.SsmDims | None:
    """The sizes the Mamba2 leaves of ``cfg`` split by
    (``parallel/sharding.SsmDims``); None for a family without them."""
    if cfg.family not in SSM_FAMILIES:
        return None
    din, h, conv_dim = _ssm_dims(cfg)
    return sharding.SsmDims(din, h, conv_dim - din)


def make_context(cfg: ArchConfig, device="cuda", *,
                 ep_group: dist.ProcessGroup | None = None, mesh=None,
                 engine: str = "fused_flat", capacity_factor: float = 2.0,
                 use_balancer: bool = True, node_size: int | None = None,
                 multi_pod: bool = False, dedup: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 moe_stream: int = 0, moe_interleave: int = 1,
                 pipe_slices: int = 0, calibration=None,
                 traffic_decay: float = 0.99,
                 fsdp_experts: bool | None = None,
                 explicit_tp: bool = True,
                 split_vocab: bool = True) -> ModelContext:
    """Context of a ``dense``-, ``moe``-, ``moe_tx``- or ``moe_ffn``-family
    model whose EP domain is ``ep_group`` (None: one lane), or that of this
    rank on ``mesh`` (a
    ``launch.mesh.HostMesh``: the rank trains on its data group's shard of
    the batch, and its EP domain is one of the grid's).  ``node_size``
    lanes make a node
    (default: a quarter of the EP group, as the reference's); with
    ``multi_pod`` the EP axis is (pod, model), each pod one node of
    ``node_size`` lanes (required then).  Over more than one lane it builds
    what the engine needs on every rank, in the same order (collective):
    the node groups of ``fused_hier``, the pod and model groups of a
    (pod, model) axis (``dcomm.ep_groups``, those of every EP domain of
    ``mesh``).  ``use_balancer`` and
    ``dedup`` go to the config as in the reference.  ``moe_stream`` groups
    the moe_tx or moe_ffn layers into stream blocks; ``moe_interleave``
    (K, stored as ``max(1, K)`` for every family, as the reference) splits
    each rank's batch into K micro-batch lanes round-robin through each
    fused_pipe block; ``pipe_slices`` fixes
    fused_pipe's slice count (0: pipesim's); ``calibration`` (a
    ``core.calibrate.CalibrationTable``) replaces the H100 spec-point pipe
    constants with measured ones; ``traffic_decay`` is the EMA decay of
    the traffic statistics.  ``fsdp_experts`` splits the expert weights' f
    dim over the data group (:func:`fsdp_group`); None takes the
    reference's rule (lm.py:143-147): on when one lane's expert weights over
    all layers exceed 4 GB in bf16 (:func:`fsdp_rule`).  ``explicit_tp``:
    over a model group (``ep_group``, or that of ``mesh``) the dense and
    moe families train with Megatron-SP tensor parallelism
    (:func:`tensor_parallel`), each rank holding its shards of the TP
    leaves; a serving context over a group passes ``explicit_tp=False``
    and ``split_vocab=False``, since prefill and decode read whole weights.
    ``split_vocab``: a training context over a model group splits the vocab
    pair over it (:func:`vocab_parallel`), every family.  The vlm and encdec
    families run on one rank, over a model group (their attention the
    head-parallel island, :func:`island_group`), over a data group or on a
    grid, and so do the ssm and hybrid families (their Mamba2 mixers split
    by SSM head over the model group, :func:`ssm_group`; Hymba's attention
    the island); with ``multi_pod`` these four raise NotImplementedError.
    A family without MoE
    (dense) has no placement and no dcomm config, as the reference's; over
    a model group it runs TP (its replicated layout with
    ``explicit_tp=False``), and data parallelism over ``mesh``'s data
    group.  Raises if ``device`` is CUDA and no card is there."""
    if cfg.family not in FAMILIES + ISLAND_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported (only "
            f"{FAMILIES + ISLAND_FAMILIES})")
    if mesh is not None:
        if ep_group is not None:
            raise ValueError("pass ep_group or mesh, not both")
        ep_group = mesh.ep_group
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for, but torch sees no CUDA "
                           "device (pass device='cpu' to run the plain path)")
    ep = group_size(ep_group)
    if cfg.family in ISLAND_FAMILIES + SSM_FAMILIES and multi_pod:
        raise NotImplementedError(
            f"the {cfg.family} family over a (pod, model) axis is not ported: "
            "ROADMAP queue 1 item 8, TP and the vocab split over (pod, model) "
            "(its vocab split, attention island and SSM heads run over a "
            "model group)")
    if cfg.moe is None:
        return ModelContext(cfg, device, ep_group, None, None, compute_dtype,
                            moe_stream, traffic_decay, mesh,
                            max(1, moe_interleave), explicit_tp=explicit_tp,
                            split_vocab=split_vocab)
    if multi_pod and node_size is None and ep > 1:
        raise ValueError("multi_pod: pass node_size, the lanes of one pod")
    ns = node_size or max(1, ep // 4)
    placement = ExpertPlacement(n_experts=cfg.moe.n_experts, ep=ep, node_size=ns)
    dcfg = DcommConfig(engine=engine,
                       ep_axis=("pod", "model") if multi_pod else "model",
                       node_size=ns, capacity_factor=capacity_factor,
                       use_balancer=use_balancer, dedup=dedup,
                       pipe_slices=pipe_slices)
    if calibration is not None:
        dcfg = calibrate.apply(calibration, dcfg)
    if ep > 1 and (multi_pod or (engine == "fused_hier" and ns < ep)):
        ep_group = dcomm.ep_groups(
            ep_group, ns, ep // ns if multi_pod else 1,
            domains=None if mesh is None else mesh.ep_domains())
    if fsdp_experts is None:
        fsdp_experts = fsdp_rule(cfg, placement)
    return ModelContext(cfg, device, ep_group, placement, dcfg, compute_dtype,
                        moe_stream, traffic_decay, mesh,
                        max(1, moe_interleave), fsdp_experts=fsdp_experts,
                        explicit_tp=explicit_tp, split_vocab=split_vocab)


def fsdp_rule(cfg: ArchConfig, placement) -> bool:
    """The reference's ``fsdp_experts`` rule (lm.py:143-147): one lane's
    expert weights over all layers, in bf16, exceed 4 GB."""
    per_lane_gb = (max(1, placement.experts_per_lane) * 3 * cfg.d_model
                   * cfg.moe.d_ff_expert * 2 * cfg.n_layers) / 1e9
    return per_lane_gb > 4.0


def data_group(ctx: ModelContext) -> dist.ProcessGroup | None:
    """The data group of ``ctx``'s grid (None: one data rank)."""
    return None if ctx.mesh is None else ctx.mesh.data_group


def fsdp_group(ctx: ModelContext) -> dist.ProcessGroup | None:
    """The data group the expert weights' f dim is split over: ``ctx``'s
    data group under ``fsdp_experts`` with more than one data rank, else
    None (every rank holds its lane's experts whole)."""
    return data_group(ctx) if ctx.fsdp_experts else None


def fsdp_sharded(ctx: ModelContext):
    """The predicate on a leaf's path of the leaves split over the data
    group under ``ctx`` (FSDP's expert leaves; none without
    :func:`fsdp_group`)."""
    if fsdp_group(ctx) is None:
        return lambda path: False
    return sharding.fsdp_sharded


def island_group(ctx: ModelContext):
    """The model group the attention of ``ctx`` runs head-parallel over
    (``layers/attention.sharded_flash_attention``, the reference's
    ``shard_ctx``): ``ctx.ep_group`` for a family of
    :data:`ISLAND_FAMILIES`, or the hybrid family (in training and the
    prefill), over a model group of more than one rank, else None
    (attention whole on every rank)."""
    if ((ctx.cfg.family in ISLAND_FAMILIES or ctx.cfg.family == "hybrid")
            and group_size(ctx.ep_group) > 1):
        return ctx.ep_group
    return None


def ssm_group(ctx: ModelContext):
    """The model group the Mamba2 mixers of ``ctx`` split their SSM heads
    over (``layers/ssm.mamba2_mixer``'s ``group``): ``ctx.ep_group`` for
    the ssm and hybrid families over a model group of m > 1 ranks that
    divides the heads (``sharding.ssm_split``), in training and serving
    alike; else None (the mixer whole on every rank, as the reference keeps
    an undividable dim unsplit)."""
    if sharding.ssm_split(ssm_dims(ctx.cfg), group_size(ctx.ep_group)):
        return ctx.ep_group
    return None


def ssm_whole(ctx: ModelContext):
    """``fn(path) -> (dim, [(start, stop)]) | None``: the columns of this
    rank's shard of each Mamba2 leaf under ``ctx`` that every rank of the
    model group holds alike (the B and C columns of ``in_proj_zx`` and
    ``conv_w``, ``sharding.ssm_whole``); None (no function) without
    :func:`ssm_group`.  Their gradients are this rank's shares, summed over
    the model group by the train step, and the clip norm counts them
    once."""
    if ssm_group(ctx) is None:
        return None
    dims, m = ssm_dims(ctx.cfg), group_size(ctx.ep_group)
    return lambda path: sharding.ssm_whole(path, dims, m)


def tensor_parallel(ctx: ModelContext) -> bool:
    """Whether ``ctx`` trains with Megatron-SP tensor parallelism: where
    :meth:`ModelContext.tp_eligible` holds over a model group of more than
    one rank.  Its TP group is the model group, ``ctx.ep_group`` (the moe
    family's EP group too), with or without a grid's data group."""
    return group_size(ctx.ep_group) > 1 and ctx.tp_eligible()


def vocab_dim(ctx: ModelContext, path: str) -> int | None:
    """The dim, from the end, that ``ctx`` splits the vocab pair's leaf at
    ``path`` on over its model group (``sharding.vocab_dim`` of the whole
    (V, d) ``embed`` or (d, V) ``lm_head``: the vocab where the group
    divides it, else d, else None); None for any other leaf, one rank, or a
    serving context (``split_vocab`` off)."""
    cfg = ctx.cfg
    shape = {"embed": (cfg.vocab, cfg.d_model),
             "lm_head": (cfg.d_model, cfg.vocab)}.get(path)
    if shape is None or not ctx.split_vocab:
        return None
    return sharding.vocab_dim(path, shape, group_size(ctx.ep_group))


def vocab_parallel(ctx: ModelContext) -> bool:
    """Whether ``ctx`` holds the vocab pair split over its model group: a
    training context (``split_vocab``) over a model group of more than one
    rank that divides V or d (:func:`vocab_dim`), every family, with or
    without :func:`tensor_parallel` (the reference's train applies its
    specs whenever it trains over a model axis, train.py:284-289).  The
    loss then runs the vocab-parallel embed, head and CE
    (``core/dcomm.py``).  Raises on a (pod, model) EP axis: its model
    group is not ported."""
    if vocab_dim(ctx, "embed") is None:
        return False
    if ctx.dcfg is not None and ctx.dcfg.pod_axis is not None:
        raise NotImplementedError(
            "the vocab split over a (pod, model) EP axis is not ported: build "
            "the context with split_vocab=False")
    return True


def model_dim(ctx: ModelContext):
    """``fn(path) -> dim``: the dim, from the end, of each leaf this rank
    holds a shard of over the model group under ``ctx`` (the reference's
    TP entries, its header's "TP over model: attention heads, FFN columns,
    vocab"): the TP leaves' (``sharding.TP_DIM``) under
    :func:`tensor_parallel`, the vocab pair's under :func:`vocab_parallel`,
    the Mamba2 leaves' (``sharding.SSM_DIM``: cut by SSM head) under
    :func:`ssm_group`; None for every other leaf (the expert leaves are cut
    by lane, :func:`lane_sharded`)."""
    tp, vocab = tensor_parallel(ctx), vocab_parallel(ctx)
    ssm = ssm_group(ctx) is not None

    def dim(path: str) -> int | None:
        if tp and sharding.tp_sharded(path):
            return sharding.tp_dim(path)
        if ssm and path in sharding.SSM_DIM:
            return sharding.SSM_DIM[path][0]
        return vocab_dim(ctx, path) if vocab else None

    return dim


def tp_sharded(ctx: ModelContext):
    """The predicate on a leaf's path of the leaves this rank holds a shard
    of on a dim over the model group under ``ctx`` (:func:`model_dim`: the
    TP leaves, the vocab pair and the Mamba2 leaves; none at one rank)."""
    dim = model_dim(ctx)
    return lambda path: dim(path) is not None


def model_sharded(ctx: ModelContext):
    """The predicate of the leaves split over the model group under
    ``ctx``: the expert leaves (one lane a rank) and the shards of
    :func:`tp_sharded`."""
    tp = tp_sharded(ctx)
    return lambda path: lane_sharded(path) or tp(path)


def tp_cut(path: str, t, m: int, r: int, *, tp: bool = True,
           ssm: sharding.SsmDims | None = None):
    """The whole leaf at ``path`` (a tensor or an array) as model rank
    ``r`` of ``m`` holds it in training: the vocab pair cut on the dim
    ``sharding.vocab_dim`` gives its shape, with ``tp`` a TP leaf on its
    TP dim (a view), with ``ssm`` (the model's :func:`ssm_dims`) a Mamba2
    leaf by SSM head where m divides the heads (``sharding.ssm_cut``, a
    copy); any other as it is."""
    if sharding.ssm_segments(path, ssm, m) is not None:
        return sharding.ssm_cut(path, t, ssm, m, r)
    if tp and sharding.tp_sharded(path):
        dim = sharding.tp_dim(path)
    else:
        dim = sharding.vocab_dim(path, t.shape, m)
    return t if dim is None else sharding.data_cut(t, dim, m, r)


def _tp_own(path: str, t, ctx: ModelContext):
    """``t`` cut to this rank's shard on its :func:`model_dim` under
    ``ctx`` (a copy), or as it is."""
    dim = model_dim(ctx)(path)
    if dim is None:
        return t
    m, r = group_size(ctx.ep_group), dcomm.lane_index(ctx.ep_group)
    if path in sharding.SSM_DIM:
        return sharding.ssm_cut(path, t, ssm_dims(ctx.cfg), m, r)
    return sharding.data_cut(t, dim, m, r).clone()


def data_size(ctx: ModelContext) -> int:
    """The data ranks of ``ctx``'s grid (1 without a data group)."""
    return 1 if ctx.mesh is None else ctx.mesh.data


def data_rows(ctx: ModelContext, b: int) -> slice:
    """The rows of a global batch of ``b`` that this rank serves under
    ``ctx``: data rank d of D takes ``[d b / D, (d + 1) b / D)``, the block
    order of the reference's ``P("data")``; every row where D does not
    divide ``b`` (the reference's replicated decode rows, its
    ``moe_decode_block`` with ``dp = ()``), and every row at one data
    rank."""
    n = data_size(ctx)
    if n == 1 or b % n:
        return slice(0, b)
    k, d = b // n, ctx.mesh.data_index
    return slice(d * k, (d + 1) * k)


def gather_rows(t: torch.Tensor, ctx: ModelContext) -> torch.Tensor:
    """Every data rank's rows (dim 0) of ``t`` joined in data order, the
    global batch's (one ``all_gather_into_tensor`` over the data group;
    ``t`` itself at one data rank)."""
    group = data_group(ctx)
    return t if group is None else dcomm.all_gather_dim(t, 0, group)


def stats_group(ctx: ModelContext):
    """The group the traffic counts sum over: the whole grid with more than
    one data rank (the reference psums over ("data", "model")), else the
    EP group."""
    return ctx.ep_group if data_group(ctx) is None else ctx.mesh.grid


# the leaves the reference shards over its EP axis ("model",
# ``parallel/sharding.param_specs``): over an EP group each rank holds its
# lane of them; every other leaf is replicated
EXPERT_LEAVES = sharding.EXPERT_LEAVES
# whether the leaf at a path ("a/b/c", ``adamw.paths``) is sharded over the
# EP group, one lane a rank (the expert weights)
lane_sharded = sharding.lane_sharded


def _slot_ids(placement) -> list[list[int]]:
    """The id each (lane, slot) of ``placement``'s expert leaves draws its
    weights by (:func:`_expert_leaf`): under a ``relayout.TablePlacement``
    the expert it hosts, so an expert's replicas start equal and each expert
    has the same weights under every table; under the arithmetic placement
    the flat slot, lane * E_local + slot."""
    if isinstance(placement, relayout.TablePlacement):
        return relayout.placement_table(placement).tolist()
    el = placement.experts_per_lane
    return [[lane * el + e for e in range(el)] for lane in range(placement.ep)]


def _expert_leaf(gen: torch.Generator, lanes: range, ids: list, shape: tuple,
                 dtype, device) -> torch.Tensor:
    """A lane-major (L, len(lanes), E_local, *shape) expert leaf holding
    ``lanes``: slot (lane, e) draws its (L, *shape) from its own generator,
    seeded from one draw of ``gen`` and ``ids[lane][e]`` (:func:`_slot_ids`),
    so a lane's values do not depend on how many lanes there are, and the
    lanes not held are never drawn."""
    seed = int(torch.randint(1 << 62, (), generator=gen, device=gen.device))
    el = len(ids[0])
    w = torch.empty((shape[0], len(lanes), el, *shape[1:]), dtype=dtype,
                    device=device)
    for j, lane in enumerate(lanes):
        for e in range(el):
            g = torch.Generator(device=device)
            g.manual_seed(seed + ids[lane][e])
            w[:, j, e] = dense_init(g, shape, dtype=dtype, device=device)
    return w


def held_lanes(ctx: ModelContext) -> range:
    """The lanes of the expert leaves this rank holds: its own over an EP
    group of more than one rank, else all of the placement's (none without
    a placement: a family without MoE)."""
    if ctx.placement is None:
        return range(0)
    if group_size(ctx.ep_group) > 1:
        lane = dcomm.lane_index(ctx.ep_group)
        return range(lane, lane + 1)
    return range(ctx.placement.ep)


def init_params(cfg: ArchConfig, ctx: ModelContext, gen: torch.Generator,
                dtype=torch.bfloat16) -> dict:
    """Random parameters from ``gen`` in the reference's tree and layouts
    (lm.py:191-233), its layers by family: ``ln1``, then ``attn`` and
    ``ln2`` (dense, moe, moe_tx, hybrid), ``mlp`` (dense, hybrid:
    ``w_gate``/``w_up`` (L, d, f), ``w_down`` (L, f, d)), ``moe`` (the MoE
    families), ``ssm`` (ssm, hybrid: :func:`_ssm_params`) and the hybrid
    family's ``attn_out_norm`` and ``ssm_out_norm``; layers stacked
    on a leading (L,) axis, expert weights lane-major (L, lanes, E_local,
    d, f).  Over an EP group of more than one rank the expert leaves hold
    this rank's lane only (lanes = 1), and the other lanes are never drawn;
    otherwise every lane of the placement; under :func:`fsdp_group` their
    f dim is cut to this data rank's slice (:func:`fsdp_cut`).  Under
    :func:`tensor_parallel` each TP leaf, under :func:`vocab_parallel`
    the vocab pair, and under :func:`ssm_group` each Mamba2 leaf, is drawn
    whole and cut to this model rank's shard (:func:`model_dim`).  An expert's weights are the same
    for every EP size from the same ``gen`` (:func:`_expert_leaf`), and so
    are the other leaves, whole."""
    L, d, hd = cfg.n_layers, cfg.d_model, cfg.hd
    init = lambda shape: dense_init(gen, shape, dtype=dtype, device=ctx.device)
    ones = lambda shape: torch.ones(shape, dtype=dtype, device=ctx.device)
    tp = lambda name, shape: _tp_own(f"layers/{name}", init(shape), ctx)
    layers = {"ln1": ones((L, d))}
    if has_attention(cfg):
        attn = {"wq": tp("attn/wq", (L, d, cfg.n_heads * hd)),
                "wk": init((L, d, cfg.n_kv_heads * hd)),
                "wv": init((L, d, cfg.n_kv_heads * hd)),
                "wo": tp("attn/wo", (L, cfg.n_heads * hd, d))}
        if cfg.qk_norm:
            attn["q_norm"] = ones((L, hd))
            attn["k_norm"] = ones((L, hd))
        layers.update(attn=attn, ln2=ones((L, d)))
    if has_mlp(cfg):
        layers["mlp"] = {"w_gate": tp("mlp/w_gate", (L, d, cfg.d_ff)),
                         "w_up": tp("mlp/w_up", (L, d, cfg.d_ff)),
                         "w_down": tp("mlp/w_down", (L, cfg.d_ff, d))}
    if cfg.moe is not None:
        fe, ids = cfg.moe.d_ff_expert, _slot_ids(ctx.placement)
        lanes = held_lanes(ctx)
        experts = lambda name, shape: fsdp_cut(
            f"layers/moe/{name}",
            _expert_leaf(gen, lanes, ids, shape, dtype, ctx.device), ctx)
        layers["moe"] = {"router": init((L, d, cfg.moe.n_experts)),
                         "w1": experts("w1", (L, d, fe)),
                         "w3": experts("w3", (L, d, fe)),
                         "w2": experts("w2", (L, fe, d))}
    if has_ssm(cfg):
        layers["ssm"] = {k: _tp_own(f"layers/ssm/{k}", v, ctx) for k, v in
                         _ssm_params(cfg, gen, dtype, ctx.device).items()}
    if cfg.family == "hybrid":
        layers.update({name: ones((L, d)) for name in HYBRID_NORMS})
    return {
        "embed": _tp_own("embed", embed_init(gen, cfg.vocab, d, dtype,
                                             ctx.device), ctx),
        "layers": layers,
        "final_norm": ones((d,)),
        "lm_head": _tp_own("lm_head", init((d, cfg.vocab)), ctx),
    }


def _ssm_params(cfg: ArchConfig, gen: torch.Generator, dtype,
                device) -> dict:
    """The Mamba2 leaves (the reference's ``_ssm_params``, lm.py:191-207):
    ``a_log`` 0 (A = -1), ``dt_bias`` 0, ``d_skip`` 1, ``norm`` 1, the
    conv taps at scale 0.5."""
    L, d = cfg.n_layers, cfg.d_model
    din, h, conv_dim = _ssm_dims(cfg)
    init = lambda shape, scale=None: dense_init(gen, shape, scale, dtype,
                                                device)
    full = lambda shape, v: torch.full(shape, v, dtype=dtype, device=device)
    return {"in_proj_zx": init((L, d, din + conv_dim)),
            "in_proj_dt": init((L, d, h)),
            "conv_w": init((L, cfg.ssm.conv_kernel, conv_dim), 0.5),
            "dt_bias": full((L, h), 0.0),
            "a_log": full((L, h), 0.0),          # A = -exp(0) = -1
            "d_skip": full((L, h), 1.0),
            "norm": full((L, din), 1.0),
            "out_proj": init((L, din, d))}


def param_counts(cfg: ArchConfig) -> tuple[int, int]:
    """(replicated, expert) parameter counts of ``cfg``'s whole tree
    (:func:`init_params`' leaves; the expert leaves are :func:`lane_sharded`),
    reckoned from the config; (all, 0) for a family without MoE."""
    d, hd, L = cfg.d_model, cfg.hd, cfg.n_layers
    layer = d
    if has_attention(cfg):
        layer += d + d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads) + (
            2 * hd if cfg.qk_norm else 0)
    if has_mlp(cfg):
        layer += 3 * d * cfg.d_ff
    if has_ssm(cfg):
        din, h, conv_dim = _ssm_dims(cfg)
        layer += (d * (din + conv_dim) + d * h + cfg.ssm.conv_kernel * conv_dim
                  + 3 * h + din + din * d)
    if cfg.family == "hybrid":
        layer += len(HYBRID_NORMS) * d
    experts = 0
    if cfg.moe is not None:
        layer += d * cfg.moe.n_experts
        experts = L * 3 * cfg.moe.n_experts * d * cfg.moe.d_ff_expert
    return L * layer + 2 * cfg.vocab * d + d, experts


def ssm_param_count(cfg: ArchConfig, m: int = 1) -> int:
    """The parameters of ``cfg``'s Mamba2 leaves, of :func:`param_counts`'
    replicated ones, that one rank of a model group of ``m`` holds: its
    heads' share of each split segment and the B and C columns whole where
    ``m`` divides the heads (:func:`ssm_group`), else all of them; 0 for a
    family without them."""
    dims = ssm_dims(cfg)
    if dims is None:
        return 0
    din, h, gn = dims
    k = m if sharding.ssm_split(dims, m) else 1
    d, conv = cfg.d_model, cfg.ssm.conv_kernel
    return cfg.n_layers * (d * (2 * din // k + gn) + d * h // k
                           + conv * (din // k + gn) + 3 * h // k + din // k
                           + din // k * d)


def vocab_param_count(cfg: ArchConfig, m: int) -> int:
    """The parameters of the vocab pair (``embed``, ``lm_head``), of
    :func:`param_counts`' replicated ones, that a training context over a
    model group of ``m`` splits (:func:`vocab_parallel`): 2 V d, or 0 where
    ``m`` is 1 or divides neither V nor d; each rank then holds 1 / m of
    them."""
    split = sharding.vocab_dim("embed", (cfg.vocab, cfg.d_model), m)
    return 0 if split is None else 2 * cfg.vocab * cfg.d_model


def tp_param_count(cfg: ArchConfig) -> int:
    """The parameters of ``cfg``'s TP leaves (``sharding.TP_DIM``: ``wq``,
    ``wo`` and the dense MLP), of :func:`param_counts`' replicated ones;
    under :func:`tensor_parallel` each model rank holds 1 / m of them."""
    if not has_attention(cfg):
        return 0
    d, L = cfg.d_model, cfg.n_layers
    return L * (2 * d * cfg.n_heads * cfg.hd
                + (3 * d * cfg.d_ff if has_mlp(cfg) else 0))


def lane_cut(path: str, t, ep: int, lanes: range):
    """The leaf at ``path`` (a tensor or an array) as the rank holding
    ``lanes`` of ``ep`` holds it: an expert leaf of any lane count, all of
    its placement's *slots* lane-major (under a replicated table ep x
    slots exceeds the experts), regrouped into ``ep`` lanes and cut to
    ``lanes`` (a view); any other leaf as it is."""
    if not lane_sharded(path):
        return t
    return t.reshape(t.shape[0], ep, -1, *t.shape[3:])[
        :, lanes.start:lanes.stop]


def fsdp_cut(path: str, t, ctx: ModelContext):
    """The leaf at ``path`` as this data rank holds it under ``ctx``: an
    FSDP leaf (:func:`fsdp_sharded`) cut to its slice of the f dim (a
    copy), any other as it is."""
    group = fsdp_group(ctx)
    if group is None or not sharding.fsdp_sharded(path):
        return t
    return sharding.data_cut(t, sharding.fsdp_dim(path), ctx.mesh.data,
                             ctx.mesh.data_index).clone()


def shard_params(tree, ctx: ModelContext) -> dict:
    """This rank's parameters cut from a whole tree (expert leaves of any
    lane count holding every slot of ``ctx.placement``, in its layout: a
    tree of another placement is migrated first,
    ``relayout.migrate_lane_major``): the expert leaves cut to the lanes
    :func:`init_params` holds under ``ctx`` (:func:`lane_cut`, copied),
    and under :func:`fsdp_group` to this data rank's slice of their f dim
    (:func:`fsdp_cut`); under :func:`tensor_parallel` the TP leaves, and
    under :func:`vocab_parallel` the vocab pair, cut to this model rank's
    shard (copied); the other leaves as they are."""
    lanes = held_lanes(ctx)

    def cut(path, v):
        if ctx.placement is None or not lane_sharded(path):
            return _tp_own(path, v, ctx)
        v = lane_cut(path, v, ctx.placement.ep, lanes)
        return fsdp_cut(path, v, ctx) if fsdp_group(ctx) else v.clone()

    def walk(node, prefix=""):
        return {k: walk(v, f"{prefix}{k}/") if isinstance(v, dict)
                else cut(prefix + k, v) for k, v in node.items()}

    return walk(tree)


def _layer(tree, i: int | slice, cd: torch.dtype):
    """Layer ``i`` (or the layers of a slice) of a stacked parameter tree,
    float leaves in ``cd``."""
    if isinstance(tree, dict):
        return {k: _layer(v, i, cd) for k, v in tree.items()}
    leaf = tree[i]
    return leaf.to(cd) if leaf.is_floating_point() else leaf


def _attn_qkv(x, ap, cfg: ArchConfig, positions):
    """q, k, v of one attention layer, q and k rotated at ``positions``
    (M-RoPE at (3, ..., S) positions where ``cfg.mrope_sections`` is set)."""
    q, k, v = gqa_project(x, ap["wq"], ap["wk"], ap["wv"], cfg.n_heads,
                          cfg.n_kv_heads, cfg.hd,
                          ap.get("q_norm") if cfg.qk_norm else None,
                          ap.get("k_norm") if cfg.qk_norm else None)
    rot = lambda t: rotate(t, positions, cfg.rope_theta, cfg.mrope_sections)
    return rot(q), rot(k), v


class DecodeState(NamedTuple):
    kv: Any              # {"k", "v"}: (L, B, C, Hkv, hd); None for a family
                         # without attention (moe_ffn: stateless)
    length: torch.Tensor  # int32 on the device: () positions seen by every
                          # row (a lock-step batch), or (B,) one count a row
                          # (a continuous-batching slot pool: each row decodes
                          # at its own position; free slots sit at 0)
    ssm: Any = None      # {"state": (L, B, H, P, N), "conv": (L, B, K-1,
                         # conv_dim)}: each layer's SSD state and last conv
                         # inputs (ssm, hybrid); None for the other families


def _kv_capacity(cfg: ArchConfig, max_len: int) -> int:
    """Cache slots a layer: the window where there is one, except that a
    hybrid model with global layers keeps every position in every layer
    (one stacked cache; the reference's lm.py:593-598)."""
    if cfg.family == "hybrid" and cfg.global_layers:
        return max_len
    return min(max_len, cfg.window) if cfg.window else max_len


def layer_window(cfg: ArchConfig, i: int) -> int | None:
    """The attention window of layer ``i``: None on the hybrid family's
    global layers, else ``cfg.window``."""
    return None if i in cfg.global_layers else cfg.window


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int, dtype,
                      ctx: ModelContext, per_slot: bool = False) -> DecodeState:
    """Zeroed decode state of this rank's rows of a global ``batch``
    (:func:`data_rows`: all of them without a data group); ``per_slot``
    makes ``length`` per row (one int32 a row), the continuous-batching
    slot pool.  No cache (``kv`` None) for a family without attention; the
    SSD states and conv inputs (``ssm``) for a family with a Mamba2
    mixer, under :func:`ssm_group` those of this rank's heads (its x
    columns of the conv inputs beside B and C)."""
    zeros = lambda shape, dt: torch.zeros(shape, dtype=dt, device=ctx.device)
    rows = data_rows(ctx, batch)
    batch = rows.stop - rows.start
    L = cfg.n_layers
    kv = ssm = None
    if has_attention(cfg):
        c = _kv_capacity(cfg, max_len)
        shape = (L, batch, c, cfg.n_kv_heads, cfg.hd)
        kv = {"k": zeros(shape, dtype), "v": zeros(shape, dtype)}
    if has_ssm(cfg):
        s = cfg.ssm
        din, h, gn = ssm_dims(cfg)
        m = group_size(ssm_group(ctx))
        ssm = {"state": zeros((L, batch, h // m, s.head_dim, s.d_state),
                              dtype),
               "conv": zeros((L, batch, s.conv_kernel - 1, din // m + gn),
                             dtype)}
    return DecodeState(kv, zeros((batch,) if per_slot else (), torch.int32),
                       ssm)


def _cache_slots(kv: torch.Tensor, s: int, cap: int) -> torch.Tensor:
    """The decode cache of a prefill's (..., B, S, Hkv, hd) keys or values:
    the last ``cap`` positions at slot p % cap, or zero-padded to ``cap``."""
    if s >= cap:
        return torch.roll(kv[..., -cap:, :, :], s % cap, dims=-3)
    return torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, cap - s))


def _moe_stripe(x: torch.Tensor, moe_params, ctx: ModelContext,
                traffic=None, traffic_mask=None):
    """One MoE layer over this rank's stripe ``x`` of the sequence (the
    reference's island, lm.py:476-483), ``traffic_mask`` striped like it.
    With ``traffic`` (this layer's state) returns ``(y, new_traffic)``."""
    cfg = ctx.cfg
    return moe_block(x, moe_params, placement=ctx.placement, dcfg=ctx.dcfg,
                     top_k=cfg.moe.top_k, norm_topk=cfg.moe.norm_topk,
                     group=ctx.ep_group, traffic=traffic,
                     traffic_decay=ctx.traffic_decay,
                     traffic_mask=traffic_mask, stats_group=stats_group(ctx),
                     fsdp=fsdp_group(ctx))


def _moe_seq_sharded(x: torch.Tensor, moe_params, ctx: ModelContext,
                     traffic=None, traffic_mask=None):
    """One MoE layer as the reference's island runs it, the whole sequence
    in and out: this rank's stripe through the shuffle
    (:func:`_moe_stripe`), then every rank's stripes gathered.  With
    ``traffic`` (this layer's state) returns ``(y, new_traffic)``;
    ``traffic_mask`` (B, S) is striped like ``x``."""
    y = _moe_stripe(seq_stripe(x, ctx.ep_group), moe_params, ctx, traffic,
                    None if traffic_mask is None
                    else seq_stripe(traffic_mask, ctx.ep_group))
    if traffic is None:
        return all_gather_seq(y, ctx.ep_group)
    return all_gather_seq(y[0], ctx.ep_group), y[1]


def _mlp(x: torch.Tensor, mp) -> torch.Tensor:
    """The dense family's SwiGLU MLP, silu(x @ w_gate) * (x @ w_up) @
    w_down (the reference's lm.py:233-238)."""
    return (torch.nn.functional.silu(x @ mp["w_gate"]) * (x @ mp["w_up"])
            ) @ mp["w_down"]


def _seq_layer(h: torch.Tensor, lp, positions: torch.Tensor,
               ctx: ModelContext, traffic=None, traffic_mask=None):
    """One sequential block, h + attn(ln1 h), then + ffn(ln2 h): the MoE
    (moe) or the MLP (dense), with ``lp`` this layer's parameters in the
    compute dtype (the reference's ``layer_fn``, lm.py:445-510); the vlm's
    attention over a model group is the head-parallel island
    (:func:`island_group`).  Returns the new h and the layer's RoPE'd k and
    v (B, S, Hkv, hd), and with ``traffic`` (this layer's state; the moe
    family) the new state."""
    cfg = ctx.cfg
    b, s, _ = h.shape
    x = rms_norm(h, lp["ln1"])
    group = island_group(ctx)
    if group is None:
        q, k, v = _attn_qkv(x, lp["attn"], cfg, positions)
        mask = mask_positions(positions, cfg.mrope_sections)
        o = causal_attention(q, k, v, mask, mask, window=cfg.window)
        h = h + o.reshape(b, s, cfg.n_heads * cfg.hd) @ lp["attn"]["wo"]
    else:
        ap = lp["attn"]
        h = h + attention_block(
            x, ap, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
            rope_theta=cfg.rope_theta, positions=positions, causal=True,
            window=cfg.window, qk_norm=cfg.qk_norm,
            mrope_sections=cfg.mrope_sections, group=group)
        # the cache's k and v, projected again outside the island (the
        # reference's lm.py:861-874)
        k = (x @ ap["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.hd)
        v = (x @ ap["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.hd)
        if cfg.qk_norm:
            k = rms_norm(k, ap["k_norm"])
        k = rotate(k, positions, cfg.rope_theta, cfg.mrope_sections)
    if has_mlp(cfg):
        return h + _mlp(rms_norm(h, lp["ln2"]), lp["mlp"]), k, v
    y = _moe_seq_sharded(rms_norm(h, lp["ln2"]), lp["moe"], ctx, traffic,
                         traffic_mask)
    if traffic is None:
        return h + y, k, v
    return h + y[0], k, v, y[1]


def _tp_layer(h: torch.Tensor, lp, positions: torch.Tensor,
              ctx: ModelContext, traffic=None, traffic_mask=None):
    """One sequential block under Megatron-SP (the reference's ``layer_fn``
    with ``use_tp``, lm.py:458-490): ``h`` this rank's (B, S / m, d) stripe,
    ``lp`` the layer's parameters (TP shards) in the compute dtype,
    ``positions`` the whole sequence's.  ln1 and ln2 run on the stripe;
    attention is ``tp_blocks.megatron_attention``; the moe family's MoE
    takes the stripe as it is (``traffic_mask`` striped already), the dense
    family's MLP is ``tp_blocks.megatron_mlp``.  Returns the new stripe,
    and with ``traffic`` the layer's new state."""
    cfg = ctx.cfg
    h = h + tp_blocks.megatron_attention(
        rms_norm(h, lp["ln1"]), lp["attn"], group=ctx.ep_group,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
        rope_theta=cfg.rope_theta, positions=positions, window=cfg.window,
        qk_norm=cfg.qk_norm)
    x = rms_norm(h, lp["ln2"])
    if has_mlp(cfg):
        return h + tp_blocks.megatron_mlp(x, lp["mlp"], group=ctx.ep_group)
    y = _moe_stripe(x, lp["moe"], ctx, traffic, traffic_mask)
    return h + y if traffic is None else (h + y[0], y[1])


def _unstack(tree, cd: torch.dtype) -> list:
    """Each layer's parameters of a stacked (L, ...) tree, float leaves in
    ``cd``: each leaf cast once and unbound once (``torch.unbind``: views),
    so the backward assembles each stacked gradient with one stack, not one
    zero-filled gradient of the whole stack a layer."""
    if isinstance(tree, dict):
        subs = {k: _unstack(v, cd) for k, v in tree.items()}
        n = len(next(iter(subs.values())))
        return [{k: v[i] for k, v in subs.items()} for i in range(n)]
    return list(torch.unbind(tree.to(cd) if tree.is_floating_point()
                             else tree))


def _mixer_args(ctx: ModelContext) -> dict:
    """``mamba2_mixer``'s dims of ``ctx``'s config and the model group its
    heads split over (:func:`ssm_group`)."""
    return dict(ssm_args(ctx.cfg), group=ssm_group(ctx))


def _hymba(x, lp, positions, ctx: ModelContext, i: int, **kw):
    """Layer ``i``'s ``hymba_mixer`` under ``ctx``: the SSM branch split by
    :func:`ssm_group`; the attention of a prefill or training step over
    :func:`island_group`."""
    cfg = ctx.cfg
    return hymba_mixer(x, lp, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                       head_dim=cfg.hd, rope_theta=cfg.rope_theta,
                       positions=positions, window=layer_window(cfg, i),
                       ssm_args=_mixer_args(ctx), group=island_group(ctx),
                       **kw)


def _whole_stack(params, h: torch.Tensor, positions: torch.Tensor,
                 ctx: ModelContext, cap: int | None = None):
    """The ssm or hybrid stack over (B, S, d) ``h`` (the reference's
    lm.py:447-457 and :499-503): ssm ``h + mamba2(ln1 h)``; hybrid ``h +
    hymba(ln1 h)`` then ``h + mlp(ln2 h)``, each layer's attention windowed
    by :func:`layer_window`.  Over a model group the mixers split by SSM
    head (:func:`ssm_group`) and Hymba's attention is the island
    (:func:`island_group`); h stays whole on every rank.  Returns the
    final-normed h; with ``cap`` (prefill) also the decode caches of the
    attention layers (the last ``cap`` positions, at slot p % cap; None for
    ssm) and each layer's SSD state and conv inputs (this rank's heads'),
    stacked."""
    cfg, cd = ctx.cfg, ctx.compute_dtype
    s = h.shape[1]
    ks, vs, states, convs = [], [], [], []
    for i, lp in enumerate(_unstack(params["layers"], cd)):
        x = rms_norm(h, lp["ln1"])
        if cfg.family == "ssm":
            y, st = mamba2_mixer(x, lp["ssm"], **_mixer_args(ctx))
            h = h + y
        else:
            mix, kv, st = _hymba(x, lp, positions, ctx, i,
                                 return_kv=cap is not None)
            h = h + mix
            h = h + _mlp(rms_norm(h, lp["ln2"]), lp["mlp"])
            if cap is not None:
                ks.append(_cache_slots(kv[0], s, cap))
                vs.append(_cache_slots(kv[1], s, cap))
        if cap is not None:
            states.append(st.ssd)
            convs.append(st.conv)
    h = rms_norm(h, params["final_norm"].to(cd))
    if cap is None:
        return h
    kv = {"k": torch.stack(ks), "v": torch.stack(vs)} if ks else None
    return h, kv, {"state": torch.stack(states), "conv": torch.stack(convs)}


def _traffic_needs_moe(cfg: ArchConfig, traffic) -> None:
    if traffic is not None and cfg.moe is None:
        raise ValueError(
            f"traffic stats are threaded per layer through the MoE layers; "
            f"family {cfg.family!r} has none (moe / moe_ffn / moe_tx only)")


def forward_hidden(params, inputs: torch.Tensor, positions: torch.Tensor,
                   ctx: ModelContext, traffic=None, traffic_mask=None):
    """Training forward (the reference's ``forward_hidden``, lm.py:358-535,
    dense, moe, moe_tx, moe_ffn, ssm, hybrid and vlm branches): (B, S)
    tokens, or (B, S, d) embeddings (the vlm's), to the final-normed hidden
    states (B, S, d) in the compute dtype.  Parameters
    are cast to the compute dtype as they are used (lm.py:445), so a
    gradient reaches the stored leaves in their own dtype.  ``dense``:
    sequential blocks of attention and the MLP; ``moe``: sequential blocks,
    one MoE layer each; ``moe_tx``: the parallel blocks in stream blocks
    (:func:`_tx_stack`); ``moe_ffn``: the MoE layers in cross-layer stream
    blocks (:func:`_ffn_stack`); ``ssm`` and ``hybrid``:
    :func:`_whole_stack` (S a multiple of the SSD's chunk, else ValueError).
    In an EP group each rank runs the MoE on its stripe of the sequence, as
    ``prefill`` does; the stripes' all-gather
    sums the ranks' cotangents in its backward, so a loop training over an
    EP group in this replicated layout divides each rank's (replicated)
    cotangent by the group size (``launch/steps.py`` divides the loss; with
    the vocab pair split, :func:`lm_loss`'s head entry divides the
    cotangent instead) and all-reduces the replicated leaves' gradients,
    not those of the leaves split over the group (:func:`model_sharded`).

    Under :func:`tensor_parallel` (dense and moe over a model group) the
    embedding is cut to this rank's stripe of the sequence first and every
    block runs Megatron-SP (:func:`_tp_layer`): returns this rank's
    final-normed (B, S / m, d) stripe.  The gradients of the TP shards are
    then whole over the model group, those of the replicated leaves shares
    of it (``launch/steps.py``).  Under :func:`vocab_parallel` the lookup
    reads this rank's shard of ``embed`` (:func:`_embed`), and the
    gradient of that shard is whole.

    ``traffic``: the layer-stacked ``traffic.TrafficState`` threaded
    through the MoE layers; then returns ``(h, new_traffic)``.  The counts
    come from the integer routing matrix, so no gradient flows through
    them; a family without MoE raises, as the reference.  ``traffic_mask``:
    (B, S) bool, False for positions that must not count.

    The reference rematerialises each layer (or stream block) in its
    backward (``jax.checkpoint``); at the depths and widths the port trains
    on one card the activations fit beside the parameters and AdamW's state,
    so the layers keep theirs; under ``fsdp_experts`` over a data group the
    MoE layers gather each expert leaf again in the backward (as the
    reference's remat does), so no layer keeps its gathered weights
    (``layers/moe.py``).  The expert gradients of an FSDP leaf arrive
    reduce-scattered over the data group, this rank's slice summed."""
    cfg, cd = ctx.cfg, ctx.compute_dtype
    _traffic_needs_moe(cfg, traffic)
    tp = tensor_parallel(ctx)
    if tp and traffic_mask is not None:
        traffic_mask = seq_stripe(traffic_mask, ctx.ep_group)
    h = (inputs.to(cd) if inputs.dim() == 3
         else _embed(params["embed"].to(cd), inputs, ctx, stripe=tp))
    if cfg.family == "moe_tx":
        h, new_traffic, _ = _tx_stack(params, h, positions, ctx, traffic,
                                      traffic_mask)
        return h if traffic is None else (h, new_traffic)
    if cfg.family == "moe_ffn":
        h, new_traffic = _ffn_stack(params, h, ctx, traffic, traffic_mask)
        return h if traffic is None else (h, new_traffic)
    if cfg.family in SSM_FAMILIES:
        return _whole_stack(params, h, positions, ctx)
    trs = []
    for i, lctx in enumerate(_layer_contexts(ctx)):
        lp = _layer(params["layers"], i, cd)
        if tp:
            h = _tp_layer(h, lp, positions, lctx,
                          None if traffic is None
                          else traffic_lib.layers(traffic, i), traffic_mask)
            if traffic is not None:
                h, tr = h
                trs.append(tr)
        elif traffic is None:
            h, _, _ = _seq_layer(h, lp, positions, lctx)
        else:
            h, _, _, tr = _seq_layer(h, lp, positions, lctx,
                                     traffic_lib.layers(traffic, i),
                                     traffic_mask)
            trs.append(tr)
    h = rms_norm(h, params["final_norm"].to(cd))
    return h if traffic is None else (h, traffic_lib.stack(trs))


def _layer_contexts(ctx: ModelContext) -> list:
    """Each layer's context in the moe and dense loop: ``ctx`` itself, or
    under ``ctx.engines`` (moe family) one context per engine, its dcfg on
    that engine and ``dedup`` kept on fused_flat layers only (the
    reference's same-engine runs, lm.py:509-530)."""
    cfg = ctx.cfg
    if cfg.family != "moe" or ctx.engines is None:
        return [ctx] * cfg.n_layers
    if len(ctx.engines) != cfg.n_layers:
        raise ValueError(f"ctx.engines has {len(ctx.engines)} entries for "
                         f"{cfg.n_layers} layers")
    by_engine = {e: dataclasses.replace(ctx, dcfg=dataclasses.replace(
        ctx.dcfg, engine=e, dedup=ctx.dcfg.dedup and e == "fused_flat"))
                 for e in set(ctx.engines)}
    return [by_engine[e] for e in ctx.engines]


def _own_vocab(t: torch.Tensor, path: str, ctx: ModelContext) -> None:
    """Refuse a leaf of the vocab pair that is not what this rank holds
    under ``ctx`` (its shard under :func:`vocab_parallel`, else whole): a
    split context never reads a whole leaf, nor the other way."""
    cfg = ctx.cfg
    want = [cfg.vocab, cfg.d_model] if path == "embed" else [cfg.d_model,
                                                             cfg.vocab]
    dim = vocab_dim(ctx, path) if vocab_parallel(ctx) else None
    if dim is not None:
        want[dim] //= group_size(ctx.ep_group)
    if list(t.shape) != want:
        raise ValueError(
            f"{path} of shape {tuple(t.shape)}: this rank holds "
            f"{tuple(want)} under its context (vocab split over the model "
            f"group: {dim is not None}); cut a whole tree with "
            "lm.shard_params")


def _embed(table: torch.Tensor, tokens: torch.Tensor, ctx: ModelContext,
           stripe: bool = False) -> torch.Tensor:
    """(B, S) ``tokens`` embedded by ``table`` (``embed`` in the compute
    dtype, as this rank holds it under ``ctx``): (B, S, d), or with
    ``stripe`` this rank's (B, S / m, d) stripe of the sequence.  Under
    :func:`vocab_parallel` split on the vocab: ``dcomm.vocab_embed``'s
    masked lookup summed over the model group; split on d: this rank's
    columns of every token's row, all-gathered on d (``dcomm.gather_dim``,
    whose backward reduce-scatters the rows' cotangents)."""
    _own_vocab(table, "embed", ctx)
    dim = vocab_dim(ctx, "embed") if vocab_parallel(ctx) else None
    if dim == -2:
        return dcomm.vocab_embed(table, tokens, ctx.ep_group, stripe)
    if dim is None:
        return table[seq_stripe(tokens, ctx.ep_group) if stripe else tokens]
    h = dcomm.gather_dim(table[tokens], -1, dcomm.process_group(ctx.ep_group))
    return seq_stripe(h, ctx.ep_group) if stripe else h


def _ce_of_logits(logits: torch.Tensor, lx: torch.Tensor):
    """Summed next-token CE and the count of valid labels of (B, c, V)
    float32 logits and (B, c) labels (-1 = no label)."""
    logz = torch.logsumexp(logits, dim=-1)
    valid = lx >= 0
    gold = logits.gather(-1, lx.clamp_min(0)[..., None].long())[..., 0]
    return torch.where(valid, logz - gold, 0.0).sum(), valid.sum().float()


def _ce_chunk(hx: torch.Tensor, head: torch.Tensor, lx: torch.Tensor):
    """Summed next-token CE and the count of valid labels of one chunk:
    (B, c, d) hidden, (d, V) head, (B, c) labels (-1 = no label)."""
    return _ce_of_logits((hx @ head).float(), lx)                # (B, c, V)


def _vocab_ce_chunk(hx: torch.Tensor, head: torch.Tensor, lx: torch.Tensor,
                    group, dim: int):
    """:func:`_ce_chunk` with ``head`` this rank's shard of a model group:
    on the vocab (``dim`` -1, (d, V / m)), the (B, c, V / m) logits through
    ``dcomm.vocab_parallel_ce``; on d (``dim`` -2, (d / m, V)), this rank's
    d columns of ``hx`` times its rows, the partial logits summed over the
    group (``dcomm.sum_forward``), then the whole CE.  Every rank returns
    the same sum and count."""
    if dim == -1:
        losses = dcomm.vocab_parallel_ce((hx @ head).float(), lx, group)
        return losses.sum(), (lx >= 0).sum().float()
    k, r = head.shape[0], dcomm.lane_index(group)
    part = (hx[..., r * k:(r + 1) * k] @ head).float()
    return _ce_of_logits(dcomm.sum_forward(part, group), lx)


LOSS_CHUNK = 512   # sequence positions per CE chunk (the reference's default)


def chunked_ce(h: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
               chunk=_ce_chunk):
    """The summed CE and the count of valid labels of (B, S, d) ``h``
    through ``head``, over chunks of :data:`LOSS_CHUNK` positions, each
    ``chunk(hx, head, lx)`` under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint`` of its scanned chunk): the (B, c, V)
    float32 logits of a chunk are recomputed in the backward, not kept."""
    s = h.shape[1]
    c = min(LOSS_CHUNK, s)
    if s % c:
        raise ValueError(f"sequence {s} does not split into chunks of {c}")
    tot = torch.zeros((), device=h.device)
    cnt = torch.zeros((), device=h.device)
    for c0 in range(0, s, c):
        part, n = torch.utils.checkpoint.checkpoint(
            chunk, h[:, c0:c0 + c], head, labels[:, c0:c0 + c],
            use_reentrant=False)
        tot, cnt = tot + part, cnt + n
    return tot, cnt


def lm_loss(params, batch, ctx: ModelContext, traffic=None):
    """Next-token CE over ``batch`` {"tokens", "labels"} (B, S), labels
    already shifted, -1 for none, or the vlm's {"embeds" (B, S, d),
    "positions" (3, S), "labels"} (the reference's ``lm_loss``,
    lm.py:538-580): chunked over the sequence by ``LOSS_CHUNK``, each chunk
    under ``torch.utils.checkpoint`` as the reference wraps it in
    ``jax.checkpoint`` (:func:`chunked_ce`), so the (B, c, V) float32
    logits of every chunk are recomputed in the backward, not kept; the
    denominator counts the valid labels.  Returns (loss, metrics); with ``traffic`` (the layer-stacked
    state) the new state rides along as ``metrics["traffic"]``.

    Under :func:`vocab_parallel` every rank computes the whole sequence's
    CE over its shard of ``lm_head`` (:func:`_vocab_ce_chunk`: per chunk
    (B, c, V / m) logits, the reference's ``P(data, None, "model")``), so
    the loss and ``metrics["tokens"]`` are the same on every rank, and the
    gradient of the head's shard is whole.  The final hidden states enter
    the head whole: under :func:`tensor_parallel` the stripes all-gathered
    (the backward reduce-scatters each rank's partial cotangent back to
    its stripe), else through ``dcomm.copy_to_group`` (the backward sums
    the partials and takes the 1 / m share ``launch/steps.py`` passes on
    over an EP group, so the loss is not divided there).  The chunks'
    collectives rerun in the checkpoints' recomputes, in the same order on
    every rank.

    Under :func:`tensor_parallel` without the vocab split (a group that
    divides neither V nor d) each rank computes the CE of its stripe of the
    sequence (S must split over the model group, else ValueError); the sum
    and the count are summed over the model group by
    ``dcomm.sum_forward``, whose backward seeds each rank's own addend."""
    inputs = batch["embeds"] if "embeds" in batch else batch["tokens"]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(inputs.shape[1], device=inputs.device)
    h = forward_hidden(params, inputs, positions, ctx, traffic=traffic)
    new_traffic = None
    if traffic is not None:
        h, new_traffic = h
    loss, metrics = head_loss(h, params["lm_head"], batch["labels"], ctx)
    if new_traffic is not None:
        metrics["traffic"] = new_traffic
    return loss, metrics


def head_loss(h: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
              ctx: ModelContext):
    """The CE of the final hidden states ``h`` through ``head`` (this
    rank's ``lm_head`` under ``ctx``) against ``labels``, chunked
    (:func:`chunked_ce`), as :func:`lm_loss` and the encoder-decoder's loss
    take it: under :func:`vocab_parallel` through this rank's shard
    (``h`` entering whole), under :func:`tensor_parallel` alone over
    this rank's stripe.  Returns (loss, {"loss", "tokens"})."""
    tp, vocab = tensor_parallel(ctx), vocab_parallel(ctx)
    chunk = _ce_chunk
    if vocab:
        h = (dcomm.all_gather_seq(h, ctx.ep_group) if tp
             else dcomm.copy_to_group(h, ctx.ep_group))
        chunk = lambda hx, hd, lx: _vocab_ce_chunk(
            hx, hd, lx, ctx.ep_group, vocab_dim(ctx, "lm_head"))
    elif tp:
        labels = seq_stripe(labels, ctx.ep_group)
    _own_vocab(head, "lm_head", ctx)
    tot, cnt = chunked_ce(h, head.to(ctx.compute_dtype), labels, chunk)
    if tp and not vocab:
        tot, cnt = dcomm.sum_forward(torch.stack([tot, cnt]), ctx.ep_group)
    loss = tot / cnt.clamp_min(1.0)
    return loss, {"loss": loss.detach(), "tokens": cnt}


def _blocks(tree, blk: int, n: int, cd: torch.dtype) -> list:
    """The stream blocks of a stacked (n, ...) parameter tree, float leaves
    in ``cd``: each leaf split once into blocks of ``blk`` layers
    (``torch.split``), so that the backward assembles each stacked gradient
    with one concatenation, not one zero-filled gradient of the whole stack
    per block."""
    if isinstance(tree, dict):
        subs = {k: _blocks(v, blk, n, cd) for k, v in tree.items()}
        return [{k: v[j] for k, v in subs.items()} for j in range(n // blk)]
    parts = torch.split(tree, blk) if blk < n else (tree,)
    return [p.to(cd) if p.is_floating_point() else p for p in parts]


def _stream_block(ctx: ModelContext) -> int:
    """Layers per stream block: ``max(1, moe_stream)``, which must divide
    the depth; all of them with an engine that does not stream."""
    L, blk = ctx.cfg.n_layers, max(1, ctx.moe_stream)
    if L % blk != 0:
        raise ValueError(
            f"moe_stream={ctx.moe_stream} must divide n_layers={L} "
            "(every stream block needs the same static slice geometry)")
    return blk if ctx.dcfg.engine == "fused_pipe" else L


def _tx_stack(params, h: torch.Tensor, positions: torch.Tensor,
              ctx: ModelContext, traffic=None, traffic_mask=None,
              return_kv: bool = False):
    """moe_tx stack over this rank's stripe of the sequence (the
    reference's ``_tx_stack``, lm.py:301-355): with the ``fused_pipe``
    engine the layers grouped into stream blocks of ``max(1, moe_stream)``,
    one streamed ``stream_tx_layers`` call each, ``ctx.moe_interleave``
    lanes round-robin through it; with the other engines one
    call of all layers with per-layer barriers (blocks change nothing
    there).  ``traffic``: the layer-stacked state, each block threading its
    slice.  Returns the final-normed (B, S, d), the new traffic (None
    without) and, with ``return_kv`` (prefill), the per-layer gathered k/v
    stacks (L, B, S, Hkv, hd), each block writing its layers into one
    preallocated pair (None without: training keeps no k/v stack)."""
    cfg, cd = ctx.cfg, ctx.compute_dtype
    L = cfg.n_layers
    blk = _stream_block(ctx)
    h = seq_stripe(h, ctx.ep_group)
    mask = None if traffic_mask is None else seq_stripe(traffic_mask,
                                                        ctx.ep_group)
    kv = None
    if return_kv and blk < L:
        shape = (L, h.shape[0], positions.shape[0], cfg.n_kv_heads, cfg.hd)
        kv = tuple(torch.empty(shape, dtype=cd, device=h.device)
                   for _ in range(2))
    trs = []
    for j, bp in enumerate(_blocks(params["layers"], blk, L, cd)):
        b0 = j * blk
        out = stream_tx_layers(
            h, bp["moe"], bp["attn"], bp["ln1"], bp["ln2"],
            placement=ctx.placement, dcfg=ctx.dcfg, top_k=cfg.moe.top_k,
            positions=positions, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.hd, rope_theta=cfg.rope_theta,
            norm_topk=cfg.moe.norm_topk, interleave=ctx.moe_interleave,
            traffic=(None if traffic is None
                     else traffic_lib.layers(traffic, slice(b0, b0 + blk))),
            traffic_decay=ctx.traffic_decay, traffic_mask=mask,
            return_kv=return_kv,
            kv_out=None if kv is None else tuple(t[b0:b0 + blk] for t in kv),
            group=ctx.ep_group, stats_group=stats_group(ctx),
            fsdp=fsdp_group(ctx))
        if not isinstance(out, tuple):
            out = (out,)
        h = out[0]
        if traffic is not None:
            trs.append(out[1])
        if return_kv and kv is None:
            kv = out[-1]
    h = all_gather_seq(h, ctx.ep_group)
    return (rms_norm(h, params["final_norm"].to(cd)),
            traffic_lib.concat(trs) if trs else None, kv)


def _ffn_stack(params, h: torch.Tensor, ctx: ModelContext, traffic=None,
               traffic_mask=None):
    """moe_ffn stack over this rank's stripe of the sequence (the
    reference's lm.py:397-438): with the ``fused_pipe`` engine the layers
    grouped into cross-layer stream blocks of ``max(1, moe_stream)``, one
    streamed ``stream_moe_layers`` call each, ``ctx.moe_interleave`` lanes
    round-robin through it (their last tails landed in the block's
    epilogue); with the other engines one call of all layers with
    per-layer barriers (blocks change nothing there).  ``traffic``: the
    layer-stacked state, each block threading its slice.  Returns the
    final-normed (B, S, d) and the new traffic (None without); the stack
    keeps no cache."""
    cfg, cd = ctx.cfg, ctx.compute_dtype
    L = cfg.n_layers
    blk = _stream_block(ctx)
    h = seq_stripe(h, ctx.ep_group)
    mask = None if traffic_mask is None else seq_stripe(traffic_mask,
                                                        ctx.ep_group)
    trs = []
    for j, bp in enumerate(_blocks(params["layers"], blk, L, cd)):
        b0 = j * blk
        out = stream_moe_layers(
            h, bp["moe"], bp["ln1"], placement=ctx.placement, dcfg=ctx.dcfg,
            top_k=cfg.moe.top_k, norm_topk=cfg.moe.norm_topk,
            interleave=ctx.moe_interleave,
            traffic=(None if traffic is None
                     else traffic_lib.layers(traffic, slice(b0, b0 + blk))),
            traffic_decay=ctx.traffic_decay, traffic_mask=mask,
            group=ctx.ep_group, stats_group=stats_group(ctx),
            fsdp=fsdp_group(ctx))
        if traffic is None:
            h = out
        else:
            h, tr = out
            trs.append(tr)
    h = all_gather_seq(h, ctx.ep_group)
    return (rms_norm(h, params["final_norm"].to(cd)),
            traffic_lib.concat(trs) if trs else None)


def _length(n: int, device) -> torch.Tensor:
    """A () int32 length on ``device``, filled there (a tensor made from a
    host value would copy it over and wait for the card)."""
    return torch.full((), n, dtype=torch.int32, device=device)


def _serves_whole(ctx: ModelContext) -> None:
    """Prefill and decode read whole attention and MLP weights and a whole
    vocab pair (the reference's TP is off there, lm.py:826, and its serve
    applies no specs); a TP context's tree holds shards of them, a
    training context's over a model group shards of the vocab pair.
    Serving over a grid splits the batch rows over the data group
    (:func:`data_rows`) and runs the EP exchange over the model group; TP
    and the vocab split stay training's."""
    if tensor_parallel(ctx) or vocab_parallel(ctx):
        raise NotImplementedError(
            "prefill / decode on a training context split over its model "
            "group: build the serving context with explicit_tp=False and "
            "split_vocab=False (whole attention, MLP and vocab pair on each "
            "rank; the batch rows split over the data group)")


def prefill(params, inputs: torch.Tensor, positions: torch.Tensor,
            ctx: ModelContext, max_len: int, traffic=None, traffic_mask=None):
    """Full-sequence forward over (B, S) tokens, or (B, S, d) embeddings
    at (3, S) positions (the vlm's); returns the last position's
    logits (B, V) in float32 and the decode state with every layer's RoPE'd
    k and v in its cache (the last ``cap`` positions, at slot p % cap; no
    cache for moe_ffn, which is stateless, nor for ssm), every layer's SSD
    state and last conv inputs (ssm, hybrid; S a multiple of the SSD's
    chunk, else ValueError) and the length S as a () tensor.
    In an EP group each rank runs the MoE on its stripe of the sequence (S
    must split evenly) and all ranks return the same result.  On a grid
    with D data ranks ``inputs`` is the global batch, and each rank runs
    and returns only its rows of it (:func:`data_rows`; D must divide B,
    else ValueError, as the reference's islands need), so its EP group
    routes those rows alone and the traffic counts sum over the grid once
    a row.  ``traffic``:
    the layer-stacked ``traffic.TrafficState`` threaded through the MoE
    layers (the MoE families); then returns ``(logits, state,
    new_traffic)``.  ``traffic_mask``: (B, S) bool, True for real tokens
    (the global batch's, cut like ``inputs``): the serving engines pass it
    so that left-pad positions do not count."""
    cfg, cd = ctx.cfg, ctx.compute_dtype
    _traffic_needs_moe(cfg, traffic)
    _serves_whole(ctx)
    b, n = inputs.shape[0], data_size(ctx)
    if b % n:
        raise ValueError(f"a prefill batch of {b} rows does not split over "
                         f"{n} data ranks")
    rows = data_rows(ctx, b)
    inputs = inputs[rows]
    if traffic_mask is not None:
        traffic_mask = traffic_mask[rows]
    h = inputs.to(cd) if inputs.dim() == 3 else params["embed"].to(cd)[inputs]
    s = h.shape[1]
    cap = _kv_capacity(cfg, max_len)
    if cfg.family in SSM_FAMILIES:
        h, kv, ssm = _whole_stack(params, h, positions, ctx, cap)
        logits = (h[:, -1] @ params["lm_head"].to(cd)).float()
        return logits, DecodeState(kv, _length(s, h.device), ssm)
    if cfg.family == "moe_ffn":
        h, new_traffic = _ffn_stack(params, h, ctx, traffic, traffic_mask)
        logits = (h[:, -1] @ params["lm_head"].to(cd)).float()
        state = DecodeState(None, _length(s, h.device))
        return (logits, state) if traffic is None else (logits, state,
                                                        new_traffic)
    if cfg.family == "moe_tx":
        h, new_traffic, (k, v) = _tx_stack(params, h, positions, ctx, traffic,
                                           traffic_mask, return_kv=True)
        logits = (h[:, -1] @ params["lm_head"].to(cd)).float()
        state = DecodeState({"k": _cache_slots(k, s, cap),
                             "v": _cache_slots(v, s, cap)},
                            _length(s, h.device))
        return (logits, state) if traffic is None else (logits, state,
                                                        new_traffic)
    ks, vs, trs = [], [], []
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i, cd)
        if traffic is None:
            h, k, v = _seq_layer(h, lp, positions, ctx)
        else:
            h, k, v, tr = _seq_layer(h, lp, positions, ctx,
                                     traffic_lib.layers(traffic, i),
                                     traffic_mask)
            trs.append(tr)
        ks.append(_cache_slots(k, s, cap))
        vs.append(_cache_slots(v, s, cap))
    h = rms_norm(h, params["final_norm"].to(cd))
    logits = (h[:, -1] @ params["lm_head"].to(cd)).float()
    state = DecodeState({"k": torch.stack(ks), "v": torch.stack(vs)},
                        _length(s, h.device))
    return (logits, state) if traffic is None else (
        logits, state, traffic_lib.stack(trs))


def decode_step(params, state: DecodeState, inputs: torch.Tensor,
                ctx: ModelContext, max_len: int):
    """One-token decode for the rows of ``state``: this rank's rows on a
    grid (:func:`init_decode_state`, :func:`prefill`; every row where the
    data ranks do not divide the batch, each data rank then computing the
    same rows).  inputs: (B,) int tokens of those rows, or their (B, 1, d)
    embeddings.
    Returns (logits (B, V) float32, the state).  ``state.length`` is () (a
    lock-step batch) or (B,) (a slot pool: each row RoPE-rotates, writes its
    cache and masks at its own position); the positions come from it on the
    device, with nothing read to the host.  The caches in ``state.kv`` and
    ``state.length`` are written in place, so the returned state holds the
    same tensors (fixed tensors a captured graph could replay), and so are
    the SSD states and conv inputs in ``state.ssm``.  Per family (the
    reference's lm.py:666-733): dense, vlm and moe run attention, then the MLP
    or the MoE on h + attn; moe_tx the parallel block, both reading h;
    moe_ffn ``h + moe(ln1 h)``, with no cache; ssm ``h + mamba2(ln1 h)``
    by its recurrent step; hybrid the Hymba mixer's step (each SWA layer's
    slots older than the window masked) then the MLP."""
    cfg, cd = ctx.cfg, ctx.compute_dtype
    _serves_whole(ctx)
    h = (inputs.to(cd) if inputs.dim() == 3
         else params["embed"].to(cd)[inputs][:, None, :])
    b = h.shape[0]
    pos = state.length
    positions = pos[:, None] if pos.dim() == 1 else pos[None]   # (B, 1) / (1,)
    if cfg.mrope_sections:       # every M-RoPE row at the decode position
        positions = positions.expand(3, *positions.shape)
    if cfg.family in SSM_FAMILIES:
        for i, lp in enumerate(_unstack(params["layers"], cd)):
            x = rms_norm(h, lp["ln1"])
            st = SsmState(state.ssm["state"][i], state.ssm["conv"][i])
            if cfg.family == "ssm":
                y, new = mamba2_mixer(x, lp["ssm"], state=st,
                                      single_step=True, **_mixer_args(ctx))
                h = h + y
            else:
                cache = KVCache(state.kv["k"][i], state.kv["v"][i], pos,
                                max_len)
                mix, _, new = _hymba(x, lp, positions, ctx, i,
                                     attn_cache=cache, ssm_state=st,
                                     single_step=True)
                h = h + mix
                h = h + _mlp(rms_norm(h, lp["ln2"]), lp["mlp"])
            st.ssd.copy_(new.ssd)
            st.conv.copy_(new.conv)
        h = rms_norm(h, params["final_norm"].to(cd))
        logits = (h[:, 0] @ params["lm_head"].to(cd)).float()
        pos += 1
        return logits, state
    moe = lambda x, mp: moe_decode_block(
        x, mp, placement=ctx.placement, dcfg=ctx.dcfg, top_k=cfg.moe.top_k,
        norm_topk=cfg.moe.norm_topk, group=ctx.ep_group,
        fsdp=fsdp_group(ctx))
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i, cd)
        x = rms_norm(h, lp["ln1"])
        if not has_attention(cfg):
            h = h + moe(x, lp["moe"])
            continue
        q, k, v = _attn_qkv(x, lp["attn"], cfg, positions)
        cache = cache_update(KVCache(state.kv["k"][i], state.kv["v"][i], pos,
                                     max_len), k, v)
        mix = decode_attention(q, cache).reshape(
            b, 1, cfg.n_heads * cfg.hd) @ lp["attn"]["wo"]
        if cfg.family != "moe_tx":   # sequential block: the FFN reads h + attn
            h, mix = h + mix, 0
        x = rms_norm(h, lp["ln2"])
        y = _mlp(x, lp["mlp"]) if has_mlp(cfg) else moe(x, lp["moe"])
        h = h + mix + y              # moe_tx: the parallel block, both read h
    h = rms_norm(h, params["final_norm"].to(cd))
    logits = (h[:, 0] @ params["lm_head"].to(cd)).float()
    pos += 1
    return logits, state
