"""Training entry point (port of the core loop of ``repro/launch/train.py``): a
few AdamW steps of next-token loss through the FUSCO shuffle, on one card,
over an expert-parallel group of cards, or over a (data, model) grid of
them (``launch/mesh.py``).

``python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b --layers 4
--batch 4 --seq 512 --steps 8 --engine fused_flat --data zipf``

``python -m repro_torch.launch.train --arch moe-tx-stream --engine fused_pipe
--moe-stream 16 --batch 4 --seq 512 --steps 8``

``python -m repro_torch.launch.train --arch moe-ffn-stream --engine fused_pipe
--moe-stream 16 --batch 4 --seq 512 --steps 8`` (the attention-free MoE
chain, each block of layers one cross-layer stream)

``python -m repro_torch.launch.train --arch moe-ffn-stream --engine fused_pipe
--moe-stream 16 --moe-interleave 2 --accum 2 --batch 4 --seq 512 --steps 8``
(two micro-batch lanes round-robin through each stream block, the two
accumulation micro-batches fused into them: one loss call a step)

``python -m repro_torch.launch.train --arch qwen3-1.7b --batch 4 --seq 512
--steps 8`` (the dense family: no MoE, so the engine flags are ignored)

``python -m repro_torch.launch.train --arch hymba-1.5b --batch 4 --seq 512
--steps 8`` and ``--arch mamba2-2.7b --layers 16`` (the hybrid and ssm
families: no MoE either; ``--seq`` a multiple of the SSD chunk, 256 at full
width, 8 reduced; one card or a data group, no model group)

The vlm and encdec families (``qwen2-vl-7b``, ``seamless-m4t-large-v2``)
take embedding batches that the token data sources here cannot make, so
``main`` and ``run`` refuse them (:func:`refuse_untrainable`), where the
reference's ``train.main`` fails on both; they train through
``launch.steps.make_train_step`` on ``models.zoo.make_smoke_batch``
batches.

``--engine`` takes ``fused_hier`` (the default, as the reference's),
``fused_flat`` (``--dedup``: the condensed wire), ``fused_pipe``, ``ragged``
and ``disagg``; ``--calibrate`` measures the pipe constants that choose
fused_pipe's slice count and prints the table it applies.  ``--moe-stream
N`` groups the moe_tx layers into stream blocks of N (fused_pipe streams
each block's MoE tails across its attention) or the moe_ffn layers (each
block's combine in flight into the next layer's prologue);
``--moe-interleave K`` splits each rank's batch into K micro-batch lanes
round-robin through each fused_pipe block.  The online traffic statistics
(``core/traffic.py``) ride every step of the MoE families, as the reference
threads them ("stats are collected either way"), and feed ``fused_hier``'s
Algorithm 1; serial accumulation (``--accum`` > 1) runs without them.
``--accum`` equal to ``--moe-interleave`` on a moe_ffn or moe_tx stream
through fused_pipe is not serial: the micro-batches are the stream's lanes
(``steps.accum_fuses_into_stream``), the traffic rides, and each data rank
keeps its plain rows (:func:`data_rows` at ``accum = 1``).

``--relayout-every N`` re-lays the experts out after every N-th step
(:func:`apply_relayout`, the reference's): a ``core/relayout.TablePlacement``
solved from the traffic EMA's expert loads summed over the layers, the
expert weights and their AdamW mu, nu and master migrated onto it (each
slot the replica mean of its expert's old copies), the EMAs measured per
lane restarted cold, and the model and the train step rebuilt for the new
placement; the loss at fixed parameters is unchanged.  It needs the traffic
statistics, so under serial accumulation the placement stays as it is.

``python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b --layers 4
--batch 4 --seq 512 --steps 8 --engine fused_flat --relayout-every 4``

Runs on the card (``cuda``); ``run(args, device="cpu")`` runs the plain
path, ``run(args, device, ep_group=g)`` over an initialised EP group, and
``run(args, device, mesh=m)`` over a grid.  Weights are random; the batches
come from the reference's synthetic streams (``--data zipf``: the 2-gram
Zipf language; ``uniform``: hash tokens), deterministic in (seed, step);
weights and batches come from seed 0.  On a grid every rank draws the whole
global batch (``--batch`` rows) and keeps its data rank's rows
(:func:`data_rows`); ``--seq-migrate`` first rebalances whole sequences
across the data ranks (``core/commplan.plan_sequence_migration`` on each
sequence's count of distinct tokens, as the reference), which acts only with
more than one data rank.  Over a model group (the EP group, or a grid's)
the dense and moe families train with Megatron-SP tensor parallelism, as
the reference's default (``models/lm.tensor_parallel``: attention
head-sharded, the dense MLP column/row-split, the residual stream a stripe
of the sequence between blocks), and with plain data parallelism over a
grid's data group.  Every family training over a model group holds
``embed`` and ``lm_head`` split over it (``models/lm.vocab_parallel``: the
vocab, or d where the group does not divide the vocab; the reference's
specs), with the vocab-parallel CE.  The first ``WARMUP`` steps (which
also build the kernels) are not timed; each timed step ends in
``torch.cuda.synchronize()``.  ``--layers N`` cuts depth only.

``--engine auto`` (moe family) lets the comm-path policy pick fused_flat or
fused_hier per layer: at each ``--relayout-every`` boundary, before the
swap, ``core/commplan.plan_paths`` prices both paths from the traffic
measured under the retiring placement and the new context carries the
per-layer choice (``ModelContext.engines``); until the first plan every
layer runs fused_hier.  Another family falls back to fused_hier, as the
reference.

The steps run through the fault-tolerant loop
(``runtime/fault_tolerance.run_training``): with ``--ckpt-dir`` a
step-atomic checkpoint every ``--ckpt-every`` steps and at the last, in the
reference's layout (``checkpoint/checkpointer.py``), a restart from the
last committed step on a failure (``--inject-failure-at N`` injects one),
and a resume at start-up when the directory holds one.  Two sidecars beside
the checkpoints make a resume after relayouts exact: the placement history
(:func:`save_placement_history`, written at each swap: a restored step
re-establishes the table its weights were saved in) and the traffic EMA
(:func:`save_traffic_state`, at the checkpoint cadence).  Unlike the
reference, no ``--ckpt-dir`` means no checkpoints (a full-width save is
tens of GB).  Resume a run by giving the same command again:

``python -m repro_torch.launch.train --arch moe-ffn-stream --layers 1
--engine fused_flat --relayout-every 2 --steps 6 --ckpt-dir DIR
--ckpt-every 2``
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import checkpointer
from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.core import calibrate, commplan, dcomm, relayout
from repro_torch.core import traffic as traffic_lib
from repro_torch.data.pipeline import SyntheticLM, ZipfNgramLM, to_device
from repro_torch.launch import steps
from repro_torch.launch.mesh import HostMesh, make_host_mesh
from repro_torch.models import lm, zoo
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import RunConfig, run_training

WARMUP = 2        # untimed steps before the clock starts
SEED = 0


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-moe-30b-a3b")
    ap.add_argument("--reduced", action="store_true",
                    help="the reference's tiny smoke-test dims")
    ap.add_argument("--engine", default="fused_hier",
                    choices=["fused_flat", "fused_pipe", "fused_hier",
                             "disagg", "ragged", "auto"],
                    help="the dComm engine of the MoE shuffle, or 'auto': "
                         "the comm-path policy picks fused_flat or "
                         "fused_hier per layer at each relayout boundary "
                         "(moe family; needs --relayout-every)")
    ap.add_argument("--dedup", action="store_true",
                    help="dispatch-side dedup: one wire row per distinct "
                         "(token, dest lane), expanded on the landing lane "
                         "(the fused_flat engine)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to its first N layers (depth only)")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--data", default="zipf", choices=["zipf", "uniform"])
    ap.add_argument("--capacity-factor", type=float, default=2.0)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--seq-migrate", action="store_true",
                    help="sequence migration: rebalance whole sequences "
                         "across data ranks per batch (LPT over each "
                         "sequence's count of distinct tokens), with the "
                         "rows and bytes moved counted")
    ap.add_argument("--pipe-slices", type=int, default=0,
                    help="fused_pipe slice count; 0 = auto via pipesim")
    ap.add_argument("--moe-stream", type=int, default=0,
                    help="moe_tx and moe_ffn families: layers per stream "
                         "block (fused_pipe carries each layer's MoE tail "
                         "across the attention block, or into the next "
                         "layer's prologue, inside a block); 0 = one layer "
                         "a block")
    ap.add_argument("--moe-interleave", type=int, default=1,
                    help="moe_tx and moe_ffn families: token micro-batch "
                         "lanes round-robin through each fused_pipe stream "
                         "block (lane j+1's compute fills lane j's boundary "
                         "window); must divide each rank's batch; equal to "
                         "--accum, the accumulation micro-batches are the "
                         "lanes; 1 = the plain stream")
    ap.add_argument("--relayout-every", type=int, default=0,
                    help="MoE families: every N steps, re-solve the expert "
                         "placement from the online EMA traffic stats and "
                         "migrate the expert weight blocks and their AdamW "
                         "state (0 = static placement); stats are collected "
                         "either way")
    ap.add_argument("--fsdp-experts", default="auto",
                    choices=["auto", "on", "off"],
                    help="split the expert weights' f dim over the data "
                         "group (ZeRO-3 of the experts); auto: the "
                         "reference's rule, on past 4 GB of one lane's "
                         "expert weights")
    ap.add_argument("--traffic-decay", type=float, default=0.99,
                    help="EMA decay of the online traffic statistics")
    ap.add_argument("--calibrate", action="store_true",
                    help="measure the pipe stage/wire/overhead constants on "
                         "the running device before building the context "
                         "(replaces the H100 spec-point defaults)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: no checkpoints)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)
    if args.steps <= WARMUP:
        ap.error(f"--steps must exceed the {WARMUP} warm-up steps")
    return args


class Setup(NamedTuple):
    cfg: ArchConfig
    ctx: lm.ModelContext
    params: dict
    source: object            # batch_at(step) -> host batch
    opt_cfg: adamw.AdamWConfig


def _is_rank0() -> bool:
    return not (dist.is_available() and dist.is_initialized()) or (
        dist.get_rank() == 0)


def refuse_untrainable(arch: str) -> None:
    """ValueError for a family whose batches the token data sources cannot
    make (``zoo.EMBED_INPUTS``; the reference's ``train.main`` fails on
    both, train.py:369-370: encdec's loss asks for frames, and the vlm's
    1-D positions leave M-RoPE's temporal row a scalar): train those
    through ``steps.make_train_step`` on ``zoo.make_smoke_batch``
    batches."""
    family = get_arch(arch).family
    if family in zoo.EMBED_INPUTS:
        raise ValueError(
            f"train.main / train.run cannot train {arch}: the {family} "
            f"family's batches hold {zoo.EMBED_INPUTS[family]}, and the data "
            "sources yield tokens only (the reference's train.main fails on "
            "it too); drive "
            "launch.steps.make_train_step on models.zoo.make_smoke_batch "
            "batches instead")


def setup(args, device="cuda", ep_group=None,
          mesh: HostMesh | None = None) -> Setup:
    """The model, its random bf16 parameters (this rank's lane of the expert
    weights over ``ep_group``, or over its EP group of ``mesh``), the data
    source of the global batch and the optimizer's config of a train run,
    all from seed 0: every rank draws the same replicated leaves and reads
    the same global batches.  Raises ValueError for the vlm and encdec
    families (:func:`refuse_untrainable`)."""
    refuse_untrainable(args.arch)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    calibration = None
    if args.calibrate and cfg.moe is not None:
        calibration = calibrate.calibrate(device=device)
        if _is_rank0():
            print(f"[calibrate] {calibration.platform}: "
                  f"stage {calibration.stage_bw / 1e9:.1f} GB/s, "
                  f"wire {calibration.wire_bw / 1e9:.1f} GB/s, "
                  f"overhead {calibration.overhead_s * 1e6:.1f} us",
                  flush=True)
    ep = dcomm.group_size(ep_group if mesh is None else mesh.ep_group)
    if args.engine == "auto" and cfg.family != "moe" and _is_rank0():
        print(f"[commplan] --engine auto needs per-layer MoE islands "
              f"(family {cfg.family!r}); falling back to fused_hier",
              flush=True)
    ctx = lm.make_context(cfg, device, ep_group=ep_group, mesh=mesh,
                          engine=base_engine(args),
                          capacity_factor=args.capacity_factor,
                          node_size=max(1, ep // 2), dedup=args.dedup,
                          pipe_slices=args.pipe_slices,
                          moe_stream=args.moe_stream,
                          moe_interleave=args.moe_interleave,
                          traffic_decay=args.traffic_decay,
                          calibration=calibration,
                          fsdp_experts={"auto": None, "on": True,
                                        "off": False}[args.fsdp_experts])
    # resuming a run that relayouted: the checkpoint's weights are laid out
    # by the placement history, not the arithmetic map (the reference's
    # train.py:269-279)
    history = (None if cfg.moe is None
               else load_placement_history(args.ckpt_dir, cfg.moe.n_experts))
    committed = checkpointer.latest_step(args.ckpt_dir)
    if history is not None and committed is not None:
        ctx = dataclasses.replace(
            ctx, placement=placement_at_step(history, committed))
        if _is_rank0():
            print(f"[relayout] resuming with the placement active at "
                  f"committed step {committed}", flush=True)
    params = lm.init_params(
        cfg, ctx, torch.Generator(device=ctx.device).manual_seed(SEED))
    src_cls = ZipfNgramLM if args.data == "zipf" else SyntheticLM
    source = src_cls(cfg.vocab, args.seq, args.batch, seed=SEED)
    opt_cfg = adamw.AdamWConfig(lr=args.lr,
                                warmup_steps=max(5, args.steps // 20),
                                total_steps=args.steps)
    return Setup(cfg, ctx, params, source, opt_cfg)


def base_engine(args) -> str:
    """The engine every MoE layer runs until the comm-path policy's first
    plan (``--engine auto``: fused_hier), else ``--engine``."""
    return "fused_hier" if args.engine == "auto" else args.engine


def serial_accum(model: zoo.ModelBundle, accum: int) -> int:
    """The micro-batches a step of ``model`` accumulates serially: 1 when
    there are none, or when they are fused into the stream's lanes
    (``steps.accum_fuses_into_stream``), else ``accum``."""
    return 1 if steps.accum_fuses_into_stream(model, accum) else accum


def init_traffic(cfg: ArchConfig, ctx: lm.ModelContext, accum: int):
    """The cold layer-stacked traffic state a run threads through its steps
    (the reference's train.py:296-326): for the MoE families (moe, moe_tx,
    moe_ffn), unless the micro-batches accumulate serially
    (:func:`serial_accum`), which do not thread one."""
    if cfg.moe is None:
        return None
    if serial_accum(zoo.build(cfg, ctx), accum) > 1:
        if _is_rank0():
            print("[traffic] stats disabled under serial gradient "
                  "accumulation", flush=True)
        return None
    return traffic_lib.init_traffic_state(cfg.moe.n_experts, ctx.placement.ep,
                                          n_layers=cfg.n_layers,
                                          device=ctx.device)


def data_rows(b: int, dp: int, d: int, accum: int = 1) -> np.ndarray:
    """The rows of a global batch of ``b`` that data rank ``d`` of ``dp``
    holds: ``[d * b / dp, (d + 1) * b / dp)``; under ``accum`` serial
    micro-batches its share of each micro-batch in turn (micro-batch j is
    the global rows ``[j * b / accum, (j + 1) * b / accum)``, as the
    reference splits its global batch), so that its j-th local micro-batch
    is its share of the reference's j-th."""
    if b % (dp * accum):
        raise ValueError(f"a batch of {b} does not split over {dp} data "
                         f"ranks x {accum} micro-batches")
    m, k = b // accum, b // (accum * dp)
    return np.concatenate([np.arange(j * m + d * k, j * m + (d + 1) * k)
                           for j in range(accum)])


def shard_batch(host: dict, dp: int, d: int, accum: int = 1,
                seq_migrate: bool = False) -> tuple[dict, dict]:
    """Data rank ``d``'s rows (:func:`data_rows`) of the global host batch
    (numpy arrays, one row a sequence), and the migration's stats ({"rows_moved", "bytes_moved"}): with
    ``seq_migrate`` and more than one data rank the rows are first permuted
    by ``commplan.plan_sequence_migration`` (the reference's train.py:381-400:
    each sequence's load is its count of distinct tokens)."""
    moved = {"rows_moved": 0, "bytes_moved": 0}
    if seq_migrate and dp > 1:
        loads = np.array([np.unique(row).size for row in host["tokens"]],
                         np.float64)
        row_bytes = sum(v[0].nbytes for v in host.values())
        perm, stats = commplan.plan_sequence_migration(loads, dp,
                                                       row_bytes=row_bytes)
        host = {k: v[perm] for k, v in host.items()}
        moved = {k: stats[k] for k in moved}
    rows = data_rows(len(host["tokens"]), dp, d, accum)
    return {k: v[rows] for k, v in host.items()}, moved


# the expert leaves' names under layers/moe (lm.EXPERT_LEAVES)
MOE_WEIGHTS = tuple(path.rsplit("/", 1)[1] for path in lm.EXPERT_LEAVES)


class _Cut(NamedTuple):
    """The ZeRO-1 cut of a rank's leaf (``adamw.zero_dim``): its dim (None:
    whole) and the data rank's share of it."""
    dim: int | None
    dp: int
    d: int

    def span(self, dim: int, n: int) -> range:
        """The indices this rank holds of ``dim``, of size ``n`` uncut."""
        if self.dim != dim:
            return range(n)
        k = n // self.dp
        return range(self.d * k, (self.d + 1) * k)

    def apply(self, shape: tuple) -> tuple:
        return tuple(len(self.span(i, n)) for i, n in enumerate(shape))


_WHOLE = _Cut(None, 1, 0)


def _migrate_leaf(t: torch.Tensor, old, new, lanes: range, cut_old: _Cut,
                  cut_new: _Cut, whole_new: tuple, group, mult: int):
    """The re-layout of one expert leaf on this rank, layer by layer: the
    slots it holds (``lanes``, cut by ``cut_old`` of the rank's lane-held
    leaf) index-added into a zeroed float32 canonical (n_experts, ...) block,
    summed over ``group`` (the ranks holding distinct slots of that block;
    None: this rank holds them all), divided by each expert's replica count
    times ``mult`` (the ranks of ``group`` holding each slot), then the new
    placement's slots cut by ``cut_new`` of the rank's new lane-held shape
    ``whole_new`` taken from it.  Without a group and without replicas a
    plain gather of each layer's rows.  Writes into ``t`` when its shape
    stays, else into a new tensor; returns the one written."""
    dev = t.device
    n_layers, rest = whole_new[0], whole_new[3:]
    so = cut_old.span(2, old.experts_per_lane)
    sn = cut_new.span(2, new.experts_per_lane)
    lo, ln = cut_old.span(0, n_layers), cut_new.span(0, n_layers)
    shape_new = cut_new.apply(whole_new)
    out = t if tuple(t.shape) == shape_new else torch.empty(
        shape_new, dtype=t.dtype, device=dev)
    counts = relayout.replica_counts(old)
    if group is None and cut_old == cut_new == _WHOLE and counts.max() == 1:
        idx = relayout.migration_gather_index(old, new, dev).long()
        for i in range(n_layers):
            rows = t[i].reshape(-1, *t.shape[3:]).index_select(0, idx)
            out[i].copy_(rows.view(out[i].shape))
        return out
    pick = lambda p, s: torch.as_tensor(
        relayout.placement_table(p)[lanes.start:lanes.stop,
                                    s.start:s.stop].reshape(-1),
        dtype=torch.long, device=dev)
    ids_old, ids_new = pick(old, so), pick(new, sn)
    div = torch.as_tensor(counts * mult, dtype=torch.float32, device=dev)
    div = div.reshape((-1,) + (1,) * len(rest))

    def part(canon, cut):          # the canonical block's rest dims under cut
        if cut.dim is not None and cut.dim >= 3:
            span = cut.span(cut.dim, whole_new[cut.dim])
            return canon.narrow(cut.dim - 2, span.start, len(span))
        return canon

    for i in range(n_layers):
        canon = torch.zeros((old.n_experts, *rest), dtype=torch.float32,
                            device=dev)
        if i in lo:
            src = t[i - lo.start]
            part(canon, cut_old).index_add_(
                0, ids_old, src.reshape(-1, *src.shape[2:]).float())
        if group is not None:
            dist.all_reduce(canon, group=group)
        canon.div_(div)
        if i in ln:
            dst = out[i - ln.start]
            dst.copy_(part(canon, cut_new).index_select(0, ids_new).view(
                dst.shape))
    return out


def _agreed_table(table: np.ndarray, ctx: lm.ModelContext) -> np.ndarray:
    """Rank 0's table on every rank of the training world (the grid, or the
    EP group): one small all-reduce; every rank solves, rank 0's decides."""
    g = (ctx.mesh.grid if ctx.mesh is not None
         else dcomm.process_group(ctx.ep_group))
    if g is None or dist.get_world_size(g) == 1:
        return table
    t = torch.as_tensor(table if dist.get_rank(g) == 0 else 0 * table,
                        dtype=torch.int32).to(ctx.device)
    dist.all_reduce(t, group=g)
    return t.cpu().numpy()


def apply_relayout(params, opt, traffic_state, ctx: lm.ModelContext, *,
                   slots_per_lane: int | None = None, log=print):
    """Between-steps placement swap (the reference's ``apply_relayout``):
    solve a ``relayout.TablePlacement`` from the EMA expert loads (summed
    over the layers), then migrate the expert weight blocks
    (``layers/moe/{w1,w3,w2}``, the moe, moe_tx and moe_ffn families alike)
    AND their AdamW mu, nu and f32 master, so that the loss at fixed
    parameters is unchanged: only which lane hosts which expert moves.

    Each destination slot takes the replica mean of its expert's old copies
    (``relayout.migrate_lane_major``'s function, accumulated in float32).
    Over an EP group each rank holds its lane of those leaves, and on a
    (data, model) grid its ZeRO-1 slice of their state (``adamw.zero_dim``;
    under FSDP, ``lm.fsdp_group``, its slice of their f dim, parameters
    and state alike, which it moves over its EP group as a whole leaf):
    per layer and leaf, each rank index-adds its slots into a canonical
    float32 block, the block is summed over the EP group (over the whole
    grid where the state is cut on the slot axis, or its cut moves), and
    each rank takes its new slots from it (:func:`_migrate_leaf`): peak
    memory grows by one layer's block.  Every rank solves, and rank 0's
    table is the one all take (:func:`_agreed_table`).

    The train step updates parameters and AdamW state in place, so the
    migration writes into the same tensors (``copy_``), and ``params`` and
    ``opt`` are the objects passed in; a new slot count (``slots_per_lane``
    other than the old placement's) changes the leaves' shapes, and new
    tensors then replace the old ones in the same dictionaries.  The caller
    rebuilds the model and the train step for the returned context.
    Returns (params, opt, new_ctx, stats): ``relayout.migration_stats``
    plus the max-lane loads before and after, the bytes this rank rewrote,
    the host ms of the whole swap and, on the card, the device ms of the
    migration (CUDA events)."""
    t0 = time.perf_counter()
    old = ctx.placement
    loads = traffic_state.expert_ema.detach().cpu().numpy().astype(np.float64)
    if loads.ndim > 1:                     # per-layer stacked state
        loads = loads.sum(axis=0)
    solved = relayout.solve_placement(
        loads, ep=old.ep, node_size=old.node_size,
        slots_per_lane=slots_per_lane or old.experts_per_lane)
    new = relayout.TablePlacement(_agreed_table(solved.lane_expert, ctx),
                                  node_size=old.node_size,
                                  n_experts=old.n_experts)
    moe = params["layers"]["moe"]
    w1 = moe["w1"]
    d, f = w1.shape[-2], w1.shape[-1]
    row_bytes = w1.shape[0] * (2 * d * f + f * d) * w1.element_size()
    stats = relayout.migration_stats(old, new, row_bytes=row_bytes)

    lanes = lm.held_lanes(ctx)
    ep_group = (dcomm.process_group(ctx.ep_group)
                if dcomm.group_size(ctx.ep_group) > 1 else None)
    dp, di = (1, 0) if ctx.mesh is None else (ctx.mesh.data,
                                              ctx.mesh.data_index)
    grid = None if ctx.mesh is None else ctx.mesh.grid
    on_card = ctx.device.type == "cuda"
    if on_card:
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
    rewritten = 0
    with torch.no_grad():
        for name in MOE_WEIGHTS:
            p = moe[name]
            whole_old = tuple(p.shape)
            whole_new = (whole_old[0], whole_old[1], new.experts_per_lane,
                         *whole_old[3:])
            fsdp = lm.fsdp_sharded(ctx)(f"layers/moe/{name}")
            for tree in (params, opt.mu, opt.nu, opt.master):
                state = tree is not params and not fsdp
                cut = lambda shape: _Cut(adamw.zero_dim(shape, dp, True), dp,
                                         di) if state else _WHOLE
                c_old, c_new = cut(whole_old), cut(whole_new)
                if c_old == c_new and c_old.dim != 2:
                    # the EP group holds distinct slots of each block: the
                    # data rank's layers and rest dims taken as the whole
                    t = tree["layers"]["moe"][name]
                    w = (t.shape[0], t.shape[1], new.experts_per_lane,
                         *t.shape[3:])
                    out = _migrate_leaf(t, old, new, lanes, _WHOLE, _WHOLE, w,
                                        ep_group, 1)
                else:
                    out = _migrate_leaf(
                        tree["layers"]["moe"][name], old, new, lanes, c_old,
                        c_new, whole_new, grid,
                        dp if c_old.dim is None else 1)
                tree["layers"]["moe"][name] = out
                rewritten += out.numel() * out.element_size()
    if on_card:
        events[1].record()
        events[1].synchronize()
        stats["device_ms"] = events[0].elapsed_time(events[1])
    mx_old = float(relayout.lane_loads(loads, old).max())
    mx_new = float(relayout.lane_loads(loads, new).max())
    stats.update(max_lane_load=(mx_old, mx_new), rewritten_bytes=rewritten,
                 host_ms=(time.perf_counter() - t0) * 1e3)
    log(f"relayout: max-lane load {mx_old:.1f} -> {mx_new:.1f}, "
        f"{stats['rows_moved']}/{stats['slots']} expert blocks moved "
        f"({stats['bytes_moved'] / 1e6:.2f} MB)", flush=True)
    return params, opt, dataclasses.replace(ctx, placement=new), stats


def cold_lane_stats(traffic: traffic_lib.TrafficState):
    """``traffic`` with the EMAs measured per lane (send rows, the lane ->
    node matrix, condensed rows) restarted cold: after a relayout they
    describe the retired table.  The expert counts carry over."""
    return traffic._replace(
        lane_send_ema=torch.zeros_like(traffic.lane_send_ema),
        lane_node_ema=torch.zeros_like(traffic.lane_node_ema),
        lane_cond_ema=torch.zeros_like(traffic.lane_cond_ema))


# --- the placement history (relayout x checkpoint/restart) -------------------
# A checkpoint holds the expert weights in the layout active at its step;
# restoring one must re-establish that layout, or every lane applies the
# wrong experts' weights.  The sidecar records (active_from_step, table)
# pairs beside the checkpoints (the reference's train.py:49-87, the same
# .npz keys, so either side reads the other's file).

def _history_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, "placement_history.npz")


def save_placement_history(ckpt_dir: str, history, node_size: int) -> None:
    """``history``: (active_from_step, placement) pairs.  Written at every
    relayout, so that any checkpoint committed later can be re-based."""
    os.makedirs(ckpt_dir, exist_ok=True)
    np.savez(_history_path(ckpt_dir),
             steps=np.array([s for s, _ in history], np.int64),
             tables=np.stack([relayout.placement_table(p)
                              for _, p in history]),
             node_size=np.int64(node_size))


def load_placement_history(ckpt_dir: str | None, n_experts: int):
    """(active_from_step, ``relayout.TablePlacement``) pairs, or None when
    the run never relayouted (or there is no ``ckpt_dir``)."""
    if ckpt_dir is None or not os.path.exists(_history_path(ckpt_dir)):
        return None
    with np.load(_history_path(ckpt_dir)) as z:
        ns = int(z["node_size"])
        return [(int(s), relayout.TablePlacement(tbl, node_size=ns,
                                                 n_experts=n_experts))
                for s, tbl in zip(z["steps"], z["tables"])]


def placement_at_step(history, step: int):
    """The placement whose layout a checkpoint committed at ``step`` holds:
    the last history entry active from a step <= ``step``."""
    active = [p for s, p in history if s <= step]
    return active[-1] if active else history[0][1]


# --- the traffic-EMA sidecar (a warm resume of the relayout signal) ----------
# The EMA is replicated state, so a small sidecar written at the checkpoint
# cadence resumes it warm (the reference's train.py:90-133); like any EMA it
# tolerates the (at most one cadence of) staleness behind the committed step.

def _traffic_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, "traffic_ema.npz")


def save_traffic_state(ckpt_dir: str, traffic: traffic_lib.TrafficState,
                       step: int) -> None:
    """Write the EMA accumulators beside the checkpoints (synchronously:
    (L, E) and (L, EP) floats, noise beside a weight save)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    np.savez(_traffic_path(ckpt_dir), step=np.int64(step),
             **{k: v.detach().cpu().numpy()
                for k, v in traffic._asdict().items()})


def load_traffic_state(ckpt_dir: str | None, like: traffic_lib.TrafficState):
    """(TrafficState on ``like``'s device, saved step) matching ``like``'s
    shapes, or None when there is no sidecar or it holds another model's
    shapes.  A field ``like`` has and an older sidecar lacks is zero-filled
    (that accumulator restarts cold); a field present with another shape
    means another model."""
    if ckpt_dir is None or not os.path.exists(_traffic_path(ckpt_dir)):
        return None
    with np.load(_traffic_path(ckpt_dir)) as z:
        leaves = {}
        for k, want in like._asdict().items():
            if k not in z:
                leaves[k] = torch.zeros_like(want)
                continue
            if z[k].shape != tuple(want.shape):
                return None
            leaves[k] = torch.as_tensor(z[k]).to(dtype=want.dtype,
                                                 device=want.device)
        return type(like)(**leaves), int(z["step"])


def plan_engines(traffic: traffic_lib.TrafficState, ctx: lm.ModelContext,
                 args) -> list:
    """The comm-path policy's per-layer decisions (``commplan.plan_paths``)
    from ``traffic``, measured under ``ctx.placement``: one bf16 token row
    a wire row, the link costs of ``ctx.dcfg``."""
    host = traffic_lib.TrafficState(*(t.detach().cpu().numpy()
                                      for t in traffic))
    return commplan.plan_paths(
        host, ctx.placement, row_bytes=ctx.cfg.d_model * 2,
        costs=commplan.LinkCosts.from_dcomm(ctx.dcfg), dedup=args.dedup,
        default=base_engine(args))


def run(args, device="cuda", ep_group=None, mesh: HostMesh | None = None,
        keep_state: bool = False) -> dict:
    """Train ``--steps`` steps, over ``ep_group`` or ``mesh`` when given (an
    initialised process group, or the grid of ``launch.mesh``, every rank
    calling), through ``run_training`` (checkpoints with ``--ckpt-dir``,
    restarts, the sidecars), the traffic state threaded through every step
    (warm-up included).  Returns the loss of each step this process ran
    (the global batch's; a replayed step's last value) from step index
    ``first_step`` on, the ms of every executed step and their median past
    the warm-up, tokens per second (of the global batch), on the card this
    rank's peak device memory (GiB, params and optimizer state included),
    this rank's AdamW state (GiB), expert parameters (bytes: its lane,
    under FSDP its f-slice of it), ``embed`` and ``lm_head`` (bytes: its
    shards over a model group, ``lm.vocab_parallel``) and parameters
    (bytes: its TP shards under Megatron TP), the sequences and bytes
    ``--seq-migrate``
    moved, the final traffic state (None without one), each
    ``--relayout-every`` swap's stats (:func:`apply_relayout`: blocks and
    bytes moved, host ms, device ms on the card, and the step after which
    it ran), each ``--engine auto`` plan (its step and per-layer engines),
    the final placement, the engine each layer ran last (None without an
    MoE layer), the loop's
    ``RunState`` (restarts, each save's gather ms, write s and bytes, each
    restore's s) and, with ``keep_state``, the final (params, opt) as
    ``state`` and the train step of the final context (at full width tens
    of GB of the card)."""
    on_card = torch.device(device).type == "cuda"
    if on_card and torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats(device)
    cfg, ctx, params, source, opt_cfg = setup(args, device, ep_group, mesh)
    model = zoo.build(cfg, ctx)
    traffic = init_traffic(cfg, ctx, args.accum)
    opt_state = steps.init_state(model, params)
    dp, d = (1, 0) if mesh is None else (mesh.data, mesh.data_index)
    serial = serial_accum(model, args.accum)
    relayout_every = args.relayout_every if traffic is not None else 0
    if args.relayout_every and not relayout_every and _is_rank0():
        print(f"[relayout] --relayout-every {args.relayout_every} needs the "
              "traffic statistics, which this run does not thread: the "
              "placement stays static", flush=True)
    log = print if _is_rank0() else (lambda *a, **k: None)
    lay = checkpointer.context_layout(ctx)
    ckpt = args.ckpt_dir
    sidecars = ckpt is not None and lay.writer
    auto = args.engine == "auto" and cfg.family == "moe"
    if traffic is not None and checkpointer.latest_step(ckpt) is not None:
        # a warm EMA only beside a committed checkpoint: a stale sidecar of
        # a dead run must not seed a fresh one
        warm = load_traffic_state(ckpt, traffic)
        if warm is not None:
            traffic, tstep = warm
            log(f"[traffic] resumed EMA state saved at step {tstep}",
                flush=True)
    box = {"ctx": ctx, "step": steps.make_train_step(model, opt_cfg,
                                                     args.accum),
           "traffic": traffic, "n": 0, "fence": False,
           "history": [(0, ctx.placement)]}
    losses, step_s, relayouts, plans = {}, [], [], []
    moved = {"rows_moved": 0, "bytes_moved": 0}

    def rebuild(new_ctx):
        box["ctx"] = new_ctx
        box["step"] = steps.make_train_step(zoo.build(cfg, new_ctx), opt_cfg,
                                            args.accum)
        box["fence"] = True      # its first step is no measure of lane health

    def on_restart(step, restored):
        """Re-base the adaptive-placement state after a rewind (the
        reference's train.py:340-367): the relayout cadence counter rewinds
        with the replayed stream, the EMA resumes from the sidecar (else
        cold), and restored weights run under the placement active at their
        step; the per-layer engines stay as they are, as in the
        reference."""
        box["n"] = step
        if box["traffic"] is not None:
            cold = traffic_lib.init_traffic_state(
                cfg.moe.n_experts, box["ctx"].placement.ep,
                n_layers=cfg.n_layers, device=box["ctx"].device)
            warm = load_traffic_state(ckpt, cold)
            box["traffic"] = cold if warm is None else warm[0]
        if restored:
            box["history"] = ([(s, p) for s, p in box["history"] if s <= step]
                              or box["history"][:1])
            want = placement_at_step(box["history"], step)
            if want is not box["ctx"].placement:
                rebuild(dataclasses.replace(box["ctx"], placement=want))
        else:
            # the params were kept: their layout stays live
            box["history"] = [(0, box["ctx"].placement)]
        if relayout_every and sidecars:
            save_placement_history(ckpt, box["history"],
                                   box["ctx"].placement.node_size)

    def batch_at(i):
        host, m = shard_batch(source.batch_at(i), dp, d, serial,
                              args.seq_migrate)
        for k in moved:
            moved[k] += m[k]
        return to_device(host, box["ctx"].device)

    def wrapped(params, opt_state, batch):
        if on_card:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        params, opt_state, metrics = box["step"](params, opt_state, batch,
                                                 box["traffic"])
        box["traffic"] = metrics.pop("traffic", None)
        if on_card:
            torch.cuda.synchronize(device)
        step_s.append(time.perf_counter() - t0)
        loss = float(metrics["loss"])
        losses[box["n"]] = loss
        box["n"] += 1
        n = box["n"]
        if box["fence"]:
            box["fence"] = False
            metrics["straggler_fence"] = True
        if args.log_every and (len(step_s) - 1) % args.log_every == 0:
            log(f"step {n:5d}  loss {loss:.4f}  {step_s[-1]:.3f}s/step",
                flush=True)
        if relayout_every and n % relayout_every == 0:
            decisions = None
            if auto:
                # before the swap: the send matrices were measured under the
                # placement being retired
                decisions = plan_engines(box["traffic"], box["ctx"], args)
                summ = commplan.summarize_decisions(decisions)
                log(f"[commplan] step {n}: {summ['n_flat']} flat / "
                    f"{summ['n_hier']} hier layers ({summ['n_cold']} cold) — "
                    + " ".join(f"L{i}:{'F' if e == 'fused_flat' else 'H'}"
                               for i, e in enumerate(summ["per_layer"])),
                    flush=True)
                plans.append({"step": n, "engines": tuple(summ["per_layer"])})
            params, opt_state, new_ctx, stats = apply_relayout(
                params, opt_state, box["traffic"], box["ctx"], log=log)
            if decisions is not None:
                new_ctx = dataclasses.replace(
                    new_ctx, engines=tuple(x.engine for x in decisions))
            box["traffic"] = cold_lane_stats(box["traffic"])
            rebuild(new_ctx)
            relayouts.append(dict(stats, step=n))
            # active from this step on: recorded before the loop can commit
            # a checkpoint holding it
            box["history"].append((n, new_ctx.placement))
            if sidecars:
                save_placement_history(ckpt, box["history"],
                                       new_ctx.placement.node_size)
        return params, opt_state, metrics

    def on_commit(step):
        # after the step's relayout block, so that where the cadences meet
        # the sidecar holds the lane EMAs restarted for the new table
        if box["traffic"] is not None and sidecars:
            save_traffic_state(ckpt, box["traffic"], step)

    rcfg = RunConfig(total_steps=args.steps, ckpt_dir=ckpt,
                     ckpt_every=args.ckpt_every,
                     inject_failure_at=args.inject_failure_at,
                     on_restart=on_restart, on_commit=on_commit, layout=lay)
    (params, opt_state), state = run_training(wrapped, (params, opt_state),
                                              batch_at, rcfg, log=log)
    timed = (statistics.median(step_s[WARMUP:] or step_s) if step_s
             else float("nan"))    # resumed at the last step
    if args.seq_migrate and _is_rank0():
        print(f"[seqmig] {moved['rows_moved']} sequences moved "
              f"({moved['bytes_moved'] / 1e6:.2f} MB) in {args.steps} steps",
              flush=True)
    ctx = box["ctx"]
    return {"losses": [losses[i] for i in sorted(losses)],
            "first_step": min(losses, default=args.steps),
            "step_ms": [t * 1e3 for t in step_s],
            "ms_per_step": timed * 1e3,
            "tokens_per_s": args.batch * args.seq / timed,
            "peak_mem_gib": (torch.cuda.max_memory_allocated(ctx.device) / 2**30
                             if on_card else None),
            "opt_state_gib": adamw.state_bytes(opt_state) / 2**30,
            "expert_param_bytes": sum(
                t.numel() * t.element_size() for path, t in zip(
                    adamw.paths(params), adamw.leaves(params))
                if lm.lane_sharded(path)),
            "vocab_param_bytes": sum(
                params[k].numel() * params[k].element_size()
                for k in ("embed", "lm_head")),
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in adamw.leaves(params)),
            "seq_migrate": moved, "cfg": cfg, "traffic": box["traffic"],
            "relayouts": relayouts, "plans": plans,
            "placement": ctx.placement,
            "engines": ctx.engines or (None if ctx.dcfg is None
                                       else (ctx.dcfg.engine,) * cfg.n_layers),
            "run": state,
            **({"state": (params, opt_state), "train_step": box["step"]}
               if keep_state else {})}


def main(argv=None, device="cuda"):
    """The command line.  Under ``torchrun`` (``WORLD_SIZE`` > 1) the world
    is the reference's host mesh (``launch.mesh.make_host_mesh``: (1, 2) of
    two ranks, (2, 4) of eight): NCCL, one rank per card on
    ``cuda:LOCAL_RANK``, or gloo when ``device`` is the CPU.  Only rank 0
    prints; the peak memory and the AdamW state are printed for every
    rank."""
    args = parse_args(argv)
    refuse_untrainable(args.arch)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        out = run(args, device)
        return _report(out, [_held(out)])
    on_card = torch.device(device).type == "cuda"
    if on_card:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if on_card else "gloo",
                            rank=int(os.environ["RANK"]), world_size=world)
    try:
        mesh = make_host_mesh()
        if _is_rank0():
            print(f"mesh (data, model) = ({mesh.data}, {mesh.model})")
        out = run(args, device, mesh=mesh)
        mem = [None] * world
        dist.all_gather_object(mem, _held(out))
        return _report(out, mem) if _is_rank0() else out
    finally:
        dist.destroy_process_group()


def _held(out: dict) -> tuple:
    """(peak memory GiB, AdamW state GiB, expert parameter bytes, embed and
    lm_head bytes) of one rank's ``run``."""
    return (out["peak_mem_gib"], out["opt_state_gib"],
            out["expert_param_bytes"], out["vocab_param_bytes"])


def _report(out: dict, mem: list):
    """Print the losses, the speed, each rank's peak memory, AdamW state,
    expert parameter bytes and embed + lm_head bytes (``mem``, of
    :func:`_held`), and the loop's steps, restarts and straggler events."""
    print("loss per step:", " ".join(f"{x:.4f}" for x in out["losses"]))
    print(f"{out['ms_per_step']:.1f} ms/step  {out['tokens_per_s']:.0f} "
          f"tokens/s  peak memory per rank "
          + " ".join("n/a" if m[0] is None else f"{m[0]:.2f}" for m in mem)
          + " GiB  optimizer state per rank "
          + " ".join(f"{m[1]:.3f}" for m in mem) + " GiB")
    print("parameter bytes per rank: experts "
          + " ".join(str(m[2]) for m in mem) + "  embed + lm_head "
          + " ".join(str(m[3]) for m in mem))
    run = out["run"]
    print(f"done: {run.steps_run} steps, {run.restarts} restarts, "
          f"{run.straggler_events} straggler events")
    return out


if __name__ == "__main__":
    main()
