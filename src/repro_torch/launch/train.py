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
more than one data rank.  The first ``WARMUP`` steps (which also build the
kernels) are not timed; each timed step ends in
``torch.cuda.synchronize()``.  ``--layers N`` cuts depth only.
No checkpoint, relayout or fault-tolerance loop yet (ROADMAP queue 1 item 6).
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

from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.core import calibrate, commplan, dcomm
from repro_torch.core import traffic as traffic_lib
from repro_torch.data.pipeline import SyntheticLM, ZipfNgramLM, to_device
from repro_torch.launch import steps
from repro_torch.launch.mesh import HostMesh, make_host_mesh
from repro_torch.models import lm, zoo
from repro_torch.optim import adamw

WARMUP = 2        # untimed steps before the clock starts
SEED = 0


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-moe-30b-a3b")
    ap.add_argument("--reduced", action="store_true",
                    help="the reference's tiny smoke-test dims")
    ap.add_argument("--engine", default="fused_hier",
                    choices=["fused_flat", "fused_pipe", "fused_hier",
                             "disagg", "ragged"])
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
    ap.add_argument("--traffic-decay", type=float, default=0.99,
                    help="EMA decay of the online traffic statistics")
    ap.add_argument("--calibrate", action="store_true",
                    help="measure the pipe stage/wire/overhead constants on "
                         "the running device before building the context "
                         "(replaces the H100 spec-point defaults)")
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


def setup(args, device="cuda", ep_group=None,
          mesh: HostMesh | None = None) -> Setup:
    """The model, its random bf16 parameters (this rank's lane of the expert
    weights over ``ep_group``, or over its EP group of ``mesh``), the data
    source of the global batch and the optimizer's config of a train run,
    all from seed 0: every rank draws the same replicated leaves and reads
    the same global batches."""
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
    ctx = lm.make_context(cfg, device, ep_group=ep_group, mesh=mesh,
                          engine=args.engine,
                          capacity_factor=args.capacity_factor,
                          node_size=max(1, ep // 2), dedup=args.dedup,
                          pipe_slices=args.pipe_slices,
                          moe_stream=args.moe_stream,
                          moe_interleave=args.moe_interleave,
                          traffic_decay=args.traffic_decay,
                          calibration=calibration)
    params = lm.init_params(
        cfg, ctx, torch.Generator(device=ctx.device).manual_seed(SEED))
    src_cls = ZipfNgramLM if args.data == "zipf" else SyntheticLM
    source = src_cls(cfg.vocab, args.seq, args.batch, seed=SEED)
    opt_cfg = adamw.AdamWConfig(lr=args.lr,
                                warmup_steps=max(5, args.steps // 20),
                                total_steps=args.steps)
    return Setup(cfg, ctx, params, source, opt_cfg)


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


def run(args, device="cuda", ep_group=None,
        mesh: HostMesh | None = None) -> dict:
    """Train ``--steps`` steps, over ``ep_group`` or ``mesh`` when given (an
    initialised process group, or the grid of ``launch.mesh``, every rank
    calling), the traffic state threaded through every one (warm-up
    included); returns the loss of every step (the global batch's), the
    median ms per timed step, tokens per second (of the global batch), on
    the card this rank's peak device memory (GiB, params and optimizer
    state included), this rank's AdamW state (GiB), the sequences and bytes
    ``--seq-migrate`` moved, and the final traffic state (None without
    one)."""
    on_card = torch.device(device).type == "cuda"
    if on_card and torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats(device)
    cfg, ctx, params, source, opt_cfg = setup(args, device, ep_group, mesh)
    model = zoo.build(cfg, ctx)
    train_step = steps.make_train_step(model, opt_cfg, args.accum)
    traffic = init_traffic(cfg, ctx, args.accum)
    opt_state = steps.init_state(model, params)
    dp, d = (1, 0) if mesh is None else (mesh.data, mesh.data_index)
    serial = serial_accum(model, args.accum)
    losses, step_s = [], []
    moved = {"rows_moved": 0, "bytes_moved": 0}
    for i in range(args.steps):
        host, m = shard_batch(source.batch_at(i), dp, d, serial,
                              args.seq_migrate)
        moved = {k: moved[k] + m[k] for k in moved}
        batch = to_device(host, ctx.device)
        if on_card:
            torch.cuda.synchronize(ctx.device)
        t0 = time.perf_counter()
        params, opt_state, metrics = train_step(params, opt_state, batch,
                                                traffic)
        traffic = metrics.pop("traffic", None)
        if on_card:
            torch.cuda.synchronize(ctx.device)
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    timed = statistics.median(step_s[WARMUP:])
    if args.seq_migrate and _is_rank0():
        print(f"[seqmig] {moved['rows_moved']} sequences moved "
              f"({moved['bytes_moved'] / 1e6:.2f} MB) in {args.steps} steps",
              flush=True)
    return {"losses": losses, "step_ms": [t * 1e3 for t in step_s],
            "ms_per_step": timed * 1e3,
            "tokens_per_s": args.batch * args.seq / timed,
            "peak_mem_gib": (torch.cuda.max_memory_allocated(ctx.device) / 2**30
                             if on_card else None),
            "opt_state_gib": adamw.state_bytes(opt_state) / 2**30,
            "seq_migrate": moved, "cfg": cfg, "traffic": traffic}


def main(argv=None, device="cuda"):
    """The command line.  Under ``torchrun`` (``WORLD_SIZE`` > 1) the world
    is the reference's host mesh (``launch.mesh.make_host_mesh``: (1, 2) of
    two ranks, (2, 4) of eight): NCCL, one rank per card on
    ``cuda:LOCAL_RANK``, or gloo when ``device`` is the CPU.  Only rank 0
    prints; the peak memory and the AdamW state are printed for every
    rank."""
    args = parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        out = run(args, device)
        return _report(out, [(out["peak_mem_gib"], out["opt_state_gib"])])
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
        dist.all_gather_object(mem, (out["peak_mem_gib"],
                                     out["opt_state_gib"]))
        return _report(out, mem) if _is_rank0() else out
    finally:
        dist.destroy_process_group()


def _report(out: dict, mem: list):
    """Print the losses, the speed, and each rank's (peak memory, AdamW
    state) of ``mem``."""
    print("loss per step:", " ".join(f"{x:.4f}" for x in out["losses"]))
    print(f"{out['ms_per_step']:.1f} ms/step  {out['tokens_per_s']:.0f} "
          f"tokens/s  peak memory per rank "
          + " ".join("n/a" if p is None else f"{p:.2f}" for p, _ in mem)
          + " GiB  optimizer state per rank "
          + " ".join(f"{s:.3f}" for _, s in mem) + " GiB")
    return out


if __name__ == "__main__":
    main()
