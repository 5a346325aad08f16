"""Training entry point (port of the core loop of ``repro/launch/train.py``): a
few AdamW steps of next-token loss through the FUSCO shuffle, on one card or
over an expert-parallel group of cards.

``python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b --layers 4
--batch 4 --seq 512 --steps 8 --engine fused_flat --data zipf``

``python -m repro_torch.launch.train --arch moe-tx-stream --engine fused_pipe
--moe-stream 16 --batch 4 --seq 512 --steps 8``

``--engine`` takes ``fused_hier`` (the default, as the reference's),
``fused_flat`` (``--dedup``: the condensed wire), ``fused_pipe``, ``ragged``
and ``disagg``; ``--calibrate`` measures the pipe constants that choose
fused_pipe's slice count and prints the table it applies.  ``--moe-stream
N`` groups the moe_tx layers into stream blocks of N (fused_pipe streams
each block's MoE tails across its attention).  The online traffic
statistics (``core/traffic.py``) ride every step of the MoE families, as
the reference threads them ("stats are collected either way"), and feed
``fused_hier``'s Algorithm 1; serial accumulation (``--accum`` > 1) runs
without them.

Runs on the card (``cuda``); ``run(args, device="cpu")`` runs the plain
path, and ``run(args, device, ep_group=g)`` over an initialised group.
Weights are random; the batches come from the reference's synthetic
streams (``--data zipf``: the 2-gram Zipf language; ``uniform``: hash
tokens), deterministic in (seed, step); weights and batches come from seed
0.  The first ``WARMUP`` steps (which also build the
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

import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.core import calibrate
from repro_torch.core import traffic as traffic_lib
from repro_torch.data.pipeline import SyntheticLM, ZipfNgramLM, iterate
from repro_torch.launch import steps
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
    ap.add_argument("--pipe-slices", type=int, default=0,
                    help="fused_pipe slice count; 0 = auto via pipesim")
    ap.add_argument("--moe-stream", type=int, default=0,
                    help="moe_tx family: layers per stream block (fused_pipe "
                         "carries each layer's MoE tail across the attention "
                         "block inside a block); 0 = one layer a block")
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


def setup(args, device="cuda", ep_group=None) -> Setup:
    """The model, its random bf16 parameters (this rank's lane of the expert
    weights over ``ep_group``), the data source and the optimizer's config
    of a train run, all from seed 0: every rank of a group draws the same
    replicated leaves and reads the same batches."""
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    calibration = None
    if args.calibrate:
        calibration = calibrate.calibrate(device=device)
        if _is_rank0():
            print(f"[calibrate] {calibration.platform}: "
                  f"stage {calibration.stage_bw / 1e9:.1f} GB/s, "
                  f"wire {calibration.wire_bw / 1e9:.1f} GB/s, "
                  f"overhead {calibration.overhead_s * 1e6:.1f} us",
                  flush=True)
    ep = 1 if ep_group is None else dist.get_world_size(ep_group)
    ctx = lm.make_context(cfg, device, ep_group=ep_group, engine=args.engine,
                          capacity_factor=args.capacity_factor,
                          node_size=max(1, ep // 2), dedup=args.dedup,
                          pipe_slices=args.pipe_slices,
                          moe_stream=args.moe_stream,
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


def init_traffic(cfg: ArchConfig, ctx: lm.ModelContext, accum: int):
    """The cold layer-stacked traffic state a run threads through its steps
    (the reference's train.py:296-326): for the MoE families, unless the
    micro-batches accumulate serially, which do not thread one."""
    if cfg.moe is None or cfg.family not in ("moe", "moe_tx"):
        return None
    if accum > 1:
        if _is_rank0():
            print("[traffic] stats disabled under serial gradient "
                  "accumulation", flush=True)
        return None
    return traffic_lib.init_traffic_state(cfg.moe.n_experts, ctx.placement.ep,
                                          n_layers=cfg.n_layers,
                                          device=ctx.device)


def run(args, device="cuda", ep_group=None) -> dict:
    """Train ``--steps`` steps, over ``ep_group`` when given (an initialised
    process group, every rank calling), the traffic state threaded through
    every one (warm-up included); returns the loss of every step, the
    median ms per timed step, tokens per second (of the whole batch), on the
    card this rank's peak device memory (GiB, params and optimizer state
    included), and the final traffic state (None without one)."""
    on_card = torch.device(device).type == "cuda"
    if on_card and torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats(device)
    cfg, ctx, params, source, opt_cfg = setup(args, device, ep_group)
    train_step = steps.make_train_step(zoo.build(cfg, ctx), opt_cfg,
                                       args.accum)
    traffic = init_traffic(cfg, ctx, args.accum)
    opt_state = adamw.init(params)
    losses, step_s = [], []
    batches = iterate(source, ctx.device)
    for _ in range(args.steps):
        batch = next(batches)
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
    return {"losses": losses, "step_ms": [t * 1e3 for t in step_s],
            "ms_per_step": timed * 1e3,
            "tokens_per_s": args.batch * args.seq / timed,
            "peak_mem_gib": (torch.cuda.max_memory_allocated(ctx.device) / 2**30
                             if on_card else None),
            "cfg": cfg, "traffic": traffic}


def main(argv=None, device="cuda"):
    """The command line.  Under ``torchrun`` (``WORLD_SIZE`` > 1) every
    process is one rank of the EP group, the whole world: NCCL on
    ``cuda:LOCAL_RANK``, or gloo when ``device`` is the CPU.  Only rank 0
    prints; the peak memory is printed for every rank."""
    args = parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        out = run(args, device)
        return _report(out, [out["peak_mem_gib"]])
    on_card = torch.device(device).type == "cuda"
    if on_card:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if on_card else "gloo",
                            rank=int(os.environ["RANK"]), world_size=world)
    try:
        out = run(args, device, ep_group=dist.group.WORLD)
        peaks = [None] * world
        dist.all_gather_object(peaks, out["peak_mem_gib"])
        return _report(out, peaks) if _is_rank0() else out
    finally:
        dist.destroy_process_group()


def _report(out: dict, peaks: list):
    print("loss per step:", " ".join(f"{x:.4f}" for x in out["losses"]))
    print(f"{out['ms_per_step']:.1f} ms/step  {out['tokens_per_s']:.0f} "
          f"tokens/s  peak memory per rank "
          + " ".join("n/a" if p is None else f"{p:.2f}" for p in peaks)
          + " GiB")
    return out


if __name__ == "__main__":
    main()
