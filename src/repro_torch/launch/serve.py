"""Serving driver: one lock-step batch, prefill through the FUSCO shuffle
then greedy decode, or (``--continuous``) the per-slot continuous-batching
engine (port of ``repro/launch/serve.py``).

``python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --layers 4
--requests 8 --prompt-len 64 --gen 16`` (the reference's default engine,
``fused_hier``)

``python -m repro_torch.launch.serve --arch moe-tx-stream --engine fused_flat
--requests 8 --prompt-len 512 --gen 16`` (the moe_tx family, per-layer
barriers)

``python -m repro_torch.launch.serve --arch moe-tx-stream --engine fused_pipe
--moe-stream 16 --requests 8 --prompt-len 512 --gen 16`` (the streamed
schedule: each layer's tail combine in flight across its attention block)

``python -m repro_torch.launch.serve --arch moe-ffn-stream --engine fused_pipe
--moe-stream 16 --requests 8 --prompt-len 512 --gen 16`` (the attention-free
moe_ffn family: its 16 MoE layers in one cross-layer stream, each layer's
combine in flight into the next layer's prologue; no KV cache)

``python -m repro_torch.launch.serve --arch moe-ffn-stream --engine fused_pipe
--moe-stream 16 --moe-interleave 2 --requests 8 --prompt-len 512 --gen 16``
(the requests split into two micro-batch lanes of four that round-robin
through the stream: each lane's tail combine in flight while the other lane
computes; ``--moe-interleave`` must divide ``--requests``, and takes the
moe_tx family too)

``python -m repro_torch.launch.serve --arch qwen3-1.7b --requests 8
--prompt-len 512 --gen 16`` (the dense family: attention and the SwiGLU MLP,
no MoE, so the engine flags are ignored)

``python -m repro_torch.launch.serve --arch mamba2-2.7b --requests 8
--prompt-len 512 --gen 16`` and ``--arch hymba-1.5b`` (the ssm and hybrid
families: Mamba2's SSD mixer, Hymba's parallel attention and SSM heads;
``--prompt-len`` a multiple of the SSD chunk, 256 at full width and 8
reduced, and with ``--continuous`` the engine's buckets are its multiples
too)

``python -m repro_torch.launch.serve --arch qwen2-vl-7b --requests 8
--prompt-len 512 --gen 16`` (the vlm family: each request's prompt is
(prompt_len, d) patch embeddings at M-RoPE positions 3 x arange, the
stubbed vision frontend's, drawn from the seed; decode feeds tokens)

``python -m repro_torch.launch.serve --arch seamless-m4t-large-v2 --requests
8 --prompt-len 512 --gen 16`` (the encdec family: each request is
(prompt_len, d) frame embeddings, the stubbed audio frontend's, encoded
once, and a first decoder token; the prefill is the encoder and that
token's decode step).  Both run lock-step, on one rank or over a grid
under ``torchrun`` as below (each data rank prefills and decodes its rows,
the model group runs their prefill's attention head-parallel):
``--continuous`` refuses them, as the reference's engine cannot serve them

``python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --layers 4
--requests 8 --prompt-len 64 --gen 16 --continuous`` (the requests through
``serving.engine.ContinuousServingEngine``, a pool of ``--requests`` slots:
it prints the prepared callables' count and build seconds, TTFT p50/p99,
decode tok/s and the mean slot occupancy)

``--engine`` takes ``fused_hier`` (the default, as the reference's: node
size max(1, EP // 2), the static grouping), ``fused_flat``, ``fused_pipe``
(the pipelined engine; ``--pipe-slices`` fixes its slice count, 0:
pipesim's), ``ragged`` and ``disagg`` (the baseline).

``torchrun --nproc-per-node 8 -m repro_torch.launch.serve --arch
qwen3-moe-30b-a3b --layers 8 --requests 8 --continuous`` serves over the
reference's host mesh of the world (``launch.mesh.make_host_mesh``: (1, 4)
of four ranks, (2, 4) of eight): each data rank serves its block of the
batch rows, its EP group (the model group) exchanges the tokens, and where
one lane's expert weights exceed 4 GB in bf16 (the reference's rule,
``lm.fsdp_rule``) their f dim is split over the data group and gathered a
layer at a time.  ``--requests`` must then be a multiple of
``--moe-interleave`` x the data ranks.

Runs on the card (``cuda``).  Weights and prompts are random, drawn from
seed 0.  A warm-up prefill and two decode steps (which also build the
kernels) run before the clock starts; every timed region ends in
``torch.cuda.synchronize()``.  ``--layers N`` cuts depth only.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import HostMesh, make_host_mesh
from repro_torch.models import lm, zoo
from repro_torch.models.zoo import EMBED_INPUTS
from repro_torch.serving.engine import ContinuousServingEngine


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-moe-30b-a3b")
    ap.add_argument("--reduced", action="store_true",
                    help="the reference's tiny smoke-test dims")
    ap.add_argument("--engine", default="fused_hier",
                    choices=["fused_flat", "fused_pipe", "fused_hier",
                             "disagg", "ragged"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to its first N layers (depth only)")
    ap.add_argument("--moe-stream", type=int, default=0,
                    help="moe_tx and moe_ffn families: layers per "
                         "cross-layer stream block (streamed with --engine "
                         "fused_pipe)")
    ap.add_argument("--moe-interleave", type=int, default=1,
                    help="moe_tx and moe_ffn families: prefill requests "
                         "interleaved as micro-batch lanes through each "
                         "stream block (must divide --requests)")
    ap.add_argument("--pipe-slices", type=int, default=0,
                    help="fused_pipe slice count; 0 = auto via pipesim")
    ap.add_argument("--continuous", action="store_true",
                    help="serve via the per-slot continuous-batching engine "
                         "instead of one lock-step batch")
    args = ap.parse_args(argv)
    if args.gen < 2:
        ap.error("--gen must be at least 2 (one prefill token, one decode step)")
    if args.continuous:
        family = get_arch(args.arch).family
        if family in EMBED_INPUTS:
            ap.error(f"--continuous serves token prompts (the reference "
                     f"refuses encdec too); the {family} family's prefill "
                     f"takes {EMBED_INPUTS[family]}")
    if args.requests % max(1, args.moe_interleave) != 0:
        ap.error("--moe-interleave must divide --requests")
    return args


class Setup(NamedTuple):
    cfg: ArchConfig
    ctx: lm.ModelContext
    params: dict
    tokens: torch.Tensor | None  # (requests, prompt_len) prompts; encdec:
                               # decoder tokens, the first of each row its
                               # BOS; None for the vlm (embeddings)
    positions: torch.Tensor | None  # (prompt_len,); the vlm's (3,
                               # prompt_len); None for encdec
    max_len: int
    batch: dict                # the bundle's prefill batch (global rows)
    bundle: zoo.ModelBundle


def setup(args, device="cuda", mesh: HostMesh | None = None) -> Setup:
    """The model, its random parameters and the prompts of a serve run, all
    drawn from seed 0 (the vlm's embeddings and positions and encdec's
    frames and first token from ``zoo.make_smoke_batch``, as the
    reference's serve), on one rank or on this rank of ``mesh`` (a
    ``launch.mesh.HostMesh``): the parameters are this rank's, its lane of
    the expert weights and, under FSDP of the experts (the reference's
    rule, ``lm.fsdp_rule``), its slice of their f dim; the prompts are the
    global batch.  Raises ValueError unless ``--requests`` is a multiple
    of ``--moe-interleave`` x the data ranks."""
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    data, model = (1, 1) if mesh is None else (mesh.data, mesh.model)
    mult = max(1, args.moe_interleave) * data
    if args.requests % mult:
        raise ValueError(
            f"--requests {args.requests} must be a multiple of "
            f"--moe-interleave x data ranks = {mult}: each data rank serves "
            "an equal block of the rows, split into the interleave lanes")
    ctx = lm.make_context(cfg, device, mesh=mesh, engine=args.engine,
                          # the reference's serve: max(1, model // 2)
                          node_size=max(1, model // 2),
                          moe_stream=args.moe_stream,
                          moe_interleave=args.moe_interleave,
                          pipe_slices=args.pipe_slices,
                          # serving reads whole weights
                          explicit_tp=False, split_vocab=False)
    bundle = zoo.build(cfg, ctx)
    gen = torch.Generator(device=ctx.device).manual_seed(0)
    params = bundle.init(gen)
    if cfg.family in EMBED_INPUTS:
        batch = zoo.make_smoke_batch(cfg, gen, args.requests, args.prompt_len)
        tokens = batch.get("tokens")
        if cfg.family == "encdec":
            batch = {"frames": batch["frames"], "tokens": tokens[:, 0]}
        else:
            batch = {"embeds": batch["embeds"],
                     "positions": batch["positions"]}
        positions = batch.get("positions")
    else:
        tokens = torch.randint(0, cfg.vocab, (args.requests, args.prompt_len),
                               generator=gen, device=ctx.device)
        positions = torch.arange(args.prompt_len, device=ctx.device)
        batch = {"tokens": tokens, "positions": positions}
    return Setup(cfg, ctx, params, tokens, positions,
                 args.prompt_len + args.gen, batch, bundle)


def _run_continuous(cfg, ctx, params, tokens, max_len) -> dict:
    """Every prompt through a ``ContinuousServingEngine`` of as many slots
    as requests, each asking for ``--gen`` tokens (on a grid each rank runs
    the same engine loop over the same queue and decodes its block of the
    slots); returns the finished requests, the engine's ``stats()``, its
    build seconds and the engine."""
    b, gen = tokens.shape[0], max_len - tokens.shape[1]
    eng = ContinuousServingEngine(zoo.build(cfg, ctx), max_batch=b,
                                  max_len=max_len)
    compile_s = eng.warmup(params)
    for row in tokens.cpu().numpy():
        eng.submit(row, max_new=gen)
    done = eng.run(params)
    return {"done": done, "stats": eng.stats(), "compile_s": compile_s,
            "engine": eng, "cfg": cfg}


def run(args, device="cuda", mesh: HostMesh | None = None) -> dict:
    """Serve one lock-step batch, on one rank or on this rank of ``mesh``
    (every rank of its world calls it: each prefills and decodes its data
    rank's block of the rows); returns the generated tokens (B, gen) and
    the last logits (B, V) of the whole batch (gathered over the data group
    after the timed regions), and this rank's timings.  With
    ``--continuous`` serves the same prompts through the continuous engine
    instead (``_run_continuous``)."""
    s = setup(args, device, mesh)
    cfg, ctx, params, max_len = s.cfg, s.ctx, s.params, s.max_len
    if args.continuous:
        return _run_continuous(cfg, ctx, params, s.tokens, max_len)
    decode_step = s.bundle.decode_step

    def serve():
        logits, state = s.bundle.prefill(params, s.batch, max_len)
        return logits, state, logits.argmax(-1)

    with torch.inference_mode():
        t0 = time.perf_counter()
        _, state, tok = serve()
        for _ in range(2):
            _, state = decode_step(params, state, tok, max_len)
        _sync(ctx.device)
        warmup_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        logits, state, tok = serve()
        _sync(ctx.device)
        ttft = time.perf_counter() - t0
        seqs = [tok]
        t0 = time.perf_counter()
        for _ in range(args.gen - 1):
            logits, state = decode_step(params, state, tok, max_len)
            tok = logits.argmax(-1)
            seqs.append(tok)
        _sync(ctx.device)
        t_dec = time.perf_counter() - t0
        toks = lm.gather_rows(torch.stack(seqs, 1), ctx)
        logits = lm.gather_rows(logits, ctx)
    return {"tokens": toks, "logits": logits,
            "warmup_s": warmup_s, "ttft_s": ttft,
            "decode_s_per_tok": t_dec / (args.gen - 1), "cfg": cfg}


def _is_rank0() -> bool:
    return not (dist.is_available() and dist.is_initialized()) or (
        dist.get_rank() == 0)


def _peak_gib(device) -> float | None:
    """This process's peak device memory (GiB); None on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**30


def main(argv=None, device="cuda"):
    """The command line.  Under ``torchrun`` (``WORLD_SIZE`` > 1) the world
    is the reference's host mesh (``launch.mesh.make_host_mesh``: (1, 4) of
    four ranks, (2, 4) of eight): NCCL, one rank per card on
    ``cuda:LOCAL_RANK``, or gloo when ``device`` is the CPU.  Only rank 0
    prints; the peak device memory of every rank is printed."""
    args = parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return _report(args, run(args, device), [_peak_gib(device)])
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
        peaks = [None] * world
        dist.all_gather_object(peaks, _peak_gib(device))
        return _report(args, out, peaks) if _is_rank0() else out
    finally:
        dist.destroy_process_group()


def _report(args, out: dict, peaks: list):
    """Print a run's times, its sample tokens and each rank's peak device
    memory (``peaks``, GiB; None on the CPU)."""
    print("peak memory per rank "
          + " ".join("n/a" if m is None else f"{m:.2f}" for m in peaks)
          + " GiB")
    if args.continuous:
        st, eng = out["stats"], out["engine"]
        print(f"compile {out['compile_s']:.2f} s  ({eng.compile_count} "
              "prepared callables)")
        print(f"ttft p50 {st['p50_ttft_s'] * 1e3:.1f} ms  "
              f"p99 {st['p99_ttft_s'] * 1e3:.1f} ms   "
              f"decode {st['decode_tok_s']:.0f} tok/s   "
              f"occupancy {st['mean_slot_occupancy']:.2f}  "
              f"({len(out['done'])} requests)")
        print("sample:", out["done"][0].output[:12])
        return out
    print(f"warmup {out['warmup_s']:.2f} s")
    print(f"ttft {out['ttft_s'] * 1e3:.1f} ms   decode "
          f"{out['decode_s_per_tok'] * 1e3:.1f} ms/tok  "
          f"({args.requests} requests)")
    print("sample:", out["tokens"][0][:12].tolist())
    return out


if __name__ == "__main__":
    main()
