#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

1. Builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` with
   nvcc (one process per source, in parallel) and prints the build time and
   the compiler's register / shared-memory / spill report (fails if a
   Hopper-form kernel, ``*_wgmma``, spills), then the count of HGMMA (wgmma)
   and UTMALDG (TMA load) instructions that ``cuobjdump -sass`` finds in the
   libraries of the Hopper forms, fused_swiglu, grouped_matmul and
   flash_attention (fails if any is 0).
2. Kernel phase: holds each kernel against its plain PyTorch version on the
   card, in bf16, at the shapes its paths give it, and times kernel, plain
   version and a PyTorch yardstick with CUDA events (the median of 5 rounds,
   printed with the fastest and slowest round):
   - the MoE kernels at the qwen3-moe-30b-a3b prefill of 8 requests x 64
     tokens through fused_flat (T = 512 tokens, 128 experts, top-8,
     capacity 64; and the decode shape), and at the moe-tx-stream prefill
     of 8 x 512 tokens (T = 4096, 64 experts, top-4, capacity 512); the
     combine (segment_scatter_add over the plan's slot table) must give the
     same bits on two calls (so must the unit-gate form, the gather's
     backward), and its path without owner lists (the counting build, then
     the reduce) is held against it;
   - the same three MoE kernels at the slices of each path's fused_pipe
     serve phase (``pipe_slice_rows``: qwen3-moe at pipesim's S 32 of
     Cs 2, moe-tx at its streamed S 4 of Cs 128), from the engine's own
     sliced plan: every slice's gather, fused_swiglu on the slice's counts
     and owner-reduce over the slice's owner table held, slice 0 timed, and
     each slice's fused_swiglu the bits of its rows of one launch over the
     whole buffer;
   - the flash attention at both prefill shapes and at the shifted query
     stripe of one EP lane (with and without a window), beside SDPA with a
     boolean mask and, where the positions are plain, with is_causal;
   - at the training shape of qwen3-moe-30b-a3b (B 4 x S 512: T = 2048,
     capacity 256): grouped_matmul 2048 -> 768 and 768 -> 2048 through a
     transposed weight view, fused_swiglu's forward, the flash forward and
     the combine;
   - at the training shape of moe-tx-stream-1b (``TX_TRAIN``: B 4 x S 512,
     64 experts, top-4, capacity 256, d 1024, f 1024; ``train_rows``): the
     dispatch gather, grouped_matmul in both weight layouts, fused_swiglu's
     forward, the flash forward (hd 64, beside SDPA is_causal) and the
     combine, and the three MoE kernels at the slices of its streamed
     fused_pipe phase (pipesim's S at T 2048, 16 layers a block);
   - the gathers and scatter-adds of fused_hier (``hier_kernel_rows``: the
     stage-1 gather, the expansion, the pre-combine over the stage-2 slot
     table and the origin sum over the stage-1 one) at the serve and train
     shapes, and ragged's unpack and pack-back gathers at the serve shape
     (``ragged_kernel_rows``), from the engines' own plans;
   - at the continuous qwen3-moe path's admission shapes (one request of
     16 and of 128 tokens, ``admission_rows``): the flash forward (B 1,
     hd 128) and fused_hier's gathers, scatter-adds and fused_swiglu on its
     expansion buffer;
   - qwen3-1.7b's flash forward at group size 2 (``dense_flash_rows``: 16
     / 8 heads of 128) at its serve prefill (8 x 512) and train (4 x 512)
     shapes beside SDPA is_causal, and held at an odd query length, a
     query run ending at the keys' end and a shifted stripe with and
     without a window; moe-ffn-stream-1b's MoE kernels at its serve (T
     4096) and train (T 2048) shapes and at the slices of its streamed
     phases (pipesim's joint S for a block of 16 layers,
     ``ffn_pipe_config``);
   - the interleaved paths (``LANE_SERVE``, ``LANE_TRAINS``: two micro-batch
     lanes) at one lane's shapes (``lane_plan``, ``lane_rows``): the three
     MoE kernels at every slice of one lane's shuffle (moe-ffn serve T 2048
     S 32, train T 1024 S 16; moe-tx serve T 2048 S 4, train T 1024 S 4),
     in training grouped_matmul at slice 0's shape, and moe-tx's flash at
     one lane's batch (4 / 2 rows of 512);
   - hymba-1.5b's flash forward at hd 64, group size 5 (``hymba_flash_rows``:
     tiles of 12 queries): its serve prefill (8 x 512, window 1024 and
     global), its 2048-token prompt (the window binds) and its train
     forward (4 x 512), beside SDPA; its torch backward at the train shape
     among the backward rows;
   - odd shapes of the Hopper forms (the flash one at group sizes 3, 5, 6
     and 7 too, whose query tiles leave rows of the 64-row tile dead; G 5
     at hd 64 over 2048 queries with the window binding), of
     the flash tensor-core form (the bf16 shapes the Hopper form refuses:
     hd 16 and 32) and of the scatter-add and its backward
     (``odd_shape_checks``), held only.
   Each Hopper-form row also gives the time of the kernel's loads alone and
   of its products alone (``time_split``: builds with the consumers issuing
   no wgmma, and with the producer loading nothing).
3. Backward rows: each autograd Function's backward (gather, scatter-add,
   fused SwiGLU, flash) on the card against the same backward on the plain
   versions, at the training shapes (qwen3-moe, moe-tx, moe-ffn; the
   flash backward at qwen3-1.7b's too), with times; the gather's and the
   scatter-add's must give the same bits on two calls.
4. Calibration (``calibrate_phase``): ``core.calibrate.calibrate()`` on the
   card, printed beside the H100 spec point the pipe constants default to,
   with the slice count and capacity pipesim gives at each (qwen3-moe serve
   prefill T 512 and train T 2048; the moe-tx streamed prefill, 16 layers).
5. Engine phase (``engine_rows``): one full-width qwen3-moe MoE layer
   (``fusco.shuffle_ffn``: 128 experts, top-8) at the serve prefill shape
   (T 512, capacity 64) and the train shape (T 2048, capacity 256) through
   fused_flat, fused_pipe at pipesim's slice count (spec point and
   calibrated), at S = 1 and S = 4, disagg, fused_hier, fused_flat with
   dedup and ragged: S, the rows per slice, the device time (median of 5
   rounds behind a device sleep, with the spread) and the host-clock time
   of the layer, the fused_swiglu launches and the expert weight bytes they
   read (from the counts each launch was given), and the gather and
   scatter-add launches, which must be those the engine's code implies
   (``ENGINE_LAUNCHES``); no operation of the layer may make the host wait
   on the card (``host_syncs``), which the device timing could not see.
   fused_pipe at S = 1 and ragged must give
   fused_flat's bits; the others are held to fused_flat in bf16 element by
   element, within a tolerance from the bf16 roundings into the output
   (``engine_rows``), and in float32 at a reduced width (d 256, f 128, and
   also at the serve layer's S) to 1e-5 (``engine_f32_check``).  One
   ``{"engines": [...]}`` JSON line.
6. Serve phases, one per path: zero the kernels' launch counters, serve the
   full-width model through ``repro_torch.launch.serve`` (qwen3-moe-30b-a3b
   at 4 layers; moe-tx-stream-1b at all 16), read the counters and fail if a
   kernel of the path never launched.  Then profile one prefill and one
   decode step of the same path (torch.profiler) and print the device's busy
   time beside the step's wall time, and the kernels with the most device
   time; fails if a profile shows a kernel no full-width step may run
   (``OFF_PATH``: the flash tensor-core form among them, whatever the
   group size) or a prefill's shows no ``flash_fwd_wgmma``.  The paths
   are fused_flat's two, then (``ENGINE_SERVE``) qwen3-moe through
   ``--engine fused_pipe`` and ``--engine disagg`` (whose sort and repack
   passes are plain torch: the phase fails if it launches the gather or the
   scatter-add kernel), through ``--engine fused_hier`` (the reference's
   default) and ``--engine ragged``, each held to the gather and
   scatter-add launches its code implies (``SERVE_LAUNCHES``), and
   moe-tx-stream-1b through ``--engine fused_pipe --moe-stream 16``, the
   streamed schedule across all 16 layers.  Then (``NEW_SERVE``)
   qwen3-1.7b, the dense family, all 28 layers, 8 x 512 prompt tokens (the
   flash forward must launch 2 x 28 times and no MoE kernel at all), and
   moe-ffn-stream-1b, the attention-free MoE chain, all 16 layers, 8 x 512,
   through fused_flat and through ``--engine fused_pipe --moe-stream 16``
   (the cross-layer stream at pipesim's joint S, printed; flash must not
   launch).
   Then (``LANE_SERVE``) both stream families through ``--engine fused_pipe
   --moe-stream 16 --moe-interleave 2``, all 16 layers, 8 x 512: two lanes
   of four requests round-robin through the stream; every kernel's launches
   must equal those the code implies (``lane_launches``: S per lane from
   ``lane_plan``), printed beside them, with the lanes and S per lane.
   Then the continuous paths (``CONTINUOUS``, ``continuous_phase``):
   ``serving.engine.ContinuousServingEngine`` with traffic tracked over
   qwen3-moe-30b-a3b (4 layers, fused_hier, pool 8, 32 requests of 16 /
   32 / 64 / 128 tokens) and moe-tx-stream-1b (16 layers, fused_flat, 16
   requests of 64 / 128 / 256 / 512 tokens), max_new from seed 0 in 8-32:
   ``warmup()``, then ``run()`` with the counters zeroed; fails if the run
   built a callable (``compile_count`` moved), a serve kernel never
   launched, a request lacks its tokens, or the host waited on the card
   other than once per admission and once per decode step.  Prints the
   callables and their build seconds, TTFT p50/p95/p99, decode tok/s,
   occupancy, lane imbalance and top-expert share, launches and peak
   memory, and profiles one admission prefill per prompt length and one
   pool decode step.  Then the ssm and hybrid families at full width and
   full depth (``SSM_SERVE``): mamba2-2.7b (64 layers) and hymba-1.5b (32)
   served 8 x 512 and hymba one 2048-token prompt past its window, each
   held to ``ssm_serve_implied`` (the flash forward once a hybrid layer a
   prefill, none in decode, no other kernel) and profiled; both through
   ``serve.run --continuous`` (``SSM_CONTINUOUS``: buckets 256 and 512, the
   SSD chunk's multiples; launches held to the code's count); and the bf16
   prefill of mamba2 at 1 and 4 layers against the same weights in f32
   (``ssd_bf16_gap``: the SSD's decays and cumsums in bf16, as the
   reference's).
7. Train phases: zero the counters, train full-width qwen3-moe-30b-a3b (4
   of 48 layers) for 8 AdamW steps through ``repro_torch.launch.train``,
   through fused_flat and then through fused_hier, then moe-tx-stream-1b
   (all 16 layers, B 4 x S 512) through fused_flat and through
   ``--engine fused_pipe --moe-stream 16`` (``TX_TRAINS``), each with the
   traffic state threaded through every step, then (``NEW_TRAINS``)
   qwen3-1.7b (14 of its 28 layers, bf16 params, f32 master) and
   moe-ffn-stream-1b (all 16 layers) through fused_flat and streamed
   fused_pipe, B 4 x S 512, 8 steps, and (``LANE_TRAINS``) both stream
   families at two lanes with ``--accum 2`` fused into them (one loss call
   a step, traffic on), their launches held to ``lane_launches``, and
   (``SSM_TRAINS``) hymba-1.5b at its 32 layers and mamba2-2.7b at 16 of
   its 64 (its AdamW state at 64 would be 45.3 GB), held to
   ``ssm_train_implied``; read the counters and fail if a
   kernel of the path (``family_kernels``: the five and the scatter-add's
   backward, flash only where the family has attention, none of the MoE
   kernels for the dense family) never launched or one off it did, a loss
   is not finite or, for a family with MoE, the traffic state is all zero;
   print the losses, ms/step, tokens/s, peak memory and the traffic state,
   then profile one step, its forward+backward and its optimizer update
   (device busy, device ms by kind, the bf16 zero fills and adds of the
   stacked gradients' assembly).  After the relayout phases, ``--engine
   auto`` (``engine_auto_phase``): qwen3-moe at full width, 4 layers, B 4 x
   S 512, 6 steps, ``--relayout-every 2``; each ``[commplan]`` decision is
   printed, every kernel's launches must equal the sum over steps and
   layers of its engine's per-layer count (fused_flat's and fused_hier's,
   from their train phases), one step of the final engines is profiled
   beside the fixed-engine runs; then a forced mix, F H F H, for 2 steps:
   its launches held exactly, its first loss within 2e-3 relative of the
   fused_flat run's.  After the lane phases, the fault-tolerant loop
   (``checkpoint_phase``): moe-ffn-stream-1b at full width cut to one
   layer, fused_flat, traffic and ``--relayout-every 2`` on, ``--ckpt-every
   2 --inject-failure-at 3`` into a temporary directory (its free space
   checked first, removed at the end): the run restarts once, from step 2,
   with the placement of the history, and its losses must equal the
   uninterrupted run's bit for bit; the state restored from ``LATEST``
   must equal the run's last bit for bit, and a second process resuming
   from ``LATEST`` must take the loss of this run continued by one step.
   Prints each save's host copy ms, the writing thread's seconds and GB/s,
   the restores' seconds and the bytes on disk, beside the card's name and
   power limit.  Then one qwen3-moe train step with the traffic state and
   one without, in turns (``traffic_cost_phase``): host ms and device busy
   ms of each.
8. Checks the outputs: finite logits and in-vocabulary tokens of the right
   shape, each reduced model's logits on the card (kernels) against the
   same model on the CPU (plain versions) through each engine (fused_pipe
   at 4 slices, moe-tx in one streamed block; fused_hier, fused_flat with
   dedup and ragged too), the reduced models served
   and trained on the card in bf16 (their attention on the flash
   tensor-core form), and one reduced train step in float32 on the card
   against the CPU (loss, every grad leaf, every updated param, the traffic
   state) through each engine, and of the reduced moe-tx through fused_flat
   and streamed fused_pipe, of the reduced qwen3-1.7b and moe-ffn-stream
   (``NEW_REDUCED``: serve logits and the train step, moe-ffn through
   fused_flat and streamed fused_pipe), of the reduced mamba2-2.7b and
   hymba-1.5b; and the continuous engine over the
   reduced models in f32 (``continuous_check``: qwen3-moe through
   fused_flat and fused_hier, moe-tx, qwen3-1.7b, moe-ffn, mamba2 and
   hymba through fused_flat; 6 requests, a pool of 4): the card's token
   streams must equal the CPU's and its own batch-1 waved oracle's, and
   its traffic state the CPU's within 1e-5.  At two lanes
   (``lane_capacity``: no row dropped): both stream families' serve logits
   card vs CPU and card vs the card at one lane, their train step with the
   accumulation fused into the lanes card vs CPU and vs the card's one-lane
   step, and moe-ffn's continuous engine with an admission chunk of two.
   Each reduced train check runs once more over a one-rank NCCL group (the
   bits of none, no collective).  Then the process groups, on gloo ranks
   sharing the card (NCCL refuses two ranks on one device; gloo stages
   every collective through the host, so nothing here is a speed):
   ``ep2_card_check``, one reduced f32 train step of each family on two
   ranks (EP 2, a (1, 2) grid: the moe family under its default Megatron
   TP; and qwen3-moe once more over the EP group alone with
   ``explicit_tp=False``, its replicated attention) against the one-rank
   card step (moe-ffn's at two lanes, its
   accumulation fused), and moe-ffn's prefill at two lanes with autograd
   off, every lane's tail left in flight on an asynchronous exchange;
   ``grid_card_check``, the same on a (2, 2) (data, model) grid of four
   ranks, with reduced qwen3-1.7b and qwen3-moe through fused_flat under
   TP besides, the replicated leaves' bits equal on the four, each expert
   leaf's and TP shard's on the data ranks of its model rank, the traffic
   state's on the four, each rank's AdamW state its ZeRO-1 share, and
   every kernel of the family launched on every rank (rank 0's launches
   join ``launches_by_phase``), and in the same spawn the same for
   qwen3-1.7b on a (1, 4) grid (one head a rank), then serving on the
   (2, 2) grid (``grid_serve_check``: each data rank its block of the batch
   rows): reduced qwen3-moe in f32 through fused_flat and fused_hier
   (FSDP of the experts forced on) in the continuous and the waved engine,
   every rank's streams the card alone's and its traffic counts equal; and
   qwen3-moe at full width cut to 8 layers in bf16 through fused_hier with
   FSDP of the experts by the reference's rule, the continuous engine over
   8 requests of 64 tokens: each rank's expert bytes exactly its half of
   its lane's (2,415,919,104 B), its peak memory, the same streams on the
   four, each row's first-token logits the card alone's within half their
   distance to the nearest other request's (``TOL_GRID_APART``: fused_hier
   rounds each node's part of the combine, which flips near-tied top-8
   choices), the kernels held and timed on rank 0's layer-0 inputs, and
   rank 0's launches the count the code implies per admission and decode
   step; then, in the same spawn on the world of four, the pipeline
   (``pipeline_rank``, ``PIPE``): qwen3-1.7b at full width and all 28
   layers in 4 stages of 7 through ``parallel/pipeline.pipeline_apply``,
   bf16, 8 microbatches of 1 x 512, forward and backward of sum(out * c),
   against the same layers run sequentially on rank 0 one microbatch at a
   time (``pipeline_check``: the output bit-equal, else where it parts;
   every stage's dw and every rank's dx within n_micro x 2^-8 x the sum of
   the per-microbatch |gradients|; exactly 7 x (8 + 3) = 77 flash forwards
   a rank in the pipelined call and 224 in the sequential one; the longest
   hop and the broadcast by host clock); after the spawn, in this process,
   ``compress_phase``: 4 rounds of ``parallel/compress``'s error feedback
   over a seeded bf16 gradient tree of qwen3-1.7b's leaf shapes, every
   block's error within max|block| / 254, the last round's q, scales and
   error on ``embed`` and layer 0's leaves bit-equal to the CPU's, one
   ``compress_grads`` timed against its bytes bound; ``zero1_phase``,
   qwen3-moe at full width cut to one layer (B 4 x S 512, traffic on, 3
   steps) through ``launch/train.run`` on the card alone and then on that
   grid, with ZeRO-1 and then FSDP of the experts in one spawn: each
   rank's measured AdamW state must be the reckoning of what it holds
   (``held_params``) over DP 2, its losses finite and the same on the four
   ranks, the first within 2e-3 relative of the one-card run's, and under
   FSDP its expert bytes half the ZeRO-1 rank's;
   and ``tp_full_phase``, one bf16 train step at full width of qwen3-1.7b
   (2 layers) and qwen3-moe (1 layer) on (1, 2) and of qwen3-moe on (1, 4)
   under Megatron TP against the card alone: the loss within 2e-3, each
   rank's parameter and AdamW bytes the reckoning, rank 0's flash calls at
   n_heads / m query heads (the flash rows at those shapes,
   ``tp_flash_rows``, sit in the kernel phase).
9. Prints the card's name and power limit, the kernels' numbers as one JSON
   line (``launches_by_phase`` counts every serve phase), and last
   ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero before the last line.  Without a CUDA
device, or outside a checkout that holds ``src/repro_torch``, it exits
non-zero and prints no result.  It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

MEM_BW = 3.35e12        # H100 SXM HBM3 bytes/s (data sheet)
BF16_PEAK = 989e12      # dense bf16 tensor-core flop/s
F32_PEAK = 67e12        # float32 flop/s outside the tensor cores
SLEEP_CYCLES = 50_000_000   # ~25 ms of device sleep ahead of each timed round

# the serving paths: arch -> (serve flags, MoE shapes, attention shape)
PATHS = {
    "qwen3-moe-30b-a3b": (
        ["--arch", "qwen3-moe-30b-a3b", "--engine", "fused_flat", "--layers",
         "4", "--requests", "8", "--prompt-len", "64", "--gen", "16"],
        dict(t=512, d=2048, n_experts=128, top_k=8, f=768, decode_t=8),
        dict(b=8, sq=64, sk=64, hq=32, hkv=4, hd=128)),
    "moe-tx-stream": (
        ["--arch", "moe-tx-stream", "--engine", "fused_flat", "--requests",
         "8", "--prompt-len", "512", "--gen", "16"],
        dict(t=4096, d=1024, n_experts=64, top_k=4, f=1024, decode_t=8),
        dict(b=8, sq=512, sk=512, hq=16, hkv=4, hd=64)),
}
# the training path: launch/train.py's flags, the MoE shapes it gives the kernels
# (T = 4 x 512 tokens, capacity 256) and its attention shape
TRAIN = (["--arch", "qwen3-moe-30b-a3b", "--engine", "fused_flat", "--layers",
          "4", "--batch", "4", "--seq", "512", "--steps", "8", "--data",
          "zipf"],
         dict(t=2048, d=2048, n_experts=128, top_k=8, f=768, decode_t=8),
         dict(b=4, sq=512, sk=512, hq=32, hkv=4, hd=128))
# the train phases: label -> flags (the same run through fused_hier)
TRAINS = {"train": TRAIN[0],
          "train fused_hier": [a if a != "fused_flat" else "fused_hier"
                               for a in TRAIN[0]]}
# the moe-tx train path: moe-tx-stream-1b at full width, all 16 layers, B 4 x
# S 512 (T 2048, 64 experts, top-4, capacity 256), and its attention shape
TX_TRAIN = (["--arch", "moe-tx-stream", "--batch", "4", "--seq", "512",
             "--steps", "8", "--data", "zipf", "--engine", "fused_flat"],
            dict(t=2048, d=1024, n_experts=64, top_k=4, f=1024, decode_t=8),
            dict(b=4, sq=512, sk=512, hq=16, hkv=4, hd=64))
# its phases: through the per-layer barriers, and streamed across all 16
# layers in one block
TX_TRAINS = {"moe-tx train": TX_TRAIN[0],
             "moe-tx train fused_pipe": TX_TRAIN[0][:-1] + [
                 "fused_pipe", "--moe-stream", "16"]}
SERVE_KERNELS = ("segment_gather", "segment_scatter_add", "fused_swiglu",
                 "flash_attention")
MOE_KERNELS = ("segment_gather", "segment_scatter_add",
               "segment_scatter_add_bwd", "fused_swiglu", "grouped_matmul")
# the dense family (qwen3-1.7b) and the attention-free moe_ffn stream
# (moe-ffn-stream-1b), each at full width and all its layers: their serve
# and train phases, the shapes they give the kernels (moe-ffn: T 8 x 512 /
# 4 x 512, 64 experts, top-4, d 1024, f 1024; qwen3-1.7b's attention: 16 /
# 8 heads of 128, group size 2) and the streamed moe-ffn's block
DENSE, FFN = "qwen3-1.7b", "moe-ffn-stream"
FFN_LAYERS = 16
DENSE_SERVE = ["--arch", DENSE, "--requests", "8", "--prompt-len", "512",
               "--gen", "16"]
FFN_SERVE = ["--arch", FFN, "--engine", "fused_flat", "--requests", "8",
             "--prompt-len", "512", "--gen", "16"]
STREAMED = ["fused_pipe", "--moe-stream", str(FFN_LAYERS)]
NEW_SERVE = {DENSE: DENSE_SERVE, FFN: FFN_SERVE,
             f"{FFN} fused_pipe": FFN_SERVE[:3] + STREAMED + FFN_SERVE[4:]}
TRAIN_FLAGS = ["--batch", "4", "--seq", "512", "--steps", "8", "--data",
               "zipf"]
# qwen3-1.7b's train phase runs half its 28 layers (the grid serving checks
# take the time)
DENSE_TRAIN_LAYERS = 14
NEW_TRAINS = {f"{DENSE} train": ["--arch", DENSE, "--layers",
                                 str(DENSE_TRAIN_LAYERS)] + TRAIN_FLAGS,
              "moe-ffn train": ["--arch", FFN] + TRAIN_FLAGS + [
                  "--engine", "fused_flat"],
              "moe-ffn train fused_pipe": ["--arch", FFN] + TRAIN_FLAGS + [
                  "--engine"] + STREAMED}
FFN_SHAPES = {FFN: dict(t=4096, d=1024, n_experts=64, top_k=4, f=1024,
                        decode_t=8),
              "moe-ffn train": dict(t=2048, d=1024, n_experts=64, top_k=4,
                                    f=1024, decode_t=8)}
DENSE_ATTN = {DENSE: dict(b=8, sq=512, sk=512, hq=16, hkv=8, hd=128),
              f"{DENSE} train": dict(b=4, sq=512, sk=512, hq=16, hkv=8,
                                     hd=128)}
# the group-size-2 flash held at shapes of its own: an odd query length
# against a longer key run, and the query stripe of EP lane 1 of 4 with and
# without a window: (b, sq, sk, hq, hkv, hd, q0, window)
DENSE_FLASH_ODD = ((2, 509, 509, 16, 8, 128, 0, None),
                   (2, 77, 300, 16, 8, 128, 223, None),
                   (4, 128, 512, 16, 8, 128, 128, None),
                   (4, 128, 512, 16, 8, 128, 128, 192))
# the interleaved micro-batch lanes: moe-ffn-stream-1b and moe-tx-stream-1b at
# full width, cut to 4 of their 16 layers (one stream block of all 4),
# through --engine fused_pipe --moe-stream 4 --moe-interleave 2, served 8 x
# 512 (16 generated; four requests a lane) and trained B 4 x S 512 with
# --accum 2 fused into the lanes, traffic on
LANES = 2
LANE_LAYERS = 4
TX = "moe-tx-stream"
LANE_FLAGS = ["--engine", "fused_pipe", "--moe-stream", str(LANE_LAYERS),
              "--moe-interleave", str(LANES), "--layers", str(LANE_LAYERS)]
LANE_SERVE = {f"{a} K {LANES}": ["--arch", a, "--requests", "8",
                                 "--prompt-len", "512", "--gen", "16"]
              + LANE_FLAGS for a in (FFN, TX)}
LANE_TRAINS = {f"{label} train K {LANES}": ["--arch", a] + TRAIN_FLAGS
               + LANE_FLAGS + ["--accum", str(LANES)]
               for label, a in (("moe-ffn", FFN), ("moe-tx", TX))}
# the serve phases of the other engines: (flags, kernels that must launch,
# kernels that must not); disagg's sort and repack passes are plain torch,
# the baseline's own cost, so its path has no gather or scatter-add kernel
DISAGG_PLAIN = ("segment_gather", "segment_scatter_add",
                "segment_scatter_add_bwd")


def engine_argv(arch: str, *engine_flags: str) -> list[str]:
    """A serving path's flags with ``--engine fused_flat`` replaced by
    ``--engine`` and ``engine_flags``."""
    argv = PATHS[arch][0]
    i = argv.index("--engine")
    return argv[:i + 1] + list(engine_flags) + argv[i + 2:]


TX_LAYERS = 16         # moe-tx-stream-1b's layers, all served

ENGINE_SERVE = {
    "qwen3-moe-30b-a3b fused_pipe": (
        engine_argv("qwen3-moe-30b-a3b", "fused_pipe"), SERVE_KERNELS, ()),
    "qwen3-moe-30b-a3b disagg": (
        engine_argv("qwen3-moe-30b-a3b", "disagg"),
        ("fused_swiglu", "flash_attention"), DISAGG_PLAIN[:2]),
    "qwen3-moe-30b-a3b fused_hier": (
        engine_argv("qwen3-moe-30b-a3b", "fused_hier"), SERVE_KERNELS, ()),
    "qwen3-moe-30b-a3b ragged": (
        engine_argv("qwen3-moe-30b-a3b", "ragged"), SERVE_KERNELS, ()),
    "moe-tx-stream fused_pipe": (
        engine_argv("moe-tx-stream", "fused_pipe", "--moe-stream",
                    str(TX_LAYERS)),
        SERVE_KERNELS, ()),
}
# per MoE layer (one shuffle): (gathers, scatter-adds) each engine's code
# launches at EP = 1, S its slice count.  fused_hier and dedup: the stage-1
# gather and the expansion, the pre-combine and the origin sum; ragged: the
# compact send gather, the unpack and the pack-back, and one combine
ENGINE_LAUNCHES = {"fused_flat": lambda s: (1, 1), "fused_pipe": lambda s: (s, s),
                   "disagg": lambda s: (0, 0), "fused_hier": lambda s: (2, 2),
                   "dedup": lambda s: (2, 2), "ragged": lambda s: (3, 1)}
# the qwen3-moe serve runs (2 prefills x 4 layers) of the slice-7 engines
SERVE_LAUNCHES = {
    f"qwen3-moe-30b-a3b {e}": {"segment_gather": 8 * ENGINE_LAUNCHES[e](1)[0],
                               "segment_scatter_add": 8 * ENGINE_LAUNCHES[e](1)[1]}
    for e in ("fused_hier", "ragged")}
# the engine phase: one full-width qwen3-moe MoE layer (fusco.shuffle_ffn) at
# the serve prefill and the train shape through each engine, as (label,
# engine, pipe slices, constants, dedup): slices 0 takes pipesim's count at
# the spec point or at the card's calibrated constants
ENGINES = (("fused_flat", "fused_flat", 0, "spec", False),
           ("fused_pipe auto (spec point)", "fused_pipe", 0, "spec", False),
           ("fused_pipe auto (calibrated)", "fused_pipe", 0, "calibrated", False),
           ("fused_pipe S=1", "fused_pipe", 1, "spec", False),
           ("fused_pipe S=4", "fused_pipe", 4, "spec", False),
           ("disagg", "disagg", 0, "spec", False),
           ("fused_hier", "fused_hier", 0, "spec", False),
           ("fused_flat dedup", "fused_flat", 0, "spec", True),
           ("ragged", "ragged", 0, "spec", False))
# bf16 roundings into y (n of the per-element tolerance (n + 2) u a, see
# engine_rows) of the engines held by tolerance; fused_pipe: min(S, K)
ROUNDINGS = {"disagg": lambda s, k: k, "fused_pipe": lambda s, k: min(s, k),
             "fused_hier": lambda s, k: 3, "dedup": lambda s, k: 3}
# the reduced card-vs-CPU checks, by engine name ("dedup": fused_flat with it)
REDUCED_ENGINES = ("fused_flat", "fused_pipe", "disagg", "fused_hier", "dedup",
                   "ragged")
# the reduced moe-tx train checks: the barriers, and fused_pipe streamed
# over one block of both layers (engine_kwargs)
TX_REDUCED_ENGINES = ("fused_flat", "fused_pipe")
# the reduced checks of the dense family and of moe-ffn (the barriers, and
# fused_pipe streamed over one block of both layers)
NEW_REDUCED = [("qwen3-1.7b", "fused_flat"), ("moe-ffn-stream", "fused_flat"),
               ("moe-ffn-stream", "fused_pipe"),
               # the ssm and hybrid families (no MoE: the engine is ignored)
               ("mamba2-2.7b", "fused_flat"), ("hymba-1.5b", "fused_flat")]
ENGINE_SHAPES = {"serve": PATHS["qwen3-moe-30b-a3b"][1], "train": TRAIN[1]}
# the same layer narrowed for the float32 check (d 256, f 128)
ENGINE_F32 = dict(ENGINE_SHAPES["serve"], d=256, f=128)
# the continuous serving paths (serving.engine.ContinuousServingEngine,
# traffic tracked): the model and its depth (0: all layers), the engine, the
# requests queued before the run, the pool, max_len (its buckets the powers
# of two from 16, and max_len) and the prompt lengths the requests cycle
# through, on bucket boundaries; max_new is drawn from seed 0 in MAX_NEW
CONTINUOUS = {
    "qwen3-moe-30b-a3b continuous": dict(
        arch="qwen3-moe-30b-a3b", layers=4, engine="fused_hier", requests=32,
        max_batch=8, max_len=160, lens=(16, 32, 64, 128)),
    "moe-tx-stream continuous": dict(
        arch="moe-tx-stream", layers=0, engine="fused_flat", requests=16,
        max_batch=8, max_len=544, lens=(64, 128, 256, 512)),
}
MAX_NEW = (8, 32)
# the admission prefills of the qwen3-moe continuous path the kernel rows
# hold: one request of T tokens through fused_hier, and its attention
ADMISSION_T = (16, 128)
ADMISSION_ATTN = dict(b=1, hq=32, hkv=4, hd=128)
# the card-vs-CPU checks of the continuous engine: reduced models in f32
# (arch, engine, lanes); the last, the interleaved stream's admission chunk
CONTINUOUS_CHECKS = (("qwen3-moe-30b-a3b", "fused_flat", 1),
                     ("qwen3-moe-30b-a3b", "fused_hier", 1),
                     ("moe-tx-stream", "fused_flat", 1),
                     ("qwen3-1.7b", "fused_flat", 1),
                     ("moe-ffn-stream", "fused_flat", 1),
                     (FFN, "fused_pipe", LANES),
                     ("mamba2-2.7b", "fused_flat", 1),
                     ("hymba-1.5b", "fused_flat", 1))
TOL_TRAFFIC = 1e-5        # traffic state, card vs CPU, relative to max(1, |x|)
# the time split of the Hopper forms (csrc/hopper.cuh): each is built again
# with the consumers issuing no wgmma, and with the producer loading nothing
SPLIT_KERNELS = ("fused_swiglu", "grouped_matmul", "flash_attention")
SPLIT = {"loads_only_ms": "-DREPRO_LOADS_ONLY",
         "products_only_ms": "-DREPRO_PRODUCTS_ONLY"}
# the query stripe of EP lane 1 of 4 against the gathered keys
SHIFTED = dict(b=8, sq=128, sk=512, hq=16, hkv=4, hd=64, q0=128)
WINDOW = 192

# tolerances on the card, bf16 outputs against the plain versions
TOL_GATHER = 0.0          # a copy: exact
TOL_REL = 1e-2            # f32 sums in another order, then one bf16 rounding:
                          # 1% of the output's largest magnitude (~2 bf16 steps);
                          # flash: 1% of each (batch, query, head) row's largest
                          # |out|, as its rows differ ~10x in magnitude
TOL_LSE = 1e-3            # flash log-sum-exp, f32 in both: sums in another
                          # order and exp2 for exp
TOL_REDUCED = 1e-3        # reduced model in f32, card vs CPU, on logits
TOL_BWD = 2e-2            # backward rows, bf16, against the same backward on
                          # the plain versions: 2% of each gradient's largest
                          # magnitude.  The products round their outputs to
                          # bf16 (h, u, da in the SwiGLU backward; P and dS in
                          # the flash backward; the scatter-add's atomics sum
                          # in another order), so an element may land one bf16
                          # step away and carry it through a second product.
TOL_TRAIN = 1e-4          # reduced train step in f32, card vs CPU: loss, and
                          # each grad leaf relative to max(1, its max |grad|)
                          # (f32 sums in another order, atomics)
BF16_U = 2.0 ** -8        # bf16 unit roundoff
TOL_ENGINE_F32 = 1e-5     # engines against fused_flat in f32 (reduced width),
                          # of the largest |output|: sums in another order


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


class Timing(float):
    """A median device time in ms, with its fastest and slowest round."""

    def __new__(cls, median: float, lo: float, hi: float):
        t = super().__new__(cls, median)
        t.lo, t.hi = lo, hi
        return t


def spread(t) -> str:
    """' [min-max]' of a Timing, '' for a plain number."""
    return f" [{t.lo:.4f}-{t.hi:.4f}]" if hasattr(t, "lo") else ""


def time_ms(fn, reps: int = 10, warmup: int = 2, rounds: int = 5,
            sleep_cycles: int = SLEEP_CYCLES) -> Timing:
    """Device time of one call of ``fn``: CUDA events around ``reps``
    back-to-back calls, divided by ``reps``; the median of ``rounds``, with
    the fastest and slowest round beside it.  Each round is queued behind a
    device-side sleep of ``sleep_cycles``, so the host has issued every call
    before the first event fires and its launch overhead is not timed."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(rounds):
        slept, start, end = (torch.cuda.Event(enable_timing=True)
                             for _ in range(3))
        slept.record()
        torch.cuda._sleep(sleep_cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        issue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if issue_ms > slept.elapsed_time(start):
            raise AssertionError(f"issuing {reps} calls took {issue_ms:.3f} ms, "
                                 "longer than the device sleep ahead of them")
        ts.append(start.elapsed_time(end) / reps)
    return Timing(statistics.median(ts), min(ts), max(ts))


def bound(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    """Least time (ms) for the work and what bounds it."""
    tb, to = nbytes / MEM_BW, ops / peak
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def main_path_inputs(device, t, d, n_experts, top_k, f, decode_t, seed=0):
    """The tensors each kernel meets on the serving main path: routed tokens
    and their routing, the flat plan's descriptors, the landed buffer with
    its real per-expert counts, the expert weights, and the decode
    layout."""
    import torch
    from repro_torch.core.dcomm import _cap
    from repro_torch.core.planner import build_flat_plan
    from repro_torch.core.routing import (ExpertPlacement, router_logits,
                                          top_k_routing)
    bf16 = torch.bfloat16
    g = torch.Generator(device=device).manual_seed(seed)
    randn = lambda *s: torch.randn(s, generator=g, device=device)
    x = randn(t, d).to(bf16)
    router = (randn(d, n_experts) * d ** -0.5).to(bf16)
    w1 = (randn(n_experts, d, f) * d ** -0.5).to(bf16)
    w3 = (randn(n_experts, d, f) * d ** -0.5).to(bf16)
    w2 = (randn(n_experts, f, d) * f ** -0.5).to(bf16)
    cap = _cap(t * top_k / n_experts, 2.0)
    A, gates = top_k_routing(router_logits(x, router), top_k)
    plan = build_flat_plan(A, gates.to(bf16),
                           ExpertPlacement(n_experts, 1, 1), cap)
    counts = plan.slots.counts.clamp(max=cap).to(torch.int32).reshape(1, -1)
    xd = randn(decode_t, d).to(bf16)
    return dict(x=x, w1=w1, w3=w3, w2=w2, cap=cap, counts=counts, A=A,
                route_gates=gates.to(bf16),
                idx=plan.src_of_slot.contiguous(),
                gates=plan.gate_of_slot.float().contiguous(),
                owners=plan.slots.slot.contiguous(),
                decode_rows=xd[None, None].expand(1, n_experts, decode_t, d).contiguous(),
                decode_counts=torch.full((1, n_experts), decode_t,
                                         dtype=torch.int32, device=device))


def time_split(name: str, fn, timer=time_ms, **kw) -> dict:
    """``fn`` (a call of kernel ``name``'s wrapper) timed on the builds of
    ``SPLIT``: its loads alone and its products alone."""
    from repro_torch.kernels import _build
    out = {}
    for key, define in SPLIT.items():
        with _build.use_variant(name, define):
            out[key] = timer(fn, **kw)
    return out


PLAIN_CHUNK = 1 << 28     # weight elements a chunk of experts of the plain
                          # SwiGLU converts to float32 at once


def plain_swiglu(xs, w1, w3, w2, counts):
    """fused_swiglu's plain version, taken over chunks of experts (each
    expert's rows are its own: the same function), so that the float32
    copies of deepseek-v3-bench's 256 experts' weights never exist at
    once."""
    import torch
    from repro_torch.kernels import fused_staging as fs_k
    n_e, d, f = w1.shape
    step = max(1, PLAIN_CHUNK // (d * f))
    if step >= n_e:
        return fs_k.fused_swiglu_plain(xs, w1, w3, w2, counts)
    return torch.cat([fs_k.fused_swiglu_plain(
        xs[:, e:e + step], w1[e:e + step], w3[e:e + step], w2[e:e + step],
        counts[:, e:e + step]) for e in range(0, n_e, step)], dim=1)


def swiglu_row(name, xs, w1, w3, w2, counts, timer=time_ms):
    """fused_swiglu against its plain version on one landed buffer ``xs``
    (S, E, C, d) with its counts: the row (times, bound, the 3 x bmm
    yardstick over all rows, the form it took, and the loads-only and
    products-only times of that form's library) and the kernel's output.
    Fails on the FMA form in bf16."""
    import torch
    from repro_torch.kernels import fused_staging as fs_k
    n_e, d, f = w1.shape
    es = xs.element_size()
    how = fs_k.form(xs, (w1, w3, w2))
    if how == "fma":
        raise AssertionError(f"{name}: bf16 x {tuple(xs.shape)}, f {f} takes "
                             "the FMA form, off the tensor cores")
    y = fs_k.fused_swiglu(xs, w1, w3, w2, counts)
    want = plain_swiglu(xs, w1, w3, w2, counts)
    err = max_err(y, want)
    tol = TOL_REL * want.float().abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{name}: max_abs_err {err} > {tol}")
    c = xs.shape[2]
    live = counts.clamp(max=c)
    live_rows = int(live.sum())
    live_experts = int((live.sum(0) > 0).sum())
    nbytes = (live_experts * 3 * d * f * es + live_rows * d * es
              + xs.numel() * es + counts.numel() * 4)
    b_ms, b_by = bound(nbytes, 6 * d * f * live_rows, BF16_PEAK)
    xb = xs.reshape(-1, n_e, c, d).transpose(0, 1).reshape(n_e, -1, d)

    def bmm_swiglu():
        h = torch.bmm(xb, w1)
        u = torch.bmm(xb, w3)
        return torch.bmm(torch.nn.functional.silu(h) * u, w2)

    row = dict(
        name=name, shape=f"x {tuple(xs.shape)} live rows {live_rows} bf16",
        route="cuda", source="src/repro_torch/csrc/fused_swiglu.cu",
        replaces="src/repro/kernels/fused_staging.py:83",
        max_abs_err=err, tol=tol, form=how,
        ms=timer(lambda: fs_k.fused_swiglu(xs, w1, w3, w2, counts), reps=5),
        plain_ms=timer(lambda: plain_swiglu(xs, w1, w3, w2, counts),
                       reps=3 if how == "wgmma" else 1, warmup=1),
        bound_ms=b_ms, bound_by=b_by,
        library="torch.bmm x3 + silu*mul (all rows, bf16 hidden)",
        library_ms=timer(bmm_swiglu, reps=5),
        # the large-f form's two launches are grouped_matmul.cu's
        **time_split("fused_swiglu" if how == "wgmma" else "grouped_matmul",
                     lambda: fs_k.fused_swiglu(xs, w1, w3, w2, counts), timer,
                     reps=5))
    return row, y


def odd_shape_checks(device="cuda") -> list[str]:
    """The Hopper forms of fused_swiglu, grouped_matmul and the flash
    forward, the flash tensor-core form on the bf16 shapes the Hopper form
    refuses, and the scatter-add's forward (both paths) and backward,
    against their plain versions at the shapes the main paths do not give
    them.  fused_swiglu and grouped_matmul: C = 8
    (decode), C = 2 and 1 (fused_pipe slices), a C that is not a
    multiple of the row tile, counts of 0, of C
    and of more than C, a partial last tile, S = 2 source lanes sharing E
    weights (g % E), and d, f, K, N that are not multiples of the tiles;
    grouped_matmul with row-major weights (MN-major loads) and with a
    transposed view (K-major loads); bf16, held to TOL_REL of each output's
    largest magnitude.  The flash cases as ``flash_row`` holds them.  The
    scatter-add also over fused_pipe's per-slice owner tables.  Returns one
    line per case."""
    import torch
    from repro_torch.kernels import fused_staging as fs_k
    from repro_torch.kernels import grouped_matmul as gmm_k
    g = torch.Generator(device=device).manual_seed(3)
    randn = lambda *s: torch.randn(s, generator=g, device=device)
    bf16 = torch.bfloat16
    lines = []

    def hold(what, got, want):
        err = max_err(got, want)
        tol = TOL_REL * want.float().abs().max().item()
        if not err <= tol:
            raise AssertionError(f"{what}: max_abs_err {err} > {tol}")
        lines.append(f"{what}: max_abs_err {err:.4g} (tol {tol:.4g})")

    # fused_swiglu: (S, E, C, d, f, counts)
    for s_, e, c, d, f, counts in (
            (1, 4, 8, 512, 256, [[0, 3, 8, 12]]),
            (1, 4, 2, 2048, 768, [[0, 1, 2, 5]]),     # fused_pipe slices
            (1, 3, 1, 512, 256, [[0, 1, 4]]),
            (2, 3, 100, 384, 320, [[0, 100, 130], [64, 65, 37]]),
            (1, 2, 70, 136, 72, [[70, 5]])):
        x = randn(s_, e, c, d).to(bf16)
        w1 = (randn(e, d, f) * d ** -0.5).to(bf16)
        w3 = (randn(e, d, f) * d ** -0.5).to(bf16)
        w2 = (randn(e, f, d) * f ** -0.5).to(bf16)
        cnt = torch.tensor(counts, dtype=torch.int32, device=device)
        if not fs_k.use_tensor_cores(x, (w1, w3, w2)):
            raise AssertionError(f"fused_swiglu S{s_} E{e} C{c} d{d} f{f}: "
                                 "not taken by the Hopper form")
        hold(f"fused_swiglu S {s_} E {e} C {c} d {d} f {f} counts {counts}",
             fs_k.fused_swiglu(x, w1, w3, w2, cnt),
             fs_k.fused_swiglu_plain(x, w1, w3, w2, cnt))

    # grouped_matmul: (S, E, C, K, N, counts), both weight layouts
    for s_, e, c, k, n, counts in (
            (2, 2, 8, 200, 136, [0, 3, 8, 20]),
            (2, 3, 100, 64, 264, [0, 100, 130, 64, 65, 37]),
            (2, 1, 300, 96, 8, [300, 129])):
        x = randn(s_ * e, c, k).to(bf16)
        cnt = torch.tensor(counts, dtype=torch.int32, device=device)
        row_major = (randn(e, k, n) * k ** -0.5).to(bf16)
        view = (randn(e, n, k) * k ** -0.5).to(bf16).transpose(1, 2)
        for w, layout in ((row_major, "row-major w"), (view, "transposed view")):
            hold(f"grouped_matmul G {s_ * e} E {e} C {c} K {k} N {n} {layout} "
                 f"counts {counts}", gmm_k.grouped_matmul(x, w, cnt),
                 gmm_k.grouped_matmul_plain(x, w, cnt))

    # flash: the Hopper form with ragged Sq and Sk, G 1 / 4 / 8, windows, a
    # shifted stripe, hd 64 and 128; at G 3, 5, 6 and 7 (query tiles of
    # hopper_tiles(G): 21, 12, 10, 9 queries, rows of the 64-row tile left
    # dead) an Sq off the tile, a ragged Sk, a shifted stripe and B > 1, with
    # and without a binding window, at hd 64 and 128; then the tensor-core
    # form on the bf16 shapes the Hopper form refuses (hd 16 and 32, the
    # reduced models' hd 16 at their (Sq, G)): (B, Sq, Sk, Hq, Hkv, hd,
    # first query position, window), every query at or below the last
    # key's position
    from repro_torch.kernels import flash_attention as fa_k
    for b_, sq, sk, hq, hkv, hd, q0, window in (
            (2, 50, 77, 4, 4, 64, 27, None), (1, 100, 100, 16, 4, 64, 0, 40),
            (1, 128, 512, 16, 4, 64, 128, 192), (2, 33, 200, 16, 2, 128, 167, None),
            (1, 130, 130, 32, 4, 128, 0, None), (1, 64, 70, 8, 8, 128, 6, 16),
            (1, 128, 512, 12, 4, 64, 128, 192), (2, 33, 200, 10, 2, 128, 167, None),
            (2, 37, 77, 6, 2, 64, 40, 24), (2, 101, 150, 3, 1, 128, 49, None),
            (2, 101, 130, 10, 2, 64, 29, 48), (3, 37, 200, 5, 1, 128, 163, None),
            (2, 37, 100, 12, 2, 64, 63, 20), (2, 101, 230, 48, 8, 128, 129, None),
            (1, 37, 333, 6, 1, 128, 296, 70),
            (2, 101, 177, 14, 2, 64, 76, 40), (2, 37, 70, 56, 8, 128, 33, None),
            (1, 101, 300, 7, 1, 128, 199, 90),
            # hymba's G 5 at hd 64: the window binding over 2048 queries,
            # an Sq off the 12-query tile against a longer, shifted Sk
            (1, 2048, 2048, 25, 5, 64, 0, 1024),
            (2, 101, 230, 25, 5, 64, 129, 64),
            (4, 16, 16, 4, 2, 16, 0, None), (2, 50, 77, 8, 4, 16, 27, 16),
            (1, 100, 100, 8, 4, 32, 0, 40)):
        form = ("tensor-core" if fa_k.hopper_refusal(hd, hq, hkv, sk)
                else "Hopper")
        what = (f"flash ({form} form) B {b_} Sq {sq} at {q0}.. Sk {sk} G "
                f"{hq // hkv} hd {hd} window {window}")
        if form == "Hopper" and hq // hkv not in (1, 2, 4, 8):
            qc, live = fa_k.hopper_tiles(hq // hkv)
            what += f" (tiles of {qc} queries, {live} of 64 rows live)"
        _, _, err, tol, worst, err_lse = hold_flash(
            what, *attention_inputs(device, b_, sq, sk, hq, hkv, hd, q0, seed=4),
            window)
        lines.append(f"{what}: max_abs_err {err:.4g} (tol {tol:.4g}), worst row "
                     f"{worst:.3f} of its tolerance, lse {err_lse:.4g}")

    # segment_scatter_add and its backward: no owners (the counting build)
    # and an owner table, f32 and bf16, d off the 16-byte vector, rows with
    # no owner
    from repro_torch.kernels import segment_scatter_add as s_k
    for r, t, d, dtype in ((40, 7, 100, torch.float32), (64, 16, 24, bf16),
                           (10, 30, 64, bf16), (33, 5, 36, bf16)):
        src = randn(r, d).to(dtype)
        dst = torch.randint(-1, t, (r,), generator=g, device=device,
                            dtype=torch.int32)
        gates = torch.rand(r, generator=g, device=device)
        dout = randn(t, d).to(dtype)
        table = s_k.owner_table(*s_k.build_owners_plain(dst, t))
        want = s_k.segment_scatter_add_plain(src, dst, gates, t)
        what = f"segment_scatter_add R {r} -> {t} d {d} {dtype}"
        hold(f"{what} (counting build)", s_k.segment_scatter_add(src, dst, gates, t),
             want)
        hold(f"{what} (owner table)", s_k.segment_scatter_add(src, dst, gates, t,
                                                              table), want)
        for part, got, plain in zip(
                ("dsrc", "dgates"), s_k.segment_scatter_add_bwd(src, dst, gates, dout),
                s_k.segment_scatter_add_bwd_plain(src, dst, gates, dout)):
            hold(f"{what} backward {part}", got, plain)

    # the owner-reduce over fused_pipe's per-slice owner tables (a flat plan
    # of 64 tokens, 8 experts, top-2, capacity 16, in 8 slices of 2 rows)
    from repro_torch.core import planner
    from repro_torch.core.routing import ExpertPlacement
    t, e, k, cap, n_s, d = 64, 8, 2, 16, 8, 136
    placement = ExpertPlacement(e, 1, 1)
    A = torch.stack([torch.randperm(e, generator=g, device=device)[:k]
                     for _ in range(t)]).to(torch.int32)
    plan = planner.build_flat_plan(A, torch.rand(t, k, generator=g,
                                                 device=device).to(bf16),
                                   placement, cap)
    sliced = planner.slice_flat_plan(plan, placement, cap, n_s)
    owners = planner.slice_owner_table(plan.slots.slot, cap, n_s)
    for i in (0, 3, n_s - 1):
        src = randn(e * cap // n_s, d).to(bf16)
        dst, gates = sliced.src[i].reshape(-1), sliced.gate[i].reshape(-1).float()
        hold(f"segment_scatter_add over slice {i} of {n_s}'s owner table "
             f"({src.shape[0]} rows -> {t}, d {d})",
             s_k.segment_scatter_add(src, dst, gates, t, owners[i]),
             s_k.segment_scatter_add_plain(src, dst, gates, t))
    return lines


def sass_counts() -> dict:
    """``cuobjdump -sass`` of the libraries of the Hopper forms
    (fused_swiglu, grouped_matmul, flash_attention): the number of HGMMA
    (wgmma) and UTMALDG (TMA load) instructions in each.  Fails if either is
    0."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    out = {}
    for name in SPLIT_KERNELS:
        sass = subprocess.run([str(tool), "-sass", str(_build.library_path(name))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        out[name] = {op: sum(op in line for line in sass.splitlines())
                     for op in ("HGMMA", "UTMALDG")}
        if 0 in out[name].values():
            raise AssertionError(f"{name}: SASS counts {out[name]}")
    return out


def ptxas_report() -> tuple[list[str], list[str]]:
    """One line per compiled kernel from the ``-Xptxas -v`` build logs
    (registers, shared memory, spill stores / loads), and the Hopper-form
    kernels (``*_wgmma``) that spill."""
    import shutil
    from repro_torch.kernels import _build
    found = []                      # [library, mangled name, report]
    for k in _build.KERNELS:
        log = _build.library_path(k).with_suffix(".log")
        for line in log.read_text().splitlines() if log.exists() else ():
            if "Compiling entry function" in line:
                found.append([k, line.split("'")[1], {}])
            elif found and (m := re.search(
                    r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
                found[-1][2]["spills"] = (int(m.group(1)), int(m.group(2)))
            elif found and (m := re.search(r"Used (\d+) registers", line)):
                smem = re.search(r"(\d+) bytes smem", line)
                found[-1][2]["registers"] = int(m.group(1))
                found[-1][2]["smem"] = int(smem.group(1)) if smem else 0
    names = [name for _, name, _ in found]
    if names and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    lines, spilling = [], []
    for (k, mangled, rep), name in zip(found, names):
        spills = rep.get("spills", (0, 0))
        short = name.replace("void ", "").replace("(anonymous namespace)::", "")
        lines.append(f"  ptxas {k}: {short.split('(')[0]}: {rep.get('registers')} "
                     f"registers, {rep.get('smem')} B static smem, spill "
                     f"stores/loads {spills[0]}/{spills[1]} B")
        if "wgmma" in mangled and spills != (0, 0):
            spilling.append(name)
    return lines, spilling


def kernel_phase(inp, timer=time_ms, fma=True, decode=True,
                 counting=True) -> list[dict]:
    """Each MoE kernel against its plain version at a serving path's shapes
    (``main_path_inputs``); ``fma`` also holds and times fused_swiglu's FMA
    variant, ``decode`` fused_swiglu at the decode shape, ``counting`` the
    combine without owner lists.  Returns one row per kernel and shape,
    without the launch counts."""
    import torch
    from repro_torch.kernels import fused_staging as fs_k

    x, idx = inp["x"], inp["idx"]
    w1, w3, w2 = inp["w1"], inp["w3"], inp["w2"]
    t, d = x.shape
    n_e = w1.shape[0]

    # segment_gather: src (T, d), idx (R,)
    row, got = gather_row(x, idx, timer)
    rows = [row]

    # fused_swiglu at the prefill shape (real counts) and the decode shape
    buf = got.reshape(1, n_e, inp["cap"], d)
    swiglus = [("fused_swiglu", buf, inp["counts"])]
    if decode:
        swiglus.append(("fused_swiglu_decode", inp["decode_rows"],
                        inp["decode_counts"]))
    for name, xs, counts in swiglus:
        row, y = swiglu_row(name, xs, w1, w3, w2, counts, timer)
        rows.append(row)
        if name == "fused_swiglu":
            expert_out = y
        if name == "fused_swiglu" and fma:
            # the FMA form (what the kernel takes off the Hopper path), held
            # and timed at the same shape for comparison
            want = fs_k.fused_swiglu_plain(xs, w1, w3, w2, counts)
            fma = lambda: fs_k._launch_fma(xs, w1, w3, w2, counts,
                                           torch.empty_like(xs))
            y_fma = torch.empty_like(xs)
            fs_k._launch_fma(xs, w1, w3, w2, counts, y_fma)
            err_fma = max_err(y_fma, want)
            if not err_fma <= row["tol"]:
                raise AssertionError(f"fused_swiglu FMA form: max_abs_err "
                                     f"{err_fma} > {row['tol']}")
            rows.append(dict({k: v for k, v in row.items() if k not in SPLIT},
                             name="fused_swiglu_fma", main_path=False,
                             max_abs_err=err_fma, ms=timer(fma, reps=5)))

    # segment_scatter_add: (R, d) -> T rows, gated, over the plan's owners
    return rows + scatter_rows(expert_out.reshape(-1, d), inp, t, timer,
                               counting)


def gather_row(x, idx, timer=time_ms) -> tuple[dict, object]:
    """segment_gather of ``x`` (T, d) by ``idx`` (R,) against its plain
    version (exact): the row (times, bound, ``index_select``) and the
    kernel's output."""
    import torch
    from repro_torch.kernels import segment_gather as g_k
    t, d = x.shape
    es = x.element_size()
    got = g_k.segment_gather(x, idx)
    err = max_err(got, g_k.segment_gather_plain(x, idx))
    if err > TOL_GATHER:
        raise AssertionError(f"segment_gather: max_abs_err {err} > {TOL_GATHER}")
    r = idx.shape[0]
    live_src = int(torch.unique(idx[idx >= 0]).numel())
    b_ms, b_by = bound(r * 4 + live_src * d * es + r * d * es, 0, F32_PEAK)
    safe_idx = idx.clamp_min(0).long()
    return dict(
        name="segment_gather", shape=f"src ({t}, {d}) idx ({r},) bf16",
        route="cuda", source="src/repro_torch/csrc/segment_gather.cu",
        replaces="src/repro/kernels/segment_gather.py:38",
        max_abs_err=err, tol=TOL_GATHER,
        ms=timer(lambda: g_k.segment_gather(x, idx)),
        plain_ms=timer(lambda: g_k.segment_gather_plain(x, idx)),
        bound_ms=b_ms, bound_by=b_by,
        library="torch.index_select (no zero rows for -1)",
        library_ms=timer(lambda: torch.index_select(x, 0, safe_idx))), got


def hier_kernel_rows(inp, timer=time_ms) -> list[dict]:
    """fused_hier's gathers and scatter-adds at ``inp``'s shape (EP = 1:
    one node, its forwarder this lane), from the engine's own plans
    (``dcomm.hier_dispatch``): the stage-1 gather (T -> C1 rows, one a
    token), the expansion (C1 -> E x C2 rows, one an assignment), the
    pre-combine of the gated expert outputs over the stage-2 slot table and
    the origin sum over the stage-1 one, each held against its plain
    version and timed (``gather_row``, ``scatter_rows``).  fused_flat with
    dedup runs the same four at the same shapes."""
    import torch
    from repro_torch.core import dcomm
    from repro_torch.core.routing import ExpertPlacement
    from repro_torch.kernels import fused_staging as fs_k
    from repro_torch.kernels import segment_scatter_add as s_k
    x, w = inp["x"], (inp["w1"], inp["w3"], inp["w2"])
    t, d = x.shape
    res = dcomm.hier_dispatch(x, inp["A"], inp["route_gates"],
                              ExpertPlacement(w[0].shape[0], 1, 1),
                              dcomm.DcommConfig(engine="fused_hier"))
    plan1, plan2, _, _, c1, _, _ = res.state
    stage1, buf1 = gather_row(x, plan1.src_of_slot, timer)
    expand, buf2 = gather_row(buf1, plan2.src_of_slot, timer)
    out = (fs_k.fused_swiglu(buf2.reshape(res.expert_rows.shape), *w, res.counts)
           * res.row_gates[..., None].to(x.dtype)).reshape(-1, d)
    ones = lambda n: torch.ones(n, dtype=torch.float32, device=x.device)
    pre = scatter_rows(out, dict(idx=plan2.src_of_slot, gates=ones(out.shape[0]),
                                 owners=plan2.slots.slot), c1, timer, False)[0]
    part = s_k.segment_scatter_add(out, plan2.src_of_slot, ones(out.shape[0]), c1,
                                   plan2.slots.slot)
    origin = scatter_rows(part, dict(idx=plan1.src_of_slot, gates=ones(c1),
                                     owners=plan1.slots.slot), t, timer, False)[0]
    return [dict(r, shape=f"fused_hier {what}: {r['shape']}")
            for r, what in ((stage1, "stage 1"), (expand, "expansion"),
                            (pre, "pre-combine"), (origin, "origin"))]


def ragged_kernel_rows(inp, timer=time_ms) -> list[dict]:
    """ragged's unpack gather (the landed compact rows into the expert
    buffer) and its pack-back gather (the expert outputs into landed
    compact order) at ``inp``'s shape, from the engine's own state
    (``dcomm.ragged_dispatch``), held and timed; its send gather and its
    combine are fused_flat's shapes."""
    from repro_torch.core import dcomm
    from repro_torch.core.routing import ExpertPlacement
    from repro_torch.kernels import fused_staging as fs_k
    from repro_torch.kernels import segment_gather as g_k
    x, w = inp["x"], (inp["w1"], inp["w3"], inp["w2"])
    d = x.shape[1]
    res = dcomm.ragged_dispatch(x, inp["A"], inp["route_gates"],
                                ExpertPlacement(w[0].shape[0], 1, 1),
                                dcomm.DcommConfig(engine="ragged"))
    desc, _, unpack, landed_slot, _, _ = res.state
    landed = g_k.segment_gather(x, desc.compact_src)
    unpack_row, unpacked = gather_row(landed, unpack, timer)
    out = fs_k.fused_swiglu(unpacked.reshape(res.expert_rows.shape), *w,
                            res.counts).reshape(-1, d)
    back = gather_row(out, landed_slot, timer)[0]
    return [dict(unpack_row, shape=f"ragged unpack: {unpack_row['shape']}"),
            dict(back, shape=f"ragged pack-back: {back['shape']}")]


def same_bits(a, b) -> bool:
    """a and b hold the same bytes."""
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def scatter_rows(src, inp, t, timer=time_ms, counting=True) -> list[dict]:
    """segment_scatter_add at one shape: the owner-reduce over the flat
    plan's slot table (the main path) against the plain owner-reduce and
    the reference's scatter-add, two calls bitwise equal (gated, and with
    the unit gates of the gather's backward); then the path of a
    caller with no owners (the counting build, then the reduce), its lists
    equal to the plain build's, its output held against the main path's
    and bitwise repeatable (held and timed, not on the main path; only
    with ``counting``)."""
    import torch
    from repro_torch.kernels import segment_scatter_add as s_k
    idx, gates, owners = inp["idx"], inp["gates"], inp["owners"]
    r, d = src.shape
    es = src.element_size()
    got = s_k.segment_scatter_add(src, idx, gates, t, owners)
    ones = torch.ones_like(gates)     # as the gather's backward calls it
    unit = lambda: s_k.segment_scatter_add(src, idx, ones, t, owners)
    if not (same_bits(got, s_k.segment_scatter_add(src, idx, gates, t, owners))
            and same_bits(unit(), unit())):
        raise AssertionError(f"segment_scatter_add ({r}, {d}) -> {t}: two "
                             "calls differ (gated, or with unit gates)")
    want = s_k.owner_reduce_plain(src, gates, owners, t)
    oracle = s_k.segment_scatter_add_plain(src, idx, gates, t)
    tol = TOL_REL * oracle.float().abs().max().item()
    err, err_oracle = max_err(got, want), max_err(got, oracle)
    if not (err <= tol and err_oracle <= tol):
        raise AssertionError(f"segment_scatter_add: max_abs_err {err} against "
                             f"the plain owner-reduce, {err_oracle} against "
                             f"the scatter-add, tol {tol}")
    live_rows = int((idx >= 0).sum())
    b_ms, b_by = bound(live_rows * (d * es + 4) + owners.numel() * 4
                       + t * d * es, 2 * live_rows * d, F32_PEAK)
    dump = torch.where(idx < 0, t, idx).long()
    scaled = src.float() * gates[:, None]
    acc = torch.zeros(t + 1, d, device=src.device)
    row = dict(
        name="segment_scatter_add", shape=f"src ({r}, {d}) -> ({t}, {d}) bf16",
        route="cuda", source="src/repro_torch/csrc/segment_scatter_add.cu",
        replaces="src/repro/kernels/segment_scatter_add.py:37",
        max_abs_err=err, tol=tol,
        ms=timer(lambda: s_k.segment_scatter_add(src, idx, gates, t, owners)),
        plain_ms=timer(lambda: s_k.owner_reduce_plain(src, gates, owners, t),
                       reps=3, warmup=1),
        bound_ms=b_ms, bound_by=b_by,
        library="Tensor.index_add_ (f32, pre-gated rows, dump row for -1)",
        library_ms=timer(lambda: acc.index_add_(0, dump, scaled)))
    if not counting:
        return [row]
    # no owners: the counting build on the card
    offsets, lists = s_k.build_owners(idx, t)
    p_off, p_lists = s_k.build_owners_plain(idx, t)
    if not (torch.equal(offsets, p_off)
            and torch.equal(lists[:p_lists.numel()], p_lists)):
        raise AssertionError("segment_scatter_add: the counting build's lists "
                             "differ from the plain build's")
    counted = s_k.segment_scatter_add(src, idx, gates, t)
    err_c = max_err(counted, got)
    if not (err_c <= tol and same_bits(
            counted, s_k.segment_scatter_add(src, idx, gates, t))):
        raise AssertionError(f"segment_scatter_add without owners: "
                             f"max_abs_err {err_c} (tol {tol}) against the "
                             "owners path, or two calls differ")
    counting = dict(row, name="segment_scatter_add_counting", main_path=False,
                    shape=row["shape"] + " (no owners: counting build + reduce)",
                    max_abs_err=err_c,
                    ms=timer(lambda: s_k.segment_scatter_add(src, idx, gates, t)),
                    plain_ms=timer(lambda: s_k.segment_scatter_add_plain(
                        src, idx, gates, t), reps=3, warmup=1))
    return [row, counting]


def attention_inputs(device, b, sq, sk, hq, hkv, hd, q0=0, seed=0):
    """bf16 q/k/v and int32 positions of an attention call: queries at
    positions q0 .. q0 + sq - 1 against keys at 0 .. sk - 1."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    randn = lambda *s: torch.randn(s, generator=g, device=device).to(torch.bfloat16)
    return (randn(b, sq, hq, hd), randn(b, sk, hkv, hd), randn(b, sk, hkv, hd),
            torch.arange(q0, q0 + sq, dtype=torch.int32, device=device),
            torch.arange(sk, dtype=torch.int32, device=device))


def hold_flash(what, q, k, v, qp, kp, window, causal=True):
    """The flash kernel against its plain version on one attention call
    (causal, or with ``causal`` False every key seen); returns (output,
    lse, max_abs_err, its tolerance, worst row's share of its tolerance,
    lse error)."""
    from repro_torch.kernels import flash_attention as fa_k
    out, lse = fa_k.flash_attention(q, k, v, qp, kp, causal, window)
    want, want_lse = fa_k.flash_attention_plain(q, k, v, qp, kp, causal,
                                                window)
    err = max_err(out, want)
    # each row held to 1% of its own largest |out|: the first query rows see
    # one key (|out| up to ~4), most rows average hundreds (~10x smaller)
    row_err = (out.float() - want.float()).abs().amax(-1)
    row_tol = TOL_REL * want.float().abs().amax(-1)
    worst_row = (row_err / row_tol).max().item()
    err_lse = max_err(lse, want_lse)
    if not (worst_row <= 1.0 and err_lse <= TOL_LSE):
        raise AssertionError(f"{what}: worst row error {worst_row} of "
                             f"its row's tolerance (max_abs_err {err}), lse "
                             f"{err_lse} (tol {TOL_LSE})")
    return out, lse, err, row_tol.max().item(), worst_row, err_lse


def flash_row(q, k, v, qp, kp, window, timer=time_ms, causal=True) -> dict:
    """The flash kernel against its plain version on one attention call:
    output and lse, times, the bound, its time split and the SDPA
    yardsticks: causal, with the boolean mask from the positions, and,
    where the positions are plain aranges over one length and there is no
    window, with ``is_causal=True`` and no mask (SDPA's flash backend);
    with ``causal`` False (an encoder's self-attention, a cross-attention
    over encoder keys) and no window, SDPA with no mask."""
    import torch
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels.ref import attention_mask
    out, lse, err, tol, worst_row, err_lse = hold_flash(
        "flash_attention", q, k, v, qp, kp, window, causal)
    b, sq, hq, hd = q.shape
    g = hq // k.shape[2]
    es = q.element_size()
    mask = attention_mask(qp, kp, causal, window)
    tc = fa_k.hopper_refusal(hd, hq, k.shape[2], k.shape[1]) is not None
    visible = int(mask.sum()) * b * hq
    nbytes = ((q.numel() + k.numel() + v.numel() + out.numel()) * es
              + lse.numel() * 4 + (qp.numel() + kp.numel()) * 4)
    b_ms, b_by = bound(nbytes, 4 * hd * visible, BF16_PEAK)
    # yardstick: one SDPA call in its (B, H, S, hd) layout, kv heads repeated
    # for the groups and the mask built from the positions
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).repeat_interleave(g, dim=1).contiguous()
    vt = v.transpose(1, 2).repeat_interleave(g, dim=1).contiguous()
    no_mask = not causal and window is None
    library = ("F.scaled_dot_product_attention (no mask, kv heads repeated)"
               if no_mask else "F.scaled_dot_product_attention (bool mask "
               "from positions, kv heads repeated)")
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=None if no_mask else mask)
    call = lambda: fa_k.flash_attention(q, k, v, qp, kp, causal, window)
    arange = torch.arange(sq, dtype=qp.dtype, device=qp.device)
    extra = {}
    if causal and (window is None or window >= k.shape[1]) \
            and k.shape[1] == sq and torch.equal(qp, arange) \
            and torch.equal(kp, arange):
        extra["library_causal_ms"] = timer(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True))
    plateau = (qp[1:] == qp[:-1]).any().item()
    row = dict(
        name="flash_attention",
        shape=(f"q ({b}, {sq}, {hq}, {hd}) at {int(qp[0])}.."
               f"{' (plateaus)' if plateau else ''} k ({k.shape[1]}, "
               f"{k.shape[2]}) window {window} "
               f"{'causal' if causal else 'bidirectional'} bf16"),
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:97",
        max_abs_err=err, tol=tol, max_abs_err_lse=err_lse,
        worst_row_share=worst_row,
        ms=timer(call),
        plain_ms=timer(lambda: fa_k.flash_attention_plain(q, k, v, qp, kp,
                                                          causal, window),
                       reps=3, warmup=1),
        bound_ms=b_ms, bound_by=b_by, library=library,
        library_ms=timer(sdpa), **extra, form="mma.sync" if tc else "wgmma",
        # the time split builds the Hopper form without its loads or its
        # products; the mma.sync form has no such variant
        **({} if tc else time_split("flash_attention", call, timer)))
    return row


def counters():
    from repro_torch.kernels import (flash_attention, fused_staging,
                                     grouped_matmul, segment_gather,
                                     segment_scatter_add)
    return {"segment_gather": segment_gather.segment_gather,
            "segment_scatter_add": segment_scatter_add.segment_scatter_add,
            "segment_scatter_add_bwd":
                segment_scatter_add.segment_scatter_add_bwd,
            "fused_swiglu": fused_staging.fused_swiglu,
            "flash_attention": flash_attention.flash_attention,
            "grouped_matmul": grouped_matmul.grouped_matmul}


def zero_counters() -> dict:
    wrappers = counters()
    for w in wrappers.values():
        w.launches = 0
    forms = getattr(wrappers["fused_swiglu"], "forms", {})
    for k in forms:
        forms[k] = 0
    return wrappers


def no_fma_swiglu(what: str) -> dict:
    """fused_swiglu's launches by form since the counters were zeroed;
    fails if a bf16 path ran the FMA form."""
    from repro_torch.kernels import fused_staging
    forms = dict(getattr(fused_staging.fused_swiglu, "forms", {}))
    if forms.get("fma"):
        raise AssertionError(f"{what}: fused_swiglu ran the FMA form "
                             f"{forms['fma']} times, off the tensor cores "
                             f"({forms})")
    return forms


def family_kernels(cfg, train: bool) -> tuple[tuple, tuple]:
    """(kernels that must launch, kernels that must not) on a path of
    ``cfg``'s family: the flash forward where it has attention, the MoE
    kernels where it has MoE (grouped_matmul and the scatter-add's backward
    in training only; serving launches neither)."""
    from repro_torch.models import lm
    attn, moe = lm.has_attention(cfg), cfg.moe is not None
    moe_k = MOE_KERNELS if train else SERVE_KERNELS[:3]
    return ((("flash_attention",) if attn else ()) + (moe_k if moe else ()),
            (() if attn else ("flash_attention",)) + (() if moe else MOE_KERNELS))


def serve_phase(argv, device="cuda", required=SERVE_KERNELS, absent=()):
    """The main path once, with every launch counter zeroed just before it
    and read just after; fails if a kernel of ``required`` never launched
    or one of ``absent`` did.  Returns the serve result and the counts."""
    import torch
    from repro_torch.launch import serve
    args = serve.parse_args(argv)
    wrappers = zero_counters()
    out = serve.run(args, device=device)
    launches = {k: w.launches for k, w in wrappers.items()}
    out["swiglu_forms"] = no_fma_swiglu(f"serve {' '.join(argv)}")
    never = [k for k in required if launches[k] == 0]
    stray = [k for k in absent if launches[k]]
    if never or stray:
        raise AssertionError(f"main path never launched {never}, or launched "
                             f"{stray} off its path: {launches}")
    toks, logits = out["tokens"], out["logits"]
    vocab = out["cfg"].vocab
    if toks.shape != (args.requests, args.gen):
        raise AssertionError(f"tokens {tuple(toks.shape)}")
    if not (bool(((toks >= 0) & (toks < vocab)).all())
            and bool(torch.isfinite(logits).all())
            and logits.shape == (args.requests, vocab)):
        raise AssertionError("serve produced non-finite logits or bad tokens")
    return out, launches


def profile_phase(argv, device="cuda") -> dict:
    """Where a serve step's device time goes: after a warm-up, one prefill
    and one decode step of the serve path, each under torch.profiler
    (:func:`profile_once`).
    Returns per step the host's wall time under the profiler, the device's
    busy time (the union of its activities' intervals) and the device time
    by kernel, most first; None for a step whose trace shows no device
    activity."""
    import torch
    from repro_torch.launch import serve
    s = serve.setup(serve.parse_args(argv), device)
    prefill = lambda: s.bundle.prefill(s.params, s.batch, s.max_len)
    out = {}
    with torch.inference_mode():
        logits, state = prefill()
        tok = logits.argmax(-1)
        decode = lambda: s.bundle.decode_step(s.params, state, tok, s.max_len)
        decode()
        torch.cuda.synchronize()
        out["prefill"] = profile_once(prefill)
        out["decode"] = profile_once(decode)
    return out


def device_summary(prof, wall_ms: float) -> dict | None:
    """The device's busy time in a torch.profiler trace (the union of its
    activities' intervals) and its time by kernel, most first; None when the
    trace shows no device activity."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return None
    busy_us, reach, by_name = 0.0, float("-inf"), {}
    for a, b, name in spans:
        busy_us += max(0.0, b - max(a, reach))
        reach = max(reach, b)
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3
    return dict(wall_ms=wall_ms, busy_ms=busy_us / 1e3, activities=len(spans),
                by_kernel=sorted(by_name.items(), key=lambda kv: -kv[1]))


def reduced_bf16_runs(device="cuda") -> dict:
    """``serve.run`` and ``train.run`` of each path's reduced model on the
    card in their default bf16: their head dim 16
    sends attention to the flash tensor-core form.  The serve and train
    phases' checks, and every flash launch through
    ``flash_attention_fwd_tc``.  Returns the launch counts per run."""
    from repro_torch.kernels import _build
    runs, entries, bind = {}, [], _build.bind

    def recording(name, fn, *a):
        entries.append(fn)
        return bind(name, fn, *a)

    _build.bind = recording
    try:
        for arch in PATHS:
            runs[f"serve {arch}"] = serve_phase(
                ["--arch", arch, "--reduced", "--engine", "fused_flat",
                 "--requests", "3", "--prompt-len", "8", "--gen", "4"],
                device)[1]
        for arch in PATHS:
            runs[f"train {arch}"] = train_phase(
                ["--arch", arch, "--reduced", "--engine", "fused_flat",
                 "--steps", "3", "--seq", "32", "--batch", "2"], device)[1]
    finally:
        _build.bind = bind
    flash = {e for e in entries if e.startswith("flash_attention_fwd")}
    if flash != {"flash_attention_fwd_tc"}:
        raise AssertionError(f"reduced bf16 runs: flash entries {flash}, "
                             "expected the tensor-core form alone")
    return runs


# the capacity factor of the reduced checks at more than one lane: no row is
# dropped at one lane or at K (whose per-lane capacities differ), so both
# compute one function, and a chunk's left-pad rows take no real row's place
LANE_CAPACITY = 8.0


def lane_capacity(lanes: int) -> dict:
    """``lm.make_context``'s capacity option of a reduced check at
    ``lanes`` lanes (``LANE_CAPACITY`` above one; else the default)."""
    return dict(capacity_factor=LANE_CAPACITY) if lanes > 1 else {}


def engine_kwargs(engine: str, cfg, lanes: int = 1) -> dict:
    """``lm.make_context``'s engine options of a reduced check: fused_pipe at
    4 slices, the moe_tx or moe_ffn layers in one streamed block, ``lanes``
    micro-batch lanes round-robin through it; "dedup" is fused_flat with
    the condensed wire."""
    if engine == "dedup":
        return dict(engine="fused_flat", dedup=True)
    if engine != "fused_pipe":
        return dict(engine=engine)
    return dict(engine=engine, pipe_slices=4, moe_interleave=lanes,
                moe_stream=(cfg.n_layers if cfg.family in ("moe_tx", "moe_ffn")
                            else 0))


def reduced_check(arch: str, device="cuda", engine="fused_flat",
                  lanes: int = 1, against=("cpu", 1)) -> float:
    """The reduced model (float32) on the card through the kernels against
    the same model on ``against``'s device at its lane count (default: the
    CPU through the plain versions, one lane), both through ``engine``, the
    card's stream at ``lanes`` (``engine_kwargs``; more than one lane on
    either side: both at ``lane_capacity``): prefill (4 requests) and three
    decode steps fed the same tokens.  Returns the max logit error."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    cfg = get_arch(arch).reduced()
    f32 = torch.float32
    ref_dev, ref_lanes = against
    extra = lane_capacity(max(lanes, ref_lanes))
    ctxs = {side: lm.make_context(cfg, dev, compute_dtype=f32,
                                  **engine_kwargs(engine, cfg, k), **extra)
            for side, dev, k in (("ref", ref_dev, ref_lanes),
                                 ("card", device, lanes))}
    params = lm.init_params(cfg, lm.make_context(cfg, "cpu"),
                            torch.Generator().manual_seed(0), dtype=f32)
    move = lambda t, dev: ({k: move(v, dev) for k, v in t.items()}
                           if isinstance(t, dict) else t.to(dev))
    tokens = torch.randint(0, cfg.vocab, (4, 16),
                           generator=torch.Generator().manual_seed(1))
    max_len = 20

    def run(side, feed):
        ctx = ctxs[side]
        dev = ctx.device
        p = move(params, dev)
        logits, st = lm.prefill(p, tokens.to(dev), torch.arange(16, device=dev),
                                ctx, max_len)
        seq = [logits.cpu()]
        for tok in feed or [None] * 3:
            tok = logits.argmax(-1).cpu() if tok is None else tok
            logits, st = lm.decode_step(p, st, tok.to(dev), ctx, max_len)
            seq.append(logits.cpu())
        return seq

    ref = run("ref", None)
    fed = [lg.argmax(-1) for lg in ref[:-1]]
    worst = max(max_err(a, b) for a, b in zip(ref, run("card", fed)))
    if not worst <= TOL_REDUCED:
        raise AssertionError(f"reduced {arch} {engine} card at {lanes} lanes "
                             f"vs {ref_dev} at {ref_lanes}: {worst} > "
                             f"{TOL_REDUCED}")
    return worst


def gmm_rows(inp, timer=time_ms) -> list[dict]:
    """grouped_matmul against its plain version at a training shape: the
    landed buffer (every expert x the capacity, the rows routing fills)
    times w1 (d -> f, the h and u products of the SwiGLU backward), and
    f-wide rows times the transposed view of w1 (f -> d, the dx products),
    with torch.bmm over all rows as the yardstick."""
    import torch
    from repro_torch.kernels import grouped_matmul as gmm_k
    from repro_torch.kernels.ref import segment_gather_ref
    x, w1, cap = inp["x"], inp["w1"], inp["cap"]
    n_e, d, f = w1.shape
    counts = inp["counts"].reshape(-1)
    landed = segment_gather_ref(x, inp["idx"]).reshape(n_e, cap, d)
    g = torch.Generator(device=x.device).manual_seed(1)
    dh = torch.randn((n_e, cap, f), generator=g, device=x.device).to(x.dtype)
    es = x.element_size()
    live = counts.clamp(max=cap)
    live_rows, live_experts = int(live.sum()), int((live > 0).sum())
    rows = []
    for a, w, what in ((landed, w1, "x @ w1"), (dh, w1.transpose(1, 2),
                                                "dh @ w1^T (view)")):
        got = gmm_k.grouped_matmul(a, w, counts)
        want = gmm_k.grouped_matmul_plain(a, w, counts)
        err = max_err(got, want)
        tol = TOL_REL * want.float().abs().max().item()
        if not err <= tol:
            raise AssertionError(f"grouped_matmul {what}: max_abs_err {err} > {tol}")
        k, n = w.shape[1], w.shape[2]
        nbytes = (live_experts * k * n * es + live_rows * k * es
                  + a.shape[0] * cap * n * es + counts.numel() * 4)
        b_ms, b_by = bound(nbytes, 2 * k * n * live_rows, BF16_PEAK)
        rows.append(dict(
            name="grouped_matmul",
            shape=f"{what}: ({n_e}, {cap}, {k}) -> {n}, live rows {live_rows} bf16",
            route="cuda", source="src/repro_torch/csrc/grouped_matmul.cu",
            replaces="src/repro/kernels/grouped_matmul.py:60",
            max_abs_err=err, tol=tol,
            ms=timer(lambda: gmm_k.grouped_matmul(a, w, counts)),
            plain_ms=timer(lambda: gmm_k.grouped_matmul_plain(a, w, counts),
                           reps=3, warmup=1),
            bound_ms=b_ms, bound_by=b_by, library="torch.bmm (all rows)",
            library_ms=timer(lambda: torch.bmm(a, w)),
            **time_split("grouped_matmul",
                         lambda: gmm_k.grouped_matmul(a, w, counts), timer)))
    return rows


def train_swiglu_row(inp, timer=time_ms) -> dict:
    """fused_swiglu at a training forward's shape: the landed buffer (every
    expert x the capacity) with the rows routing fills."""
    from repro_torch.kernels.ref import segment_gather_ref
    x, w1, cap = inp["x"], inp["w1"], inp["cap"]
    n_e, d, _ = w1.shape
    xs = segment_gather_ref(x, inp["idx"]).reshape(1, n_e, cap, d)
    return swiglu_row("fused_swiglu_train", xs, w1, inp["w3"], inp["w2"],
                      inp["counts"], timer)[0]


def backward_rows(inp, attn, timer=time_ms, device="cuda") -> list[dict]:
    """Each autograd Function's backward on the card (``torch.autograd.grad``
    through ``kernels.ops``, the kernels inside) against the same backward
    on the plain versions (``ref.*_bwd``, the SwiGLU's on the plain grouped
    matmul; for flash, from the plain forward's output and lse), at the
    training shapes: the MoE kernels' at ``inp`` and the flash backward at
    ``attn`` (either None: a path without it); times of the backward alone
    (the graph is kept), of the plain backward, and of torch's autograd
    through a library forward."""
    rows = [] if inp is None else _moe_backward_rows(inp, timer)
    if attn is not None:
        rows.append(_flash_backward_row(
            attn, timer, device if inp is None else inp["x"].device))
    return rows


def _leaf(v):
    return v.detach().clone().requires_grad_()


def _back(out, inputs, cot):
    """A call of the backward of ``out`` w.r.t. ``inputs`` (graph kept)."""
    import torch
    return lambda: torch.autograd.grad(out, inputs, cot, retain_graph=True)


def _backward_row(name, parts, got, want, nbytes, ops_, ms, plain, library,
                  lib_ms, kernel=None, *, timer) -> dict:
    """One backward row: each part held to TOL_BWD of its want's largest
    magnitude, the bound, the plain backward's time; ``kernel`` (route,
    source, replaces) for a backward with a kernel of its own."""
    errs = {}
    for k, a, b in zip(parts, got, want):
        err = max_err(a, b)
        tol = TOL_BWD * b.float().abs().max().item()
        if not err <= tol:
            raise AssertionError(f"{name} {k}: max_abs_err {err} > {tol}")
        errs[k] = (err, tol)
    b_ms, b_by = bound(nbytes, ops_, BF16_PEAK)
    out = dict(name=name, parts=errs, ms=ms,
               plain_ms=timer(plain, reps=3, warmup=1), bound_ms=b_ms,
               bound_by=b_by, library=library, library_ms=lib_ms)
    if kernel is not None:
        out.update(kernel, max_abs_err=max(e for e, _ in errs.values()))
    return out


def _moe_backward_rows(inp, timer) -> list[dict]:
    """The gather's, the scatter-add's and the fused SwiGLU's backward rows
    at ``inp``'s training shape (``backward_rows``)."""
    import torch
    from repro_torch.kernels import ops, ref
    x, idx, gates = inp["x"], inp["idx"], inp["gates"]
    w1, w3, w2, cap, counts = inp["w1"], inp["w3"], inp["w2"], inp["cap"], inp["counts"]
    t, d = x.shape
    n_e, _, f = w1.shape
    r = idx.shape[0]
    es = x.element_size()
    dev = x.device
    g = torch.Generator(device=dev).manual_seed(2)
    randn = lambda *s: torch.randn(s, generator=g, device=dev).to(x.dtype)
    leaf, back = _leaf, _back
    row = lambda *a, **kw: _backward_row(*a, timer=timer, **kw)
    rows = []
    live_rows = int((idx >= 0).sum())
    safe_idx = idx.clamp_min(0).long()
    owners = inp["owners"]
    # gather: the backward is the scatter-add of the cotangent, unit gates,
    # over the plan's owners (as flat_dispatch passes them)
    src, dout = leaf(x), randn(r, d)
    out = ops.segment_gather(src, idx, owners)
    ones = torch.ones(r, device=dev)
    lib_src = leaf(x)
    lib_out = torch.index_select(lib_src, 0, safe_idx)
    got = back(out, src, dout)()
    if not same_bits(got[0], back(out, src, dout)()[0]):
        raise AssertionError("segment_gather backward: two calls differ")
    rows.append(row(
        "segment_gather backward", ("dsrc",), got,
        (ref.segment_scatter_add_ref(dout, idx, ones, t),),
        live_rows * d * es + r * 4 + t * d * es, live_rows * d,
        timer(back(out, src, dout)),
        lambda: ref.segment_scatter_add_ref(dout, idx, ones, t),
        "autograd of index_select (index_add_)",
        timer(back(lib_out, lib_src, dout))))
    del out, lib_out
    # scatter-add: the gather of the cotangent times the gates, and dgates
    buf = ref.segment_gather_ref(x, idx)
    src, gts, dout = leaf(buf), leaf(gates), randn(t, d)
    out = ops.segment_scatter_add(src, idx, gts, t, owners)
    plain = lambda: ref.segment_scatter_add_bwd(buf, idx, gates, dout)
    lib_src, lib_g = leaf(buf), leaf(gates)
    dump = torch.where(idx < 0, t, idx).long()
    lib_out = torch.zeros(t + 1, d, device=dev).index_add(
        0, dump, lib_src.float() * lib_g[:, None])[:t]
    got = back(out, (src, gts), dout)()
    again = back(out, (src, gts), dout)()
    if not all(same_bits(a, b) for a, b in zip(got, again)):
        raise AssertionError("segment_scatter_add backward: two calls differ")
    # what the one pass must move: dst, and dgates written, for every row;
    # for a live row its gate and its src row read (a dropped row reads
    # neither: its dsrc is written as zeros); each dout row some live row
    # lands on read once; dsrc written
    n_dst = int(torch.unique(idx[idx >= 0]).numel())
    rows.append(row(
        "segment_scatter_add backward", ("dsrc", "dgates"), got, plain(),
        n_dst * d * es + r * 8 + live_rows * (d * es + 4) + r * d * es,
        3 * live_rows * d,
        timer(back(out, (src, gts), dout)), plain,
        "autograd of index_add (f32, pre-gated rows)",
        timer(back(lib_out, (lib_src, lib_g), dout.float())),
        dict(route="cuda", source="src/repro_torch/csrc/segment_scatter_add.cu",
             replaces="src/repro/kernels/ops.py:93 (_scatter_bwd: the gather "
                      "of src/repro/kernels/segment_gather.py:56, then jnp)")))
    del out, lib_out, buf
    # fused SwiGLU: the recompute, its products on the grouped matmul
    xs = ref.segment_gather_ref(x, idx).reshape(1, n_e, cap, d)
    leaves = [leaf(v) for v in (xs, w1, w3, w2)]
    out = ops.fused_swiglu(*leaves, counts)
    dy = randn(1, n_e, cap, d)
    plain = lambda: ref.fused_swiglu_bwd(xs, w1, w3, w2, counts, dy,
                                         gmm=ref.grouped_matmul_ref)
    live = counts.clamp(max=cap)
    live_n, live_e = int(live.sum()), int((live > 0).sum())
    lib = [leaf(v) for v in (xs.reshape(n_e, cap, d), w1, w3, w2)]
    lib_out = torch.bmm(torch.nn.functional.silu(torch.bmm(lib[0], lib[1]))
                        * torch.bmm(lib[0], lib[2]), lib[3])
    rows.append(row(
        "fused_swiglu backward", ("dx", "dw1", "dw3", "dw2"),
        back(out, leaves, dy)(), plain(),
        3 * live_e * d * f * es + 2 * live_n * d * es + xs.numel() * es
        + 3 * n_e * d * f * es, 16 * d * f * live_n,
        timer(back(out, leaves, dy), reps=3), plain,
        "autograd of 3 x torch.bmm + silu*mul (all rows)",
        timer(back(lib_out, lib, dy.reshape(n_e, cap, d)), reps=3)))
    return rows


def _flash_backward_row(attn, timer, device) -> dict:
    """The flash backward's row at the attention shape ``attn``: the
    blockwise recompute from the forward's lse (``backward_rows``)."""
    import torch
    from repro_torch.kernels import ops, ref
    q, k, v, qp, kp = attention_inputs(device, **attn)
    es = q.element_size()
    g = torch.Generator(device=q.device).manual_seed(2)
    randn = lambda *s: torch.randn(s, generator=g, device=q.device).to(q.dtype)
    leaf, back = _leaf, _back
    leaves = [leaf(a) for a in (q, k, v)]
    out = ops.flash_attention(*leaves, qp, kp, True, None)
    dout = randn(*out.shape)
    p_out, p_lse = ref.flash_attention_ref(q, k, v, qp, kp, True, None)
    plain = lambda: ref.flash_attention_bwd(q, k, v, qp, kp, p_out, p_lse,
                                            dout, True, None)
    from repro_torch.kernels.ref import attention_mask
    mask = attention_mask(qp, kp, True, None)
    b, sq, hq, hd = q.shape
    visible = int(mask.sum()) * b * hq
    grp = hq // k.shape[2]
    lib = [leaf(a.transpose(1, 2)) for a in (q, k, v)]
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        lib[0], lib[1].repeat_interleave(grp, dim=1),
        lib[2].repeat_interleave(grp, dim=1), attn_mask=mask)
    return _backward_row(
        "flash_attention backward", ("dq", "dk", "dv"),
        back(out, leaves, dout)(), plain(),
        (2 * q.numel() + 2 * k.numel() + 2 * v.numel() + 2 * out.numel()) * es
        + p_lse.numel() * 4, 10 * hd * visible,
        timer(back(out, leaves, dout), reps=3), plain,
        "autograd of F.scaled_dot_product_attention (bool mask, kv heads "
        "repeated)",
        timer(back(lib_out, lib, dout.transpose(1, 2)), reps=3), timer=timer)


def train_rows(inp, attn, timer=time_ms) -> list[dict]:
    """The forward kernels of a train step at its shapes: the dispatch
    gather, grouped_matmul in both weight layouts, fused_swiglu's forward,
    the flash forward (``attn`` None: a path without attention) and the
    combine."""
    from repro_torch.kernels.ref import segment_gather_ref
    x, idx = inp["x"], inp["idx"]
    rows = [gather_row(x, idx, timer)[0]]
    rows += gmm_rows(inp, timer)
    rows.append(train_swiglu_row(inp, timer))
    if attn is not None:
        rows.append(flash_row(*attention_inputs(x.device, **attn),
                              window=None, timer=timer))
    return rows + scatter_rows(segment_gather_ref(x, idx), inp, x.shape[0],
                               timer)


def backward_report(inp, attn, path: str, timer=time_ms,
                    device="cuda") -> list[dict]:
    """``backward_rows`` at a train shape, printed; returns the kernel rows
    of the backwards with a kernel of their own (the scatter-add's)."""
    out = []
    for r in backward_rows(inp, attn, timer, device):
        parts = ", ".join(f"{k} {e:.4g} (tol {t:.4g})"
                          for k, (e, t) in r["parts"].items())
        print(f"backward {r['name']:<29} at the {path} shape: max_abs_err "
              f"{parts}  {r['ms']:.4f} ms{spread(r['ms'])}  plain "
              f"{r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})  library {r['library_ms']:.4f} ms"
              f"{spread(r['library_ms'])} [{r['library']}]")
        if "source" in r:      # a backward with a kernel of its own
            (t, d), n = inp["x"].shape, inp["idx"].shape[0]
            out.append(dict(r, name="segment_scatter_add_bwd", path=path,
                            shape=f"train backward: dout ({t}, {d}) -> dsrc "
                                  f"({n}, {d}), dgates ({n},) bf16"))
    return out


def traffic_cost_phase(argv, rounds: int = 4) -> dict:
    """One train step of ``argv``'s run threading a traffic state and one
    without, in turns (``host_ms``), then each once under torch.profiler:
    the host ms (median) and the device busy ms of each."""
    import torch
    from repro_torch.data.pipeline import to_device
    from repro_torch.launch import steps, train
    from repro_torch.models import zoo
    from repro_torch.optim import adamw
    args = train.parse_args(argv)
    s = train.setup(args, "cuda")
    step = steps.make_train_step(zoo.build(s.cfg, s.ctx), s.opt_cfg)
    params, opt = s.params, adamw.init(s.params)
    batch = to_device(s.source.batch_at(0), "cuda")
    state = train.init_traffic(s.cfg, s.ctx, args.accum)

    def run(*extra):
        step(params, opt, batch, *extra)
        torch.cuda.synchronize()

    fns = {"with traffic": lambda: run(state), "without": run}
    host = host_ms(*fns.values(), rounds=rounds)
    out = {}
    for (name, fn), ms in zip(fns.items(), host):
        p = profile_once(fn)
        out[name] = dict(host_ms=ms, busy_ms=None if p is None else p["busy_ms"],
                         activities=None if p is None else p["activities"])
    return out


def wall_ms(fn, rounds: int = 5) -> Timing:
    """Host-clock time of one call of ``fn`` up to the device's last
    result (``torch.cuda.synchronize()``): what a caller waits for, launch
    overhead included; the median of ``rounds`` after one warm-up call."""
    import torch
    fn()
    ts = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return Timing(statistics.median(ts), min(ts), max(ts))


def engine_device_ms(fn) -> Timing:
    """Device time of one engine call (``time_ms`` of one call a round),
    behind a device sleep four times the host's time to issue it: an engine
    issues hundreds of launches."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    issue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = max(SLEEP_CYCLES, int(4 * issue_ms * 2e6))   # ~2e6 cycles a ms
    return time_ms(fn, reps=1, warmup=0, sleep_cycles=cycles)


def engine_config(engine: str, slices: int, point: str, table,
                  dedup: bool = False):
    from repro_torch.core import calibrate
    from repro_torch.core.dcomm import DcommConfig
    cfg = DcommConfig(engine=engine, pipe_slices=slices, dedup=dedup)
    return calibrate.apply(table, cfg) if point == "calibrated" else cfg


def tx_stream_geometry(t, d, n_experts, top_k, cfg,
                       attn=None) -> tuple[int, int]:
    """(capacity, S) of a moe-tx stream of TX_LAYERS layers at ``cfg``'s
    constants, as ``fusco.tx_layer_stream`` plans it: pipesim's streamed
    knee, the attention proxy at the attention shape ``attn`` (default: the
    serve prefill's)."""
    from repro_torch.core import dcomm, fusco
    from repro_torch.core.routing import ExpertPlacement
    a = attn or PATHS["moe-tx-stream"][2]
    attn_s = fusco._tx_attn_cost_s(t, a["sq"], a["b"], a["sk"], a["hq"],
                                   a["hd"], 2, cfg)
    return dcomm.pipe_geometry(t, top_k, d, 2, ExpertPlacement(n_experts, 1, 1),
                               cfg, n_layers=TX_LAYERS, attn_s=attn_s)


def pipe_config(arch: str):
    """The DcommConfig of ``arch``'s fused_pipe serve phase, its slice count
    frozen as that path freezes it: pipesim's one-layer knee at the spec
    point for qwen3-moe, the streamed knee for moe-tx."""
    import dataclasses
    cfg = engine_config("fused_pipe", 0, "spec", None)
    if arch == "moe-tx-stream":
        shape = PATHS[arch][1]
        _, s = tx_stream_geometry(shape["t"], shape["d"], shape["n_experts"],
                                  shape["top_k"], cfg)
        cfg = dataclasses.replace(cfg, pipe_slices=s)
    return cfg


def tx_train_pipe_config():
    """The DcommConfig of the streamed moe-tx train phase, its slice count
    frozen as the stream freezes it, and (capacity, S)."""
    import dataclasses
    cfg = engine_config("fused_pipe", 0, "spec", None)
    shape = TX_TRAIN[1]
    cap, s = tx_stream_geometry(shape["t"], shape["d"], shape["n_experts"],
                                shape["top_k"], cfg, attn=TX_TRAIN[2])
    return dataclasses.replace(cfg, pipe_slices=s), (cap, s)


def ffn_pipe_config(t: int):
    """The DcommConfig of a streamed moe-ffn phase (``FFN_LAYERS`` layers a
    block) at ``t`` tokens, its slice count frozen as
    ``fusco.pipe_layer_stream`` freezes it (pipesim's joint knee,
    ``plan_layer_stream``), and (capacity, S)."""
    import dataclasses
    from repro_torch.core import dcomm
    from repro_torch.core.routing import ExpertPlacement
    cfg = engine_config("fused_pipe", 0, "spec", None)
    sh = FFN_SHAPES[FFN]
    cap, s = dcomm.pipe_geometry(t, sh["top_k"], sh["d"], 2,
                                 ExpertPlacement(sh["n_experts"], 1, 1), cfg,
                                 n_layers=FFN_LAYERS)
    return dataclasses.replace(cfg, pipe_slices=s), (cap, s)


def lane_plan(argv, train: bool) -> dict:
    """What the code plans for an interleaved serve (``train`` False) or
    train path of ``argv``: the model's config, the lanes K, each lane's
    batch rows and tokens, the (capacity, S) every lane's shuffles share
    (``dcomm.pipe_geometry`` of one lane at the spec point, as
    ``fusco.interleaved_layer_stream`` and ``tx_layer_stream`` plan it:
    ``--pipe-slices``, or pipesim's interleaved knee, with the attention
    proxy of one lane for moe_tx), the DcommConfig with that S frozen, the MoE shapes of one lane
    (``main_path_inputs``) and its attention shape (None without), and
    what the run does: streamed forwards (2 prefills, or the steps),
    decode steps (``serve.run``: 2 warm-up and gen - 1 timed) and stream
    blocks."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.core import dcomm, fusco
    from repro_torch.core.routing import ExpertPlacement
    from repro_torch.launch import serve, train as train_lib
    from repro_torch.models import lm
    args = (train_lib if train else serve).parse_args(argv)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    k = args.moe_interleave
    rows, seq = ((args.batch, args.seq) if train
                 else (args.requests, args.prompt_len))
    bc = rows // k
    t = bc * seq
    dcfg = engine_config("fused_pipe", args.pipe_slices, "spec", None)
    moe = cfg.moe
    attn, attn_s = None, 0.0
    if lm.has_attention(cfg):
        attn = dict(b=bc, sq=seq, sk=seq, hq=cfg.n_heads, hkv=cfg.n_kv_heads,
                    hd=cfg.hd)
        attn_s = fusco._tx_attn_cost_s(t, seq, bc, seq, cfg.n_heads, cfg.hd,
                                       2, dcfg)
    cap, s = dcomm.pipe_geometry(t, moe.top_k, cfg.d_model, 2,
                                 ExpertPlacement(moe.n_experts, 1, 1), dcfg,
                                 n_layers=args.moe_stream, interleave=k,
                                 attn_s=attn_s)
    return dict(cfg=cfg, lanes=k, rows=bc, t=t, cap=cap, slices=s,
                dcfg=dataclasses.replace(dcfg, pipe_slices=s),
                shapes=dict(t=t, d=cfg.d_model, n_experts=moe.n_experts,
                            top_k=moe.top_k, f=moe.d_ff_expert, decode_t=8),
                attn=attn, passes=args.steps if train else 2,
                decode=0 if train else args.gen + 1,
                blocks=cfg.n_layers // args.moe_stream)


def lane_launches(plan: dict, train: bool) -> dict:
    """The launches of each kernel that the code of an interleaved path
    implies (``lane_plan``): every lane of every layer of every streamed
    forward runs S slices, each a gather, a fused_swiglu and a scatter-add
    (S - 1 in its shuffle, its tail in the lane's next prologue or the
    block's epilogue); each lane of each block first lands an empty tail
    (one scatter-add more); moe_tx runs its attention once a lane; a
    decode step runs one fused_swiglu a layer.  Training adds, per slice,
    the gather's backward (a scatter-add), the scatter-add's own backward
    and the five grouped_matmul products of the SwiGLU backward."""
    lane_layers = plan["passes"] * plan["cfg"].n_layers * plan["lanes"]
    sl = lane_layers * plan["slices"]
    tails = plan["passes"] * plan["lanes"] * plan["blocks"]
    return {"segment_gather": sl,
            "segment_scatter_add": sl + tails + (sl if train else 0),
            "segment_scatter_add_bwd": sl if train else 0,
            "fused_swiglu": sl + plan["decode"] * plan["cfg"].n_layers,
            "flash_attention": lane_layers if plan["attn"] else 0,
            "grouped_matmul": 5 * sl if train else 0}


def lane_rows(plan: dict, train: bool, timer=time_ms,
              device="cuda") -> tuple[list, str]:
    """The kernels at an interleaved path's lane shapes: the three MoE
    kernels at every slice of one lane's shuffle (``pipe_slice_rows`` on a
    lane's T tokens at the lane plan's frozen S, slice 0 timed), in
    training grouped_matmul at slice 0's shape (the SwiGLU backward's
    products), and the flash forward at one lane's attention shape.
    Returns the rows and ``pipe_slice_rows``' line."""
    from repro_torch.core import dcomm
    from repro_torch.core.routing import ExpertPlacement
    inp = main_path_inputs(device, **plan["shapes"], seed=2)
    rows, line = pipe_slice_rows(inp, plan["dcfg"], timer)
    if train:
        pp = dcomm._pipe_slice_plan(
            inp["x"], inp["A"], inp["route_gates"],
            ExpertPlacement(plan["shapes"]["n_experts"], 1, 1), plan["dcfg"],
            None)
        first = dict(inp, cap=pp.cap // pp.n_slices,
                     counts=pp.counts[0].contiguous(),
                     idx=pp.sliced.src[0].reshape(-1).contiguous())
        rows += [dict(r, shape=f"slice 0 of {pp.n_slices}: {r['shape']}")
                 for r in gmm_rows(first, timer)]
    if plan["attn"] is not None:
        rows.append(flash_row(*attention_inputs(device, **plan["attn"]),
                              window=None, timer=timer))
    return rows, line


def dense_flash_rows(timer=time_ms, device="cuda") -> tuple[list, list]:
    """qwen3-1.7b's flash forward, group size 2 (each 64-row tile of
    ``flash_fwd_wgmma`` packs 32 positions x 2 heads, and the block skipping
    reads each row's own position), at its serve prefill and train shapes
    (``flash_row``: timed beside SDPA), and held at ``DENSE_FLASH_ODD``: an
    odd query length, a query run ending at the keys' end, a shifted EP
    stripe with and without a window.  Returns the rows and one line per
    held shape."""
    rows = [dict(flash_row(*attention_inputs(device, **a), window=None,
                           timer=timer), path=path)
            for path, a in DENSE_ATTN.items()]
    lines = []
    for b, sq, sk, hq, hkv, hd, q0, window in DENSE_FLASH_ODD:
        what = (f"q ({b}, {sq}, {hq}, {hd}) at {q0}.. k ({sk}, {hkv}) window "
                f"{window}")
        _, _, err, tol, worst, err_lse = hold_flash(
            f"flash_attention {what}",
            *attention_inputs(device, b, sq, sk, hq, hkv, hd, q0, seed=5),
            window)
        lines.append(f"{what}: max_abs_err {err:.4g}, worst row {worst:.3f} "
                     f"of its row's tolerance, lse {err_lse:.4g}")
    return rows, lines


def untimed(fn, **kw) -> float:
    """A timer that runs nothing: for the slices that are held, not timed."""
    return 0.0


def pipe_slice_rows(inp, cfg, timer=time_ms) -> tuple[list[dict], str]:
    """fused_pipe's kernels at its slices' shapes: the engine's own plan of
    ``inp``'s routing at ``cfg``'s slice count (``dcomm._pipe_slice_plan``:
    each slice's src, gates, landed counts and owner table).  Every slice's
    gather (exact), fused_swiglu on the slice's counts and owner-reduce over
    the slice's owner table are held against their plain versions with
    ``kernel_phase``'s checks at TOL_REL; slice 0, the fullest, is timed.
    Each slice's fused_swiglu must also give, bit for bit, its rows of one
    launch over the whole landed buffer: the kernel is row-local, which
    ``engine_rows`` takes as given.  Returns slice 0's rows and a line on
    all slices."""
    import torch
    from repro_torch.core import dcomm
    from repro_torch.core.routing import ExpertPlacement
    from repro_torch.kernels import fused_staging as fs_k
    from repro_torch.kernels import segment_gather as g_k
    x, w = inp["x"], (inp["w1"], inp["w3"], inp["w2"])
    t, d = x.shape
    n_e = w[0].shape[0]
    pp = dcomm._pipe_slice_plan(x, inp["A"], inp["route_gates"],
                                ExpertPlacement(n_e, 1, 1), cfg, None)
    n_s, cs = pp.n_slices, pp.cap // pp.n_slices
    landed = lambda idx, c: g_k.segment_gather(x, idx).reshape(1, n_e, c, d)
    whole = fs_k.fused_swiglu(landed(pp.plan.src_of_slot, pp.cap), *w,
                              pp.counts.sum(0).to(torch.int32))
    first, share = [], {}
    for s in range(n_s):
        sl = dict(inp, cap=cs, counts=pp.counts[s].contiguous(),
                  idx=pp.sliced.src[s].reshape(-1).contiguous(),
                  gates=pp.sliced.gate[s].reshape(-1).float().contiguous(),
                  owners=pp.owners[s].contiguous())
        got = kernel_phase(sl, timer if s == 0 else untimed, fma=False,
                           decode=False, counting=False)
        for r in got:
            worst = r["max_abs_err"] / r["tol"] if r["tol"] else r["max_abs_err"]
            share[r["name"]] = max(share.get(r["name"], 0.0), worst)
        y = fs_k.fused_swiglu(landed(sl["idx"], cs), *w, sl["counts"])
        if not same_bits(y, whole[:, :, s * cs:(s + 1) * cs]):
            raise AssertionError(f"fused_swiglu on slice {s} of {n_s}: not the "
                                 "bits of its rows in one launch over the "
                                 "whole buffer")
        if s == 0:
            first = [dict(r, shape=f"slice 0 of {n_s}: {r['shape']}")
                     for r in got]
    line = (f"T {t}, S {n_s} (Cs {cs}): all {n_s} slices held; worst "
            f"max_abs_err over its tolerance: " + ", ".join(
                f"{k} {v:.4g}" for k, v in share.items())
            + "; each slice's fused_swiglu the bits of its rows of one "
            "launch over the whole buffer")
    return first, line


@contextlib.contextmanager
def swiglu_counts():
    """Within the block, each call of the grouped FFN's entry
    (``kernels.ops.fused_swiglu``, one fused_swiglu launch on the card)
    first appends its counts argument to the yielded list: the occupancy of
    each launch.  The kernel wrapper and its launch counter stay as they
    are."""
    from repro_torch.kernels import ops
    seen, entry = [], ops.fused_swiglu

    def recording(x, w1, w3, w2, counts=None):
        seen.append(counts.clone())
        return entry(x, w1, w3, w2, counts)

    ops.fused_swiglu = recording
    try:
        yield seen
    finally:
        ops.fused_swiglu = entry


@contextlib.contextmanager
def host_syncs():
    """Within the block, every operation that makes the host wait on the
    card (``torch.cuda.set_sync_debug_mode``: a copy to or from pageable
    memory, ``.item()``, ``nonzero``) appends its warning's text to the
    yielded list.  A serving engine over a data group all-gathers a few
    ints (the argmax) beside each of its host reads; on gloo ranks that
    collective stages them through the host and waits on the card in
    gloo's own thread, which this does not see (NCCL waits on none)."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield (seen := [])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    seen += [f"{w.filename}:{w.lineno}: {w.message}" for w in caught
             if "called a synchronizing" in str(w.message)]


def engine_rows(inp, table, timer=engine_device_ms, wall=wall_ms) -> list[dict]:
    """One full-width MoE layer (``fusco.shuffle_ffn``, the layer a model
    runs) through each of ``ENGINES`` at the shape of ``inp``: its slice
    count and what chose it, its fused_swiglu launches and the expert weight
    bytes they read (live experts x 3 x d x f x 2 per launch, from the
    counts each launch was given), its device time and host-clock time, and
    its output against fused_flat's; its gather and scatter-add launches
    must be ``ENGINE_LAUNCHES``'.

    S = 1 and ragged must give fused_flat's bits: their FFN meets the same
    rows, and their combine sums each token's gated rows in fused_flat's
    order over an owner table in k order.  The other engines are held in
    bf16 element by element to (n + 2) u a, where u is bf16's unit roundoff
    and a = sum over the token's rows of |gate x expert output| (fused_flat's
    plan, one fused_swiglu launch: the kernel is row-local, so every engine
    meets the same expert outputs, as ``pipe_slice_rows`` checks).  fused_flat
    rounds y once (u a).  fused_pipe rounds each slice's combine once (u a
    over all slices) and each addition into y (u a each), with n = min(S,
    K) slices holding a row of the token; disagg rounds its K gated
    products (u a) and their sum, n = K; fused_hier and dedup round each
    product gate x expert output at the expert (u a), each wire row's
    pre-reduced partial (u a) and the token's sum (u a), n = 3
    (``ROUNDINGS``).  One term more covers the float32 sums.  A dropped or
    doubled row of a token moves its element by |gate x expert output|, at
    least a / K for the token's largest row."""
    from repro_torch.core import dcomm, fusco
    from repro_torch.core.routing import ExpertPlacement
    from repro_torch.kernels import fused_staging as fs_k
    from repro_torch.kernels import segment_gather as g_k
    from repro_torch.kernels import segment_scatter_add as s_k
    x, A, gates = inp["x"], inp["A"], inp["route_gates"]
    w1, w3, w2 = inp["w1"], inp["w3"], inp["w2"]
    t, d = x.shape
    n_e, _, f = w1.shape
    k = A.shape[1]
    placement = ExpertPlacement(n_e, 1, 1)
    e = fs_k.fused_swiglu(g_k.segment_gather(x, inp["idx"]).reshape(
        1, n_e, inp["cap"], d), w1, w3, w2, inp["counts"])
    a = s_k.segment_scatter_add_plain(e.float().abs().reshape(-1, d),
                                      inp["idx"], inp["gates"].abs(), t)
    rows, flat = [], None
    for label, engine, slices, point, dedup in ENGINES:
        cfg = engine_config(engine, slices, point, table, dedup)
        kind = "dedup" if dedup else engine
        call = lambda: fusco.shuffle_ffn(x, A, gates, w1, w3, w2, placement, cfg)
        wrappers = zero_counters()
        with swiglu_counts() as counts, host_syncs() as syncs:
            y = call()
        launches = {name: w.launches for name, w in wrappers.items()}
        if syncs:          # the device timing below cannot hide a wait
            raise AssertionError(f"engine {label}: the host waits on the card "
                                 f"in a layer: {syncs[:3]}")
        if engine == "fused_pipe":
            cap, s = dcomm.pipe_geometry(t, k, d, x.element_size(), placement,
                                         cfg)
        else:
            cap, s = inp["cap"], 1
        if launches["fused_swiglu"] != s or len(counts) != s:
            raise AssertionError(f"engine {label}: {launches['fused_swiglu']} "
                                 f"fused_swiglu launches ({len(counts)} "
                                 f"recorded), {s} slices")
        moved = (launches["segment_gather"], launches["segment_scatter_add"])
        if moved != ENGINE_LAUNCHES[kind](s):
            raise AssertionError(f"engine {label}: (gathers, scatter-adds) "
                                 f"{moved}, its code implies "
                                 f"{ENGINE_LAUNCHES[kind](s)}")
        live = sum(int((c.sum(0) > 0).sum()) for c in counts)
        err = max_err(y, flat) if flat is not None else 0.0
        tol = share = 0.0
        if flat is None:
            flat = y
        elif (engine == "fused_pipe" and s == 1) or engine == "ragged":
            if not same_bits(y, flat):
                raise AssertionError(f"engine {label}: not fused_flat's bits "
                                     f"(max_abs_err {err})")
        else:
            n = ROUNDINGS[kind](s, k)
            bound_y = (n + 2) * BF16_U * a
            diff = (y.float() - flat.float()).abs()
            if not bool((diff <= bound_y).all()):
                i = int(((diff - bound_y) / bound_y.clamp_min(1e-30)).argmax())
                raise AssertionError(
                    f"engine {label}: element {divmod(i, d)} differs from "
                    f"fused_flat's by {diff.flatten()[i].item()} > (n + 2) u a "
                    f"= {bound_y.flatten()[i].item()} (n {n})")
            tol = bound_y.max().item()
            share = (diff / bound_y.clamp_min(1e-30)).max().item()
        rows.append(dict(
            label=label, engine=engine, dedup=dedup, t=t, slices=s,
            slice_rows=cap // s,
            capacity=cap, constants=point if engine == "fused_pipe" and
            not slices else None,
            swiglu_launches=launches["fused_swiglu"], live_expert_launches=live,
            weight_bytes=live * 3 * d * f * w1.element_size(),
            launches=launches, max_abs_err=err, tol=tol, tol_share=share,
            ms=timer(call), wall_ms=wall(call)))
    return rows


def engine_f32_check(table, device="cuda") -> dict:
    """Each engine against fused_flat in float32 at a reduced width
    (``ENGINE_F32``: the serve layer's routing, d 256, f 128) on ``device``,
    with fused_pipe also at the slice count of the full-width serve layer
    (``pipe_config``; at d 256 pipesim picks another): the max error of
    each, held to ``TOL_ENGINE_F32`` of the largest |output|."""
    from repro_torch.core import fusco
    from repro_torch.core.routing import ExpertPlacement
    inp = main_path_inputs(device, **ENGINE_F32, seed=5)
    f32 = lambda v: inp[v].float()
    x, gates = f32("x"), f32("route_gates")
    w = [f32(n) for n in ("w1", "w3", "w2")]
    placement = ExpertPlacement(w[0].shape[0], 1, 1)
    serve_s = pipe_geometry_of(pipe_config("qwen3-moe-30b-a3b"),
                               ENGINE_SHAPES["serve"])[1]
    out = {}
    for label, engine, slices, point, dedup in ENGINES + (
            (f"fused_pipe S={serve_s} (the serve layer's)", "fused_pipe",
             serve_s, "spec", False),):
        out[label] = fusco.shuffle_ffn(x, inp["A"], gates, *w, placement,
                                       engine_config(engine, slices, point,
                                                     table, dedup))
    want = out.pop("fused_flat")
    tol = TOL_ENGINE_F32 * want.abs().max().item()
    errs = {label: max_err(y, want) for label, y in out.items()}
    bad = {label: e for label, e in errs.items() if not e <= tol}
    if bad:
        raise AssertionError(f"engines in f32 against fused_flat: {bad} > {tol}")
    return dict(errs, tol=tol)


def pipe_geometry_of(cfg, shape: dict) -> tuple[int, int]:
    """fused_pipe's (capacity, S) for one bf16 layer at a MoE shape of
    ``PATHS``."""
    from repro_torch.core import dcomm
    from repro_torch.core.routing import ExpertPlacement
    return dcomm.pipe_geometry(shape["t"], shape["top_k"], shape["d"], 2,
                               ExpertPlacement(shape["n_experts"], 1, 1), cfg)


def calibrate_phase(device="cuda"):
    """``calibrate.calibrate()`` on the card, and the slice count and
    capacity that pipesim gives at the spec point and at the calibrated
    constants for the engine phase's two shapes and the moe-tx streamed
    prefill (``tx_stream_geometry``).  Returns the table and one line per
    shape."""
    from repro_torch.core import calibrate
    table = calibrate.calibrate(device=device)
    spec = engine_config("fused_pipe", 0, "spec", None)
    tuned = calibrate.apply(table, spec)
    tx = PATHS["moe-tx-stream"][1]
    lines = []
    for label, geometry in (
            ("qwen3-moe serve prefill",
             lambda cfg: pipe_geometry_of(cfg, ENGINE_SHAPES["serve"])),
            ("qwen3-moe train",
             lambda cfg: pipe_geometry_of(cfg, ENGINE_SHAPES["train"])),
            (f"moe-tx streamed prefill, {TX_LAYERS} layers",
             lambda cfg: tx_stream_geometry(tx["t"], tx["d"], tx["n_experts"],
                                            tx["top_k"], cfg))):
        got = {"spec point": geometry(spec), "calibrated": geometry(tuned)}
        lines.append(f"{label}: " + ", ".join(
            f"{name} S {s} (capacity {cap}, Cs {cap // s})"
            for name, (cap, s) in got.items()))
    return table, lines


def train_phase(argv, device="cuda", keep_state=False, restarts=0):
    """The training path once, with every launch counter zeroed just before
    it and read just after: ``launch/train.run`` at full width (its final
    params, AdamW state and train step with ``keep_state``).  Fails if the
    loop restarted other than ``restarts`` times, a loss is not finite, a
    kernel of the path never launched or one off it did
    (``family_kernels``), or, for a family with MoE, the run's traffic state
    (threaded through every step) is missing or all zero."""
    import math
    from repro_torch.launch import train
    wrappers = zero_counters()
    out = train.run(train.parse_args(argv), device=device,
                    keep_state=keep_state)
    launches = {k: w.launches for k, w in wrappers.items()}
    out["swiglu_forms"] = no_fma_swiglu(f"train {' '.join(argv)}")
    if out["run"].restarts != restarts:
        raise AssertionError(f"train loop restarted {out['run'].restarts} "
                             f"times, expected {restarts}")
    required, absent = family_kernels(out["cfg"], train=True)
    never = [k for k in required if launches[k] == 0]
    stray = [k for k in absent if launches[k]]
    if never or stray:
        raise AssertionError(f"train path never launched {never}, or "
                             f"launched {stray} off its path: {launches}")
    if not all(math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"train losses not finite: {out['losses']}")
    tr = out["traffic"]
    if out["cfg"].moe is not None and (
            tr is None or not any(bool(leaf.ne(0).any()) for leaf in tr)):
        raise AssertionError("the train run left no traffic statistics")
    return out, launches


def train_profile(argv, device="cuda") -> dict:
    """Where a train step's device time goes: after one warm-up step, one
    whole step under torch.profiler, then its two parts apart, the forward
    and backward (loss and gradients) and the AdamW update
    (:func:`step_profile`); the traffic state threaded as ``train.run``
    threads it."""
    from repro_torch.data.pipeline import to_device
    from repro_torch.launch import steps, train
    from repro_torch.models import zoo
    from repro_torch.optim import adamw
    args = train.parse_args(argv)
    s = train.setup(args, device)
    model = zoo.build(s.cfg, s.ctx)
    step = steps.make_train_step(model, s.opt_cfg, args.accum)
    batch = to_device(s.source.batch_at(0), device)
    traffic = train.init_traffic(s.cfg, s.ctx, args.accum)
    return step_profile(model, step, s.params, adamw.init(s.params), batch,
                        s.opt_cfg, traffic)


def step_profile(model, step, params, opt, batch, opt_cfg,
                 traffic=None) -> dict:
    """:func:`train_profile`'s three profiles of ``step`` (a
    ``steps.make_train_step`` of ``model``) on ``batch``: after one warm-up
    step, one whole step, its forward and backward
    (``steps.value_and_grad``: a leaf the loss does not reach gets zeros),
    and the AdamW update (:func:`profile_once`)."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    whole = lambda: step(params, opt, batch, traffic)
    whole()
    torch.cuda.synchronize()
    grads = []
    value_and_grad = steps.value_and_grad(model)

    def fwd_bwd():
        grads[:] = value_and_grad(params, batch, traffic)[2]

    return {"step": profile_once(whole),
            "forward+backward": profile_once(fwd_bwd),
            "adamw.update": profile_once(lambda: adamw.update(
                adamw.unflatten(params, grads), opt, params, opt_cfg))}


# device time by kind: the port's hand-written kernels by their names in
# csrc/, cuBLAS products, PyTorch's elementwise and reduction kernels
KINDS = (("hand-written", ("swiglu_", "gmm_", "flash_fwd", "gather_rows",
                           "owner_reduce", "scatter_add_bwd")),
         ("GEMM", ("gemm", "nvjet", "xmma", "cutlass")),
         ("elementwise", ("elementwise",)), ("reduction", ("reduce",)))


# the gradient assembly of stacked leaves: bf16 zero fills and adds
ASSEMBLY = (("bf16 zero fills", re.compile(r"FillFunctor<(c10::)?BFloat16>")),
            ("bf16 adds", re.compile(r"CUDAFunctor(OnSelf)?_add<(c10::)?BFloat16>")))


def assembly_ms(by_kernel) -> dict:
    """Device ms of the bf16 zero fills and adds (``ASSEMBLY``)."""
    return {k: sum(ms for name, ms in by_kernel if pat.search(name))
            for k, pat in ASSEMBLY}


def device_kinds(by_kernel) -> dict:
    """Device ms summed by kind (``KINDS``, then "other")."""
    out = {k: 0.0 for k, _ in KINDS}
    out["other"] = 0.0
    for name, ms in by_kernel:
        kind = next((k for k, keys in KINDS if any(x in name for x in keys)),
                    "other")
        out[kind] += ms
    return out


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def reduced_train_check(device="cuda", engine="fused_flat",
                        arch="qwen3-moe-30b-a3b", group=None,
                        lanes: int = 1) -> dict:
    """One ``make_train_step`` of the reduced ``arch`` in float32 through
    ``engine`` (``engine_kwargs``: the moe_tx or moe_ffn layers in one
    streamed block; with ``lanes`` > 1 that many micro-batch lanes, and as
    many accumulation micro-batches fused into them,
    ``steps.accum_fuses_into_stream``, which must hold, every run at
    ``lane_capacity``) from the same
    params, batch and cold traffic state (a
    family with MoE) on the card (kernels: those of the family's path
    launched and no other, ``family_kernels``; disagg's plain passes launch
    no gather or scatter-add) and on the CPU (plain versions): max errors
    of the loss, of every grad leaf, of every updated param and of the
    traffic state the step returns.  Params are
    held to 2 * lr + 1e-5: AdamW's first step moves each element by about
    lr * sign(g), so an element whose gradient is within float32 noise of
    zero may move the other way.  With ``group`` (an initialised process
    group of one rank), the card's step once more over it: the same bits
    in the loss, every grad leaf, every updated param and the traffic
    state as with no group, and no collective called.  With ``lanes`` > 1,
    the card's step once more at one lane without accumulation (the same
    function: the fused step's loss is the whole batch's token-mean), held
    to it within the card-vs-CPU tolerances (``one_lane``)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import dcomm, traffic
    from repro_torch.data.pipeline import ZipfNgramLM, to_device
    from repro_torch.launch import steps
    from repro_torch.models import lm, zoo
    from repro_torch.optim import adamw
    cfg = get_arch(arch).reduced()
    f32 = torch.float32
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    base = lm.init_params(cfg, lm.make_context(cfg, "cpu", compute_dtype=f32),
                          torch.Generator().manual_seed(0), dtype=f32)
    host = ZipfNgramLM(cfg.vocab, 32, 4, seed=0).batch_at(0)
    res = {}
    runs = [("cpu", "cpu", None, lanes), (device, device, None, lanes)]
    if group is not None:
        runs.append(("group", device, group, lanes))
    if lanes > 1:
        runs.append(("one lane", device, None, 1))
    for name, dev, g, k in runs:
        ctx = lm.make_context(cfg, dev, ep_group=g, compute_dtype=f32,
                              **engine_kwargs(engine, cfg, k),
                              **lane_capacity(lanes))
        model = zoo.build(cfg, ctx)
        if k > 1 and not steps.accum_fuses_into_stream(model, k):
            raise AssertionError(f"reduced {arch} {engine}: {k} lanes do not "
                                 "take the accumulation")
        params = adamw.tree_map(lambda t: t.to(dev, copy=True), base)
        batch = to_device(host, dev)
        cold = lambda: None if cfg.moe is None else traffic.init_traffic_state(
            cfg.moe.n_experts, 1, n_layers=cfg.n_layers, device=dev)
        wrappers = zero_counters()
        with dcomm.collective_calls() as calls:
            loss, _, grads = steps.value_and_grad(model, k)(params, batch,
                                                            cold())
            params, _, m = steps.make_train_step(model, opt_cfg, k)(
                params, adamw.init(params), batch, cold())
        res[name] = (float(loss), [x.cpu() for x in grads],
                     [x.detach().cpu() for x in adamw.leaves(params)],
                     {k: w.launches for k, w in wrappers.items()},
                     [x.cpu() for x in m.get("traffic") or ()], list(calls))
    (l0, g0, p0, _, t0, _), (l1, g1, p1, launched, t1, _) = (res["cpu"],
                                                              res[device])
    rel = lambda a, b: max_err(a.float(), b.float()) / max(
        1.0, a.float().abs().max().item())
    err = dict(loss=abs(l0 - l1),
               grads=max(rel(a, b) for a, b in zip(g0, g1)),
               params=max(max_err(a, b) for a, b in zip(p0, p1)),
               traffic=max((rel(a, b) for a, b in zip(t0, t1)), default=0.0))
    p_tol = 2 * adamw.schedule(opt_cfg, 1) + 1e-5
    if not (err["loss"] <= TOL_TRAIN and err["grads"] <= TOL_TRAIN
            and err["params"] <= p_tol and err["traffic"] <= TOL_TRAFFIC):
        raise AssertionError(f"reduced {arch} train step {engine} card vs CPU: "
                             f"{err} (tol {TOL_TRAIN}, params {p_tol}, "
                             f"traffic {TOL_TRAFFIC})")
    required, absent = family_kernels(cfg, train=True)
    if engine == "disagg":
        required = tuple(k for k in required if k not in DISAGG_PLAIN)
        absent += DISAGG_PLAIN
    never = [k for k in required if launched[k] == 0]
    stray = [k for k in absent if launched[k]]
    if never or stray:
        raise AssertionError(f"reduced {arch} {engine} train step on the card "
                             f"never launched {never}, or launched {stray}: "
                             f"{launched}")
    out = dict(err, params_tol=p_tol, launches=launched)
    if lanes > 1:
        lo, go, po, _, to, _ = res["one lane"]
        one = dict(loss=abs(lo - l1),
                   grads=max(rel(a, b) for a, b in zip(go, g1)),
                   params=max(max_err(a, b) for a, b in zip(po, p1)),
                   traffic=max((rel(a, b) for a, b in zip(to, t1)),
                               default=0.0))
        if not (one["loss"] <= TOL_TRAIN and one["grads"] <= TOL_TRAIN
                and one["params"] <= p_tol and one["traffic"] <= TOL_TRAFFIC):
            raise AssertionError(f"reduced {arch} train step {engine} on the "
                                 f"card, {lanes} lanes vs one: {one}")
        out["one_lane"] = one
    if group is not None:
        lg, gg, pg, _, tg, calls = res["group"]
        same = (lg == l1 and all(same_bits(a, b) for a, b in zip(
            g1 + p1 + t1, gg + pg + tg, strict=True)))
        if not same or calls:
            raise AssertionError(
                f"reduced {arch} {engine} train step on the card over a "
                f"one-rank group: same bits as with none {same}, "
                f"collectives called {calls}")
        out["one_rank_group"] = "same bits, no collective"
    return out


# the EP-2 check on one card: two ranks of a gloo group sharing it (NCCL
# refuses two ranks on one device); (arch, engine) of each case
EP2_CASES = (("qwen3-moe-30b-a3b", "fused_hier"), ("moe-tx-stream", "fused_pipe"))
# the EP-2 cases of the interleaved lanes: (arch, engine, lanes), the train
# step's accumulation fused into the lanes, and a prefill with autograd off,
# each lane's tail an asynchronous exchange in flight
EP2_LANE_CASES = (("moe-ffn-stream", "fused_pipe", 2),)
# (arch, engine, lanes) of every EP-2 train step
EP2_TRAIN_CASES = tuple((a, e, 1) for a, e in EP2_CASES) + EP2_LANE_CASES
# the EP-2 cases run a second time over the EP group alone with
# ``explicit_tp=False``: the moe family's replicated attention, each rank
# the whole sequence, the layout its serving contexts keep
EP2_REPLICATED = (("qwen3-moe-30b-a3b", "fused_hier"),)
EP2 = 2
EP2_CAPACITY = 8.0   # capacity factor: no row dropped at EP 1 or EP 2, whose
                     # capacities differ, so both compute one function


def _ep2_step(arch, engine, device, group=None, mesh=None,
              lanes: int = 1, tp: bool = True) -> dict:
    """One f32 train step of the reduced ``arch`` through ``engine``
    (``engine_kwargs``; ``lanes`` > 1: the accumulation of as many
    micro-batches fused into the lanes) on ``device`` over ``group`` or on
    ``mesh`` (None: one rank; ``tp``: the context's ``explicit_tp``), from
    the whole seed-0 tree cut to this rank's lane and the
    global batch cut to its data rank's rows: the loss, the grads and the
    updated params by path (on the CPU), the grad norm, the new traffic
    state (None without experts), the bytes of the AdamW state and those
    of its ZeRO-1 share (``adamw.zero_dim``, past each leaf's model-split
    dim: ``embed``'s on d), the kernels' launches and
    whether the step ran Megatron TP (``lm.tensor_parallel``: the moe and
    dense families over more than one model rank, unless ``tp`` is
    False)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import traffic
    from repro_torch.data.pipeline import ZipfNgramLM, to_device
    from repro_torch.launch import steps
    from repro_torch.launch.train import data_rows
    from repro_torch.models import lm, zoo
    from repro_torch.optim import adamw
    cfg = get_arch(arch).reduced()
    f32 = torch.float32
    base = lm.init_params(cfg, lm.make_context(cfg, "cpu", compute_dtype=f32),
                          torch.Generator().manual_seed(0), dtype=f32)
    host = ZipfNgramLM(cfg.vocab, 32, 4, seed=0).batch_at(0)
    dp, d = (1, 0) if mesh is None else (mesh.data, mesh.data_index)
    host = {k: v[data_rows(4, dp, d)] for k, v in host.items()}
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    ctx = lm.make_context(cfg, device, ep_group=group, mesh=mesh,
                          capacity_factor=EP2_CAPACITY, compute_dtype=f32,
                          explicit_tp=tp, **engine_kwargs(engine, cfg, lanes))
    model = zoo.build(cfg, ctx)
    params = lm.shard_params(adamw.tree_map(lambda t: t.to(device), base), ctx)
    batch = to_device(host, device)
    cold = lambda: None if cfg.moe is None else traffic.init_traffic_state(
        cfg.moe.n_experts, ctx.placement.ep, n_layers=cfg.n_layers,
        device=device)
    wrappers = zero_counters()
    loss, _, grads = steps.value_and_grad(model, lanes)(params, batch, cold())
    opt = steps.init_state(model, params)
    params, opt, m = steps.make_train_step(model, opt_cfg, lanes)(
        params, opt, batch, cold())
    paths = adamw.paths(params)
    split = lm.model_dim(ctx)
    share = sum(12 * t.numel() // (1 if adamw.zero_dim(
        t.shape, dp, lm.lane_sharded(p), split(p)) is None else dp)
        for p, t in zip(paths, adamw.leaves(params)))
    return {"loss": float(loss), "grad_norm": float(m["grad_norm"]),
            "grads": dict(zip(paths, (g.cpu() for g in grads))),
            "params": dict(zip(paths, (p.detach().cpu()
                                       for p in adamw.leaves(params)))),
            "traffic": [t.cpu() for t in m.get("traffic") or ()],
            "state_bytes": adamw.state_bytes(opt), "share_bytes": share,
            "launches": {k: w.launches for k, w in wrappers.items()},
            "lr": adamw.schedule(opt_cfg, 1), "tp": lm.tensor_parallel(ctx)}


def rank_cut(path: str, t, model: int, r: int, tp: bool):
    """A whole leaf as rank ``r`` of a model group of ``model`` holds it in
    training: an expert leaf its lane, ``embed`` and ``lm_head`` their
    shards (``lm.vocab_parallel``), under ``tp`` a TP leaf its shard."""
    from repro_torch.models import lm
    t = lm.lane_cut(path, t, model, range(r, r + 1))
    return lm.tp_cut(path, t, model, r, tp=tp)


def held_apart(path: str, tp: bool) -> bool:
    """Whether the model ranks of a training group hold different parts of
    the leaf at ``path``: an expert leaf, ``embed`` and ``lm_head`` (the
    reduced configs' vocab splits over every group the smoke runs), and
    under ``tp`` a TP leaf."""
    from repro_torch.models import lm
    from repro_torch.parallel import sharding
    return (lm.lane_sharded(path) or path in sharding.VOCAB_DIM
            or (tp and sharding.tp_sharded(path)))


def spawn_ranks(target, n: int, args: tuple, timeout: float) -> None:
    """Run ``target(rank, *args)`` in ``n`` spawned processes; fail unless
    every one exits 0 within ``timeout`` seconds in all (those still alive
    then are killed)."""
    import multiprocessing
    mp = multiprocessing.get_context("spawn")
    ranks = [mp.Process(target=target, args=(r, *args)) for r in range(n)]
    for p in ranks:
        p.start()
    deadline = time.monotonic() + timeout
    for p in ranks:
        p.join(timeout=max(0.0, deadline - time.monotonic()))
    codes = [p.exitcode for p in ranks]
    for p in ranks:
        if p.is_alive():
            p.kill()
            p.join()
    if codes != [0] * n:
        raise AssertionError(f"{getattr(target, '__name__', target)}: ranks "
                             f"exited with {codes} (None: killed after "
                             f"{timeout} s)")


def _ep2_prefill(arch, engine, device, lanes, group=None) -> dict:
    """The reduced ``arch`` (f32, capacity factor ``EP2_CAPACITY``) through
    ``engine`` at ``lanes`` lanes: one prefill of 4 x 16 seed-1 tokens from
    the whole seed-0 tree cut to this rank's lane, autograd off, over
    ``group`` (None: one rank).  Returns the logits (on the CPU), the
    kernels' launches and, for each stream shuffle, whether its tail's
    combine exchange was left in flight asynchronously (a handle to wait
    on)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import dcomm
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    cfg = get_arch(arch).reduced()
    f32 = torch.float32
    base = lm.init_params(cfg, lm.make_context(cfg, "cpu", compute_dtype=f32),
                          torch.Generator().manual_seed(0), dtype=f32)
    # a serving context: whole weights on every rank
    ctx = lm.make_context(cfg, device, ep_group=group,
                          capacity_factor=EP2_CAPACITY, compute_dtype=f32,
                          explicit_tp=False, split_vocab=False,
                          **engine_kwargs(engine, cfg, lanes))
    params = lm.shard_params(adamw.tree_map(lambda t: t.to(device), base), ctx)
    tokens = torch.randint(0, cfg.vocab, (4, 16),
                           generator=torch.Generator().manual_seed(1))
    tails, stream = [], dcomm.pipe_shuffle_ffn_stream

    def recording(*a, **kw):
        y, tail = stream(*a, **kw)
        tails.append(tail.returned.work is not None)
        return y, tail

    wrappers = zero_counters()
    dcomm.pipe_shuffle_ffn_stream = recording
    try:
        with torch.inference_mode():
            logits, _ = lm.prefill(params, tokens.to(device),
                                   torch.arange(16, device=device), ctx, 20)
    finally:
        dcomm.pipe_shuffle_ffn_stream = stream
    return {"logits": logits.cpu(), "async_tails": tails,
            "launches": {k: w.launches for k, w in wrappers.items()}}


def _ep2_rank(rank, port, out_dir, device):
    """One rank of the EP-2 check: a gloo group of two on ``device``, each
    case's step (and each lane case's prefill) saved to ``out_dir``, then
    the replicated-table check's run; one host thread a rank for torch's
    CPU ops, as ``_grid_init`` gives."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    torch.set_num_threads(1)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device).index or 0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=EP2)
    try:
        # a (1, 2) grid: the moe family takes Megatron TP, as by default
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(1, EP2)
        for arch, engine, lanes in EP2_TRAIN_CASES:
            torch.save(_ep2_step(arch, engine, device, mesh=mesh,
                                 lanes=lanes),
                       f"{out_dir}/{arch}-{engine}-{lanes}-rank{rank}.pt")
        # the replicated attention over the EP group alone
        for arch, engine in EP2_REPLICATED:
            torch.save(_ep2_step(arch, engine, device, dist.group.WORLD,
                                 tp=False),
                       f"{out_dir}/{arch}-{engine}-replicated-rank{rank}.pt")
        for arch, engine, lanes in EP2_LANE_CASES:
            torch.save(_ep2_prefill(arch, engine, device, lanes,
                                    dist.group.WORLD),
                       f"{out_dir}/{arch}-{engine}-{lanes}-prefill-rank{rank}.pt")
        # the replicated table on the same two ranks
        _replicated_run(rank, out_dir, device)
    finally:
        dist.destroy_process_group()


def ep2_card_check(device="cuda") -> list[str]:
    """One f32 train step of each case (``EP2_TRAIN_CASES``: ``EP2_CASES``
    and the lanes' ``EP2_LANE_CASES``) on two ranks sharing the card (a gloo group:
    NCCL refuses two ranks on one device; a (1, 2) grid, so the moe family
    runs its default Megatron TP beside EP), and in the same spawn each of
    ``EP2_REPLICATED`` over the EP group alone with ``explicit_tp=False``
    (the replicated attention), against the EP 1 step on the
    card from the same whole parameters and global batch: on each rank the
    loss and every grad leaf (an expert leaf's against its lane of the EP 1
    gradient, a TP leaf's against its shard) within ``TOL_TRAIN`` of
    max(1, |x|), the grad norm within ``TOL_TRAIN`` relative, the updated
    params within 2 * lr + 1e-5; the
    replicated leaves hold the same bits on both ranks after the step;
    every kernel of the family's path launched on each rank and none off
    it (``family_kernels``).  Then each lane case's prefill
    (``_ep2_prefill``): each rank's logits within ``TOL_REDUCED`` of the
    EP 1 prefill's, every shuffle's tail left in flight on an asynchronous
    exchange (one a lane and layer), none at EP 1.  The same spawn runs
    the replicated-table check (``replicated_card_check``).  Returns a
    line a case, and the replicated-table check's lines."""
    import shutil
    import torch
    from repro_torch.configs import get_arch
    out_dir = ROOT / "build" / "ep2"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    want = {c: _ep2_step(*c[:2], device, lanes=c[2]) for c in EP2_TRAIN_CASES}
    want_prefill = {c: _ep2_prefill(*c[:2], device, c[2])
                    for c in EP2_LANE_CASES}
    spawn_ranks(_ep2_rank, EP2, (free_port(), str(out_dir), device), 600)
    lines = []
    runs = ([(c, f"{c[0]}-{c[1]}-{c[2]}") for c in EP2_TRAIN_CASES]
            + [((a, e, 1), f"{a}-{e}-replicated") for a, e in EP2_REPLICATED])
    for (arch, engine, lanes), name in runs:
        w = want[arch, engine, lanes]
        got = [torch.load(out_dir / f"{name}-rank{r}.pt") for r in range(EP2)]
        required, absent = family_kernels(get_arch(arch), train=True)
        rel = lambda a, b: max_err(a, b) / max(1.0, b.abs().max().item())
        err = {"loss": 0.0, "grads": 0.0, "grad_norm": 0.0, "params": 0.0}
        for r, g in enumerate(got):
            lane = lambda path, t: rank_cut(path, t, EP2, r, g["tp"])
            err["loss"] = max(err["loss"], abs(g["loss"] - w["loss"]))
            err["grad_norm"] = max(err["grad_norm"], abs(
                g["grad_norm"] - w["grad_norm"]) / w["grad_norm"])
            for k, t in w["grads"].items():
                err["grads"] = max(err["grads"], rel(g["grads"][k], lane(k, t)))
            for k, t in w["params"].items():
                err["params"] = max(err["params"],
                                    max_err(g["params"][k], lane(k, t)))
            never = [k for k in required if g["launches"][k] == 0]
            stray = [k for k in absent if g["launches"][k]]
            if never or stray:
                raise AssertionError(f"EP-2 {arch} {engine} rank {r} never "
                                     f"launched {never}, or launched "
                                     f"{stray}: {g['launches']}")
        apart = [k for k, t in got[0]["params"].items()
                 if not held_apart(k, got[0]["tp"])
                 and not same_bits(t, got[1]["params"][k])]
        # the moe family: TP on the grid, the replicated attention alone
        tp_want = (get_arch(arch).family == "moe"
                   and not name.endswith("replicated"))
        if any(g["tp"] != tp_want for g in got):
            raise AssertionError(f"EP-2 {name}: Megatron TP per rank "
                                 f"{[g['tp'] for g in got]}, not {tp_want}")
        p_tol = 2 * w["lr"] + 1e-5
        if not (err["loss"] <= TOL_TRAIN and err["grads"] <= TOL_TRAIN
                and err["grad_norm"] <= TOL_TRAIN and err["params"] <= p_tol
                and not apart):
            raise AssertionError(
                f"EP-2 {arch} {engine} against EP 1 on the card: {err} (tol "
                f"{TOL_TRAIN}, params {p_tol}); replicated leaves apart "
                f"across ranks: {apart}")
        fused = f" at {lanes} lanes, accum {lanes} fused" if lanes > 1 else ""
        fused += (", Megatron TP" if got[0]["tp"]
                  else ", replicated attention" if name.endswith("replicated")
                  else "")
        lines.append(
            f"{arch} {engine}{fused}: loss {err['loss']:.3g}, grads "
            f"{err['grads']:.3g}, grad norm {err['grad_norm']:.3g} (tol "
            f"{TOL_TRAIN}), params {err['params']:.3g} (tol {p_tol:.3g}); "
            f"replicated leaves bit-equal across the ranks; launches per "
            f"rank {json.dumps([g['launches'] for g in got])}")
    for (arch, engine, lanes), w in want_prefill.items():
        cfg = get_arch(arch).reduced()
        got = [torch.load(out_dir / f"{arch}-{engine}-{lanes}-prefill-rank{r}.pt")
               for r in range(EP2)]
        err = max(max_err(g["logits"], w["logits"]) for g in got)
        tails = [g["async_tails"] for g in got]
        required, _ = family_kernels(cfg, train=False)
        never = [k for g in got for k in required if g["launches"][k] == 0]
        if not (err <= TOL_REDUCED and not any(w["async_tails"])
                and all(t == [True] * (cfg.n_layers * lanes) for t in tails)
                and not never):
            raise AssertionError(
                f"EP-2 {arch} {engine} prefill at {lanes} lanes against EP 1 "
                f"on the card: logits {err} (tol {TOL_REDUCED}); tails in "
                f"flight per rank {tails}, at EP 1 {w['async_tails']}; never "
                f"launched {never}")
        lines.append(
            f"{arch} {engine} prefill at {lanes} lanes, autograd off: logits "
            f"{err:.3g} (tol {TOL_REDUCED}); each rank left all "
            f"{cfg.n_layers * lanes} lane tails in flight on an asynchronous "
            f"exchange (EP 1: none); launches per rank "
            f"{json.dumps([g['launches'] for g in got])}")
    replicated = replicated_card_check(out_dir, device)
    shutil.rmtree(out_dir, ignore_errors=True)
    return lines, replicated


# the (2, 2) grid on one card: four ranks of a gloo group sharing it, two
# data ranks of an EP group of two; the cases are GRID_CASES
GRID = (2, 2)
# the Megatron-SP cases on one card: the (2, 2) grid's (run by
# ``grid_card_check`` in the same spawn as ``EP2_CASES``): reduced
# qwen3-1.7b (attention and MLP TP, 2 of 4 heads a rank, group size 2) and
# qwen3-moe (TP attention beside EP 2) through fused_flat; the (1, 4) grid's
# (the same four ranks, the same spawn): qwen3-1.7b, one head a rank, fewer
# than its group size, one kv head a rank
TP_CASES = (("qwen3-1.7b", "fused_flat"), ("qwen3-moe-30b-a3b", "fused_flat"))
GRID_CASES = EP2_CASES + TP_CASES
TP4 = (1, 4)
TP4_CASES = (("qwen3-1.7b", "fused_flat"),)
# the grids of ``grid_card_check``: (shape, cases), four ranks each
GRIDS = ((GRID, GRID_CASES), (TP4, TP4_CASES))
# the full-width ZeRO-1 run on the same four ranks: qwen3-moe at full width
# cut to one layer, B 4 x S 512 (each data rank 2 rows), traffic on; a
# capacity factor of E / top-k = 16 gives each expert room for every token of
# its island, so the one-card run and the grid's drop no row and compute one
# function
ZERO1 = ["--arch", "qwen3-moe-30b-a3b", "--layers", "1", "--batch", "4",
         "--seq", "512", "--steps", "3", "--capacity-factor", "16"]
TOL_ZERO1_LOSS = 2e-3     # first step's loss, grid vs one card, relative: bf16


# serving over the (2, 2) grid, in ``grid_card_check``'s spawn of four: each
# case's reduced model in f32 (arch, engine, FSDP of the experts forced on)
# through the continuous and the waved engine at ``EP2_CAPACITY`` (nothing
# dropped at EP 1 or EP 2, so the grid computes the card's function)
GRID_SERVE_CASES = (("qwen3-moe-30b-a3b", "fused_flat", False),
                    ("qwen3-moe-30b-a3b", "fused_hier", True))
# the full-width serve on the same grid: qwen3-moe cut to 8 layers through
# fused_hier at node size 1 (the reference serve's max(1, model // 2)), the
# continuous engine (pool 8, admission chunks of one row a data rank) over 8
# requests of a 64-token prompt, 4 tokens each (4 admissions, 3 decode steps:
# each forward gathers the experts' other halves over gloo, ~6.8 s), at
# capacity factor 16 (E / top-k: nothing dropped at EP 1 or EP 2).  At EP 2
# one lane's experts over 8 layers are 64 x 3 x 2048 x 768 x 2 B x 8 = 4.83
# GB > 4 GB, so the reference's rule (``lm.fsdp_rule``) turns FSDP of the
# experts on by itself
GRID_SERVE = dict(arch="qwen3-moe-30b-a3b", layers=8, engine="fused_hier",
                  max_batch=8, requests=8, prompt=64, gen=4, capacity=16.0,
                  reduced=False)
GRID_EXPERT_BYTES = 2_415_919_104   # a rank's half of its lane's experts
# the first-token logits of each row, grid against the card alone (EP 1,
# whole weights, the row alone as on its data rank), relative to max(1,
# |logit|) of the row.  fused_flat gives the card's bits on the grid.
# fused_hier at EP 2 sums each token's gated expert outputs per node and
# rounds each node's part to bf16 before the parts are added, so at every
# layer its MoE output may round one unit apart from the card's; in a bf16
# residual stream of random weights that flips near-tied top-8 choices in
# the later layers, each flip an O(1) change of one token's MoE output (on
# an H100 80GB HBM3 at 700 W, ``tools/grid_serve_engines.py``: the card
# alone's own fused_flat against its fused_hier up to 0.07, the grid's
# fused_hier 0.28).  So each row is held as the same function up to such
# flips: within this share of the distance from its card logits to the
# nearest other request's (1.14 or more there), which a row served from
# another request's prompt, slot or state misses
TOL_GRID_APART = 0.5


class _Calls:
    """A kernel module seen through ``kernels.ops``: its wrapper ``name``
    replaced by ``rec``, everything else the module's own (so its launch
    counter stays the wrapper's)."""

    def __init__(self, mod, name, rec):
        self._mod, self._name, self._rec = mod, name, rec

    def __getattr__(self, key):
        return self._rec if key == self._name else getattr(self._mod, key)


# the module names ``kernels.ops`` calls the serve kernels' wrappers through
OPS_MODULES = {"segment_gather": "gather_k", "segment_scatter_add": "scatter_k",
               "fused_swiglu": "fused_staging", "flash_attention": "flash_k"}


@contextlib.contextmanager
def recorded_calls(picks: dict):
    """Within the block, the arguments of the picked calls of each serve
    kernel's wrapper (``picks``: name -> the indices of its calls, counted
    from 0 as the block makes them) are copied into the yielded dict, by
    (name, index); the calls run as they would."""
    import torch
    from repro_torch.kernels import ops
    seen, saved = {}, {}
    for name, attr in OPS_MODULES.items():
        mod = saved[attr] = getattr(ops, attr)
        count = [0]

        def rec(*a, _name=name, _fn=getattr(mod, name), _count=count, **k):
            if _count[0] in picks.get(_name, ()):
                seen[_name, _count[0]] = [
                    t.clone() if isinstance(t, torch.Tensor) else t for t in a]
            _count[0] += 1
            return _fn(*a, **k)

        setattr(ops, attr, _Calls(mod, name, rec))
    try:
        yield seen
    finally:
        for attr, mod in saved.items():
            setattr(ops, attr, mod)


def grid_serve_rows(rec: dict, path: str, engine: str,
                    timer=time_ms) -> list[dict]:
    """The serve kernels on the inputs rank 0 of the full-width grid serve
    gave them (``grid_serve_full``'s recorded calls): the first two gathers
    and combines (fused_hier: layer 0's stage-1 and expansion gathers, its
    pre-combine and origin sum; fused_flat: layers 0 and 1), the prefill's
    and a decode step's layer-0 fused_swiglu (the FSDP-gathered expert
    weights) and the prefill's first flash forward, each held against its
    plain version and timed."""
    gathers = [gather_row(*rec["segment_gather", i], timer)[0] for i in (0, 1)]
    scatters = []
    for i in (0, 1):
        src, dst, gates, out_rows, owners = rec["segment_scatter_add", i]
        scatters += scatter_rows(src, dict(idx=dst, gates=gates,
                                           owners=owners), out_rows, timer,
                                 False)
    prefill = rec["fused_swiglu", "prefill"]
    decode = rec["fused_swiglu", "decode"]
    q, k, v, qp, kp, causal, window = rec["flash_attention", 0]
    assert causal
    names = (("stage 1", "expansion", "pre-combine", "origin")
             if engine == "fused_hier" else ("layer 0", "layer 1") * 2)
    rows = [dict(r, shape=f"{engine} {what}: {r['shape']}")
            for r, what in zip(gathers + scatters, names)]
    for what, (x, counts) in (("prefill", (prefill[0], prefill[4])),
                              ("decode", (decode[0], decode[4]))):
        r, _ = swiglu_row("fused_swiglu", x, *prefill[1:4], counts, timer)
        rows.append(dict(r, shape=f"{what}: {r['shape']}"))
    rows.append(flash_row(q, k, v, qp, kp, window, timer))
    return [dict(r, path=path) for r in rows]


def grid_serve_run(arch: str, engine: str, fsdp: bool, device="cuda",
                   mesh=None, chunk: int | None = None) -> dict:
    """The reduced ``arch`` in f32 through ``engine`` (node size 1, capacity
    factor ``EP2_CAPACITY``, ``fsdp`` forcing FSDP of the experts) on
    ``device``, on ``mesh`` (None: one rank): the seed-0 whole tree cut to
    this rank, 6 requests of 16 / 32 tokens (seed 0, ``max_new`` 4-6)
    through the continuous engine (pool 4) and the waved one (waves of 4),
    traffic tracked.  ``chunk``: the continuous engine's admission chunk
    (None: its own, the grid's data ranks; one rank given the grid's makes
    the grid's admissions, each chunk's rows padded to one bucket as
    there).  Returns each engine's streams by request and traffic state
    (on the CPU), its admission chunk, and the launches of both runs."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import traffic
    from repro_torch.models import lm, zoo
    from repro_torch.optim import adamw
    from repro_torch.serving.engine import (ContinuousServingEngine,
                                            ServingEngine)
    cfg = get_arch(arch).reduced()
    f32 = torch.float32
    kw = dict(engine=engine, node_size=1, capacity_factor=EP2_CAPACITY,
              compute_dtype=f32, explicit_tp=False, split_vocab=False)
    whole = lm.init_params(cfg, lm.make_context(cfg, "cpu", **kw),
                           torch.Generator().manual_seed(0), f32)
    ctx = lm.make_context(cfg, device, mesh=mesh, fsdp_experts=fsdp, **kw)
    params = lm.shard_params(adamw.tree_map(lambda t: t.to(device), whole),
                             ctx)
    bundle = zoo.build(cfg, ctx)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab, (16, 32)[i % 2]),
             int(rng.integers(4, 7))) for i in range(6)]
    out = {}
    wrappers = zero_counters()
    for kind, cls in (("continuous", ContinuousServingEngine),
                      ("waved", ServingEngine)):
        eng = cls(bundle, max_batch=4, max_len=40, buckets=(16, 32),
                  track_traffic=True)
        for prompt, n in reqs:
            eng.submit(prompt, max_new=n)
        if kind == "continuous":
            eng.admit_chunk = chunk or eng.admit_chunk
            out["chunk"] = eng.admit_chunk
            eng.warmup(params)
            eng.run(params)
        else:
            while eng.queue:
                eng.run_wave(params)
        out[kind] = {
            "streams": [q.output for q in sorted(eng.finished,
                                                 key=lambda q: q.rid)],
            "traffic": {f: getattr(eng.traffic, f).cpu()
                        for f in traffic.TrafficState._fields}}
    out["launches"] = {k: w.launches for k, w in wrappers.items()}
    return out


def grid_serve_full(device="cuda", mesh=None, spec=GRID_SERVE) -> dict:
    """``spec``'s full-width serve (``GRID_SERVE``; ``reduced`` cuts the
    width, for a rehearsal on the CPU) in bf16: the seed-0 parameters this
    rank holds (its lane and, under the reference's FSDP rule, its slice of
    the experts' f dim) and the seed-0 prompts.  On ``mesh``: the continuous
    engine over every request (``warmup()``, then ``run()`` with the launch
    counters zeroed just before and read just after, each prefill's logits
    recorded), returning the streams, this rank's first-token logits in
    admission order, the admissions and decode steps, the launches, the
    expert bytes held, the peak memory, the callables built (after warmup,
    after the run) and the run's seconds.  Without a mesh: the card alone,
    each request's first-token logits from a prefill of its row alone."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import lm, zoo
    from repro_torch.serving.engine import ContinuousServingEngine
    cfg = get_arch(spec["arch"])
    cfg = dataclasses.replace(cfg.reduced() if spec["reduced"] else cfg,
                              n_layers=spec["layers"])
    ctx = lm.make_context(cfg, device, mesh=mesh, engine=spec["engine"],
                          node_size=1, capacity_factor=spec["capacity"],
                          explicit_tp=False, split_vocab=False)
    on_card = ctx.device.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, ctx,
                            torch.Generator(device=ctx.device).manual_seed(0))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (spec["requests"], spec["prompt"]))
    max_len = spec["prompt"] + spec["gen"]
    if mesh is None:
        positions = torch.arange(spec["prompt"], device=ctx.device)
        flat = dataclasses.replace(ctx, dcfg=dataclasses.replace(
            ctx.dcfg, engine="fused_flat"))
        with torch.inference_mode():
            first = {c.dcfg.engine: torch.stack([lm.prefill(
                params, torch.from_numpy(p[None]).to(ctx.device), positions,
                c, max_len)[0][0].cpu() for p in prompts])
                for c in (ctx, flat)}
        return {"first_logits": first[spec["engine"]],
                "flat_logits": first["fused_flat"], "fsdp": ctx.fsdp_experts}
    bundle, seen = zoo.build(cfg, ctx), []

    def prefill(*a, **k):
        out = bundle.prefill(*a, **k)
        seen.append(out[0].clone())
        return out

    eng = ContinuousServingEngine(
        dataclasses.replace(bundle, prefill=prefill),
        max_batch=spec["max_batch"], max_len=max_len,
        buckets=(spec["prompt"],), track_traffic=True)
    eng.warmup(params)
    built = eng.compile_count
    seen.clear()
    for p in prompts:
        eng.submit(p, max_new=spec["gen"])
    # every request is admitted in the first step, before any decode: the
    # first decode step's layer-0 fused_swiglu is call admissions x layers
    first_decode = spec["requests"] // eng.admit_chunk * cfg.n_layers
    picks = {"segment_gather": (0, 1), "segment_scatter_add": (0, 1),
             "fused_swiglu": (0, first_decode), "flash_attention": (0,)}
    if spec["requests"] > eng.max_batch:
        raise AssertionError("grid serve: more requests than slots, so "
                             "admissions and decode steps interleave")
    wrappers = zero_counters()
    with recorded_calls(picks) as rec:
        t0 = time.perf_counter()
        done = eng.run(params)
        run_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    rec["fused_swiglu", "prefill"] = rec.pop(("fused_swiglu", 0))
    rec["fused_swiglu", "decode"] = rec.pop(("fused_swiglu", first_decode))
    if on_card:
        no_fma_swiglu("grid serve")
    moe = params["layers"]["moe"]
    return {"streams": [q.output for q in sorted(done, key=lambda q: q.rid)],
            "first_logits": torch.cat(seen).cpu(), "chunk": eng.admit_chunk,
            "admissions": len(eng.wave_loads),
            "decode_steps": eng.decode_steps, "launches": launches,
            "fsdp": ctx.fsdp_experts,
            "expert_bytes": sum(moe[w].nbytes for w in ("w1", "w3", "w2")),
            "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                         if on_card else None),
            "built": (built, eng.compile_count), "run_s": run_s,
            "calls": rec}


def grid_serve_path(spec: dict, shape) -> str:
    """The path name of the full-width grid serve (its launches' phase and
    its kernel rows')."""
    return f"{spec['arch']} grid {tuple(shape)} serve, {spec['layers']} layers"


def grid_serve_implied(spec: dict, admissions: int, steps: int) -> dict:
    """The launches a rank's continuous run of ``spec`` implies: each
    admission prefills its rows through every layer (fused_hier: two
    gathers, the stage-1 one and the expansion, two scatter-adds, the
    pre-combine and the origin sum; one fused_swiglu and one flash forward),
    each decode step one fused_swiglu a layer."""
    g, c = ENGINE_LAUNCHES[spec["engine"]](1)
    n = admissions * spec["layers"]
    return {"segment_gather": g * n, "segment_scatter_add": c * n,
            "fused_swiglu": n + steps * spec["layers"],
            "flash_attention": n, "grouped_matmul": 0,
            "segment_scatter_add_bwd": 0}


# the pipeline phase, in ``grid_card_check``'s spawn of four on the world:
# qwen3-1.7b at full width and depth (``layers`` None), its 28 layers in 4
# stages of 7 (``lm._seq_layer`` on a one-rank dense context, bf16), 8
# microbatches of (1, 512, d) seeded hidden states at positions arange(512),
# forward and backward of sum(out * c)
PIPE = dict(arch="qwen3-1.7b", reduced=False, layers=None, n_micro=8,
            seq=512, seed=0)
# each stage's dw, and each rank's dx, against the sequential reference's
# per-microbatch gradients g_m (bf16 terms, bit for bit the pipeline's at the
# same shapes): the pipelined sum adds the same bf16 terms and exact zeros (the
# fill and drain ticks) in another order, rounding each partial sum to bf16,
# so element by element it is within n_micro * 2^-8 * sum_m |g_m| of the
# exact sum_m g_m (recursive summation at bf16's unit roundoff 2^-8; the
# reference's sums in f32)
PIPE_UNIT = 2.0 ** -8
# the flash forward at the stages' shape: one microbatch, 16 / 8 heads of 128
PIPE_ATTN = dict(b=1, sq=512, sk=512, hq=16, hkv=8, hd=128)
# gloo's timeout, set when a spawn's group is made: a rank left waiting in a
# collective (a backward the ranks reach in different orders) fails after
# this many seconds, inside ``spawn_ranks``' deadline
GLOO_TIMEOUT_S = 120


def _grid_init(rank, port, device, shape=GRID):
    """Join the gloo group of a ``shape`` grid's ranks on ``device``; its
    mesh.  One host thread a rank for torch's own CPU ops: the ranks share
    the host's cores, and a pool of threads in each spins against the
    others' (gloo keeps its own threads)."""
    import datetime
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    torch.set_num_threads(1)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device).index or 0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=shape[0] * shape[1],
                            timeout=datetime.timedelta(seconds=GLOO_TIMEOUT_S))
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(*shape)


def _grid_rank(rank, port, out_dir, device, grids, serve, pipe):
    """One rank of the grid checks: each of ``grids``' (shape, cases), the
    same world in all, each case's step saved to ``out_dir``; then the
    serving checks on the first grid: each of ``GRID_SERVE_CASES`` reduced
    (``grid_serve_run``) and ``serve``'s full-width run
    (``grid_serve_full``); then ``pipe``'s pipeline phase on the world
    (:func:`pipeline_rank`)."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    mesh = first = _grid_init(rank, port, device, grids[0][0])
    try:
        for i, (shape, cases) in enumerate(grids):
            mesh = mesh if i == 0 else make_host_mesh(*shape)
            for arch, engine in cases:
                torch.save(_ep2_step(arch, engine, device, mesh=mesh),
                           f"{out_dir}/{shape[0]}x{shape[1]}-{arch}-{engine}"
                           f"-rank{rank}.pt")
        for arch, engine, fsdp in GRID_SERVE_CASES:
            t0 = time.perf_counter()
            out = grid_serve_run(arch, engine, fsdp, device, first)
            out["seconds"] = time.perf_counter() - t0
            torch.save(out, f"{out_dir}/serve-{arch}-{engine}-rank{rank}.pt")
        t0 = time.perf_counter()
        full = grid_serve_full(device, first, serve)
        full["seconds"] = time.perf_counter() - t0
        calls = full.pop("calls")
        if rank == 0:       # the kernels' inputs, for the kernel rows
            torch.save(calls, f"{out_dir}/serve-calls.pt")
        del calls
        torch.save(full, f"{out_dir}/serve-full-rank{rank}.pt")
        del full
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        pipeline_rank(rank, out_dir, device, pipe)
    finally:
        dist.destroy_process_group()


def grid_card_check(device="cuda", grids=GRIDS, serve=GRID_SERVE,
                    timer=time_ms, pipe=PIPE) -> tuple[dict, dict, list]:
    """One f32 train step of each case of each (shape, cases) of ``grids``
    on a ``shape`` grid of ranks sharing the card (gloo; one spawn of the
    grids' common world for all) against the one-rank step on the card
    from the same whole parameters and global batch: on each rank the loss,
    every grad leaf (an expert leaf's against its lane of the one-rank
    gradient, a TP leaf's against its shard: the moe and dense families
    run their default Megatron TP on the grid) within ``TOL_TRAIN`` of
    max(1, |x|), the grad norm within ``TOL_TRAIN`` relative, the updated
    params within 2 * lr + 1e-5; the replicated leaves hold the same bits
    on every rank, each expert leaf and TP shard on the data ranks of its
    model rank, and the traffic state on all; each rank's AdamW state is
    its ZeRO-1 share in bytes; every kernel of the family's path launched
    on every rank (``family_kernels``).  The same spawn then serves
    ``serve`` on the first grid (``grid_serve_check``), and
    the serve kernels are held and timed (``timer``) on the inputs rank 0's
    full-width serve gave them (``grid_serve_rows``).  Returns the lines of
    each shape, one a case (the serving check's under "serve"), rank 0's
    launches by grid and case, and the kernel rows."""
    import shutil
    import torch
    from repro_torch.configs import get_arch
    out_dir = ROOT / "build" / "grid"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    want = {c: _ep2_step(*c, device) for _, cases in grids for c in cases}
    want_serve = {c: grid_serve_run(*c, device, chunk=grids[0][0][0])
                  for c in GRID_SERVE_CASES}
    t0 = time.perf_counter()
    want_full = grid_serve_full(device, spec=serve)
    full_one_s = time.perf_counter() - t0
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    n = grids[0][0][0] * grids[0][0][1]
    assert all(a * b == n for (a, b), _ in grids), grids
    t0 = time.perf_counter()
    spawn_ranks(_grid_rank, n, (free_port(), str(out_dir), device, grids,
                                serve, pipe), 900)
    spawn_s = time.perf_counter() - t0
    lines = {}
    lines["pipeline"], launches_pipe = pipeline_check(out_dir, pipe)
    lines["serve"], launches = grid_serve_check(
        out_dir, grids[0][0], serve, want_serve, want_full)
    with torch.inference_mode():
        rows = grid_serve_rows(
            torch.load(out_dir / "serve-calls.pt", map_location=device),
            grid_serve_path(serve, grids[0][0]), serve["engine"], timer)
    lines["serve"].append(
        f"seconds: the one-card full-width prefills {full_one_s:.1f}; the "
        f"spawn of {n} (the train grids, the serving checks and the "
        f"pipeline) {spawn_s:.1f}")
    launches[f"{pipe['arch']} pipeline"] = launches_pipe
    for shape, (arch, engine) in ((s, c) for s, cases in grids
                                  for c in cases):
        w, model = want[arch, engine], shape[1]
        got = [torch.load(out_dir / f"{shape[0]}x{model}-{arch}-{engine}"
                          f"-rank{r}.pt") for r in range(n)]
        rel = lambda a, b: max_err(a, b) / max(1.0, b.abs().max().item())
        err = {"loss": 0.0, "grads": 0.0, "grad_norm": 0.0, "params": 0.0}
        required, _ = family_kernels(get_arch(arch), train=True)
        for r, g in enumerate(got):
            lane = lambda path, t: rank_cut(path, t, model, r % model,
                                            g["tp"])
            err["loss"] = max(err["loss"], abs(g["loss"] - w["loss"]))
            err["grad_norm"] = max(err["grad_norm"], abs(
                g["grad_norm"] - w["grad_norm"]) / w["grad_norm"])
            for k, t in w["grads"].items():
                err["grads"] = max(err["grads"], rel(g["grads"][k], lane(k, t)))
            for k, t in w["params"].items():
                err["params"] = max(err["params"],
                                    max_err(g["params"][k], lane(k, t)))
            never = [k for k in required if g["launches"][k] == 0]
            if never or g["state_bytes"] != g["share_bytes"]:
                raise AssertionError(
                    f"grid {shape} {arch} {engine} rank {r}: never launched "
                    f"{never} "
                    f"({g['launches']}); AdamW state {g['state_bytes']} bytes, "
                    f"its ZeRO-1 share {g['share_bytes']}")
        apart = []
        for k in got[0]["params"]:
            # an expert leaf or TP shard: the data ranks of each model rank;
            # else all
            pairs = ([(m, m + d * model) for m in range(model)
                      for d in range(1, shape[0])]
                     if held_apart(k, got[0]["tp"])
                     else [(0, r) for r in range(1, n)])
            apart += [f"{k} ranks {a}, {b}" for a, b in pairs
                      if not same_bits(got[a]["params"][k],
                                       got[b]["params"][k])]
        apart += [f"traffic ranks 0, {r}" for r in range(1, n)
                  if not all(same_bits(a, b) for a, b in zip(
                      got[0]["traffic"], got[r]["traffic"], strict=True))]
        p_tol = 2 * w["lr"] + 1e-5
        if not (err["loss"] <= TOL_TRAIN and err["grads"] <= TOL_TRAIN
                and err["grad_norm"] <= TOL_TRAIN and err["params"] <= p_tol
                and not apart):
            raise AssertionError(
                f"grid {shape} {arch} {engine} against one rank on the card: "
                f"{err} (tol {TOL_TRAIN}, params {p_tol}); bits apart: "
                f"{apart}")
        launches[f"grid {shape} {arch} {engine} rank 0"] = got[0]["launches"]
        tp = ", Megatron TP" if got[0]["tp"] else ""
        lines.setdefault(shape, []).append(
            f"{arch} {engine}{tp}: loss {err['loss']:.3g}, grads "
            f"{err['grads']:.3g}, grad norm {err['grad_norm']:.3g} (tol "
            f"{TOL_TRAIN}), params {err['params']:.3g} (tol {p_tol:.3g}); "
            f"replicated leaves bit-equal on the {n} ranks, expert leaves and "
            f"TP shards on the data ranks of each model rank, traffic state "
            f"on the {n}; AdamW "
            f"state per rank {[g['state_bytes'] for g in got]} bytes (ZeRO-1 "
            f"shares; {w['state_bytes']} on one rank); launches per rank "
            f"{json.dumps([g['launches'] for g in got])}")
    shutil.rmtree(out_dir, ignore_errors=True)
    return lines, launches, rows


def grid_serve_check(out_dir, shape, spec, want_runs, want_full
                     ) -> tuple[list[str], dict]:
    """The serving checks of ``grid_card_check``'s spawn on the ``shape``
    grid against the card alone.  Reduced (``GRID_SERVE_CASES``, f32): on
    every rank each engine's streams equal the card's, ``last_expert_count``
    and ``steps`` too, the expert EMA within ``TOL_TRAFFIC`` of max(1, |x|)
    of the card's, and every rank holds the same bits of the whole traffic
    state (its lane statistics over the grid's EP lanes, which one rank has
    not).  Full width (``spec``, bf16): each rank holds exactly its half of
    its lane's expert bytes under the reference's FSDP rule, the four ranks
    give the same streams (every request its tokens, in the vocabulary),
    each rank's first-token logits of its rows are the card's within
    ``TOL_GRID_APART`` of the distance from the row's card logits to the
    nearest other request's, nothing was built
    after ``warmup()``, and rank 0's launches are the count the code
    implies per admission and per decode step (``grid_serve_implied``).
    Returns the lines and rank 0's launches by serving phase."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    data, model = shape
    n = data * model
    lines, launches = [], {}
    for arch, engine, fsdp in GRID_SERVE_CASES:
        w = want_runs[arch, engine, fsdp]
        got = [torch.load(f"{out_dir}/serve-{arch}-{engine}-rank{r}.pt")
               for r in range(n)]
        err, bad = 0.0, []
        for kind in ("continuous", "waved"):
            wt = w[kind]["traffic"]
            for r, g in enumerate(got):
                gt = g[kind]["traffic"]
                if g["chunk"] != w["chunk"]:
                    bad.append(f"rank {r} admission chunk {g['chunk']}")
                if g[kind]["streams"] != w[kind]["streams"]:
                    bad.append(f"{kind} rank {r} streams {g[kind]['streams']}"
                               f" against {w[kind]['streams']}")
                for f in ("last_expert_count", "steps"):
                    if not torch.equal(gt[f], wt[f]):
                        bad.append(f"{kind} rank {r} {f}")
                err = max(err, max_err(gt["expert_ema"], wt["expert_ema"])
                          / max(1.0, wt["expert_ema"].abs().max().item()))
                if not all(same_bits(gt[f], got[0][kind]["traffic"][f])
                           for f in gt):
                    bad.append(f"{kind} traffic bits ranks 0, {r}")
        if bad or not err <= TOL_TRAFFIC:
            raise AssertionError(f"grid serve {arch} {engine} f32: {bad}; "
                                 f"expert EMA {err:.3g} (tol {TOL_TRAFFIC})")
        label = f"grid {shape} serve {arch} {engine}" + (
            " FSDP" if fsdp else "")
        launches[f"{label} rank 0"] = got[0]["launches"]
        lines.append(
            f"reduced {arch} {engine}{', FSDP of the experts' if fsdp else ''}"
            f" f32, continuous (pool 4) and waved engines: streams on every "
            f"rank equal the card alone's ({len(w['continuous']['streams'])} "
            f"requests, {sum(map(len, w['continuous']['streams']))} tokens), "
            f"last_expert_count and steps equal, expert EMA {err:.3g} of "
            f"max(1, |x|) (tol {TOL_TRAFFIC}), traffic bits equal on the {n} "
            f"ranks; rank 0 launches {json.dumps(got[0]['launches'])}; "
            f"{got[0]['seconds']:.1f} s on rank 0")

    got = [torch.load(f"{out_dir}/serve-full-rank{r}.pt") for r in range(n)]
    cfg = get_arch(spec["arch"])
    cfg = cfg.reduced() if spec["reduced"] else cfg
    cfg = dataclasses.replace(cfg, n_layers=spec["layers"])
    held = 2 * lm.param_counts(cfg)[1] // model // (data if got[0]["fsdp"]
                                                     else 1)
    if not spec["reduced"] and (held != GRID_EXPERT_BYTES
                                or not got[0]["fsdp"]):
        raise AssertionError(f"grid serve: FSDP {got[0]['fsdp']}, {held} "
                             f"expert bytes a rank reckoned, not "
                             f"{GRID_EXPERT_BYTES}")
    chunk = got[0]["chunk"]
    k = chunk // data                  # rows a data rank prefills a chunk
    want = want_full["first_logits"].float()
    rel = lambda a, b: ((a.float() - b).abs().max()
                        / max(1.0, b.abs().max().item())).item()
    # each request's distance to the nearest other request's card logits
    apart = [min(rel(want[j], want[i]) for j in range(len(want)) if j != i)
             for i in range(len(want))]
    flat = max(rel(a, b) for a, b in zip(want_full["flat_logits"], want))
    errs, shares, bad = [], [], []
    for r, g in enumerate(got):
        d = r // model
        rows = [a * chunk + d * k + j for a in range(g["admissions"])
                for j in range(k)]
        e = [rel(g["first_logits"][i], want[q]) for i, q in enumerate(rows)]
        errs.append(max(e))
        shares.append(max(x / (TOL_GRID_APART * apart[q])
                          for x, q in zip(e, rows)))
        if g["streams"] != got[0]["streams"]:
            bad.append(f"rank {r} streams")
        if g["expert_bytes"] != held or g["built"][0] != g["built"][1]:
            bad.append(f"rank {r}: expert bytes {g['expert_bytes']} (reckoned"
                       f" {held}), callables {g['built']}")
    streams = got[0]["streams"]
    if (len(streams) != spec["requests"]
            or any(len(t) != spec["gen"] for t in streams)
            or not all(0 <= t < cfg.vocab for q in streams for t in q)):
        bad.append(f"streams {streams}")
    implied = grid_serve_implied(spec, got[0]["admissions"],
                                 got[0]["decode_steps"])
    if got[0]["launches"] != implied:
        bad.append(f"rank 0 launches {got[0]['launches']}, implied "
                   f"{implied}")
    if bad or not max(shares) <= 1.0:
        raise AssertionError(f"grid serve full width: {bad}; first-token "
                             f"logits against the card alone {errs}, "
                             f"{shares} of the tolerance ({TOL_GRID_APART} x "
                             f"each request's distance to the nearest other, "
                             f"{apart})")
    gib = lambda x: "n/a" if x is None else f"{x:.2f}"
    launches[grid_serve_path(spec, shape)] = got[0]["launches"]
    lines.append(
        f"{cfg.name} {spec['layers']} layers bf16, {spec['engine']} node size "
        f"1, FSDP of the experts by the reference's rule "
        f"({got[0]['fsdp']}), continuous engine pool {spec['max_batch']}, "
        f"{spec['requests']} requests of {spec['prompt']} tokens, "
        f"{spec['gen']} each, capacity factor {spec['capacity']:g}: expert "
        f"bytes per rank {[g['expert_bytes'] for g in got]} (reckoned "
        f"{held}); peak memory per rank "
        f"{[gib(g['peak_gib']) for g in got]} GiB; streams equal on the {n} "
        f"ranks; first-token logits against the card alone, worst row per "
        f"rank {[f'{e:.3g}' for e in errs]} of max(1, |logit|), "
        f"{max(shares):.3f} of the tolerance ({TOL_GRID_APART:g} x the "
        f"distance to the nearest other request's, {min(apart):.3g} or more;"
        f" the card alone's fused_flat against its {spec['engine']}: "
        f"{flat:.3g}); {got[0]['admissions']} admissions of "
        f"{chunk} rows, {got[0]['decode_steps']} decode steps; rank 0 "
        f"launches {json.dumps(got[0]['launches'])} = implied; run "
        f"{[round(g['run_s'], 3) for g in got]} s a rank (gloo through the "
        f"host: not a speed), {got[0]['seconds']:.1f} s in all on rank 0; "
        f"sample {streams[0]}")
    return lines, launches


def phase_config(spec: dict):
    """``spec``'s architecture (reduced, and cut to ``layers``, as it
    says)."""
    import dataclasses
    from repro_torch.configs import get_arch
    cfg = get_arch(spec["arch"])
    cfg = cfg.reduced() if spec["reduced"] else cfg
    return (cfg if spec["layers"] is None
            else dataclasses.replace(cfg, n_layers=spec["layers"]))


def _pipe_inputs(cfg, spec: dict, device):
    """The seeded layer tree (bf16, stacked on L), the (n_micro, 1, S, d)
    microbatches, the loss weights c (f32) and the positions."""
    import torch
    from repro_torch.models import lm
    ctx = lm.make_context(cfg, device)
    gen = torch.Generator(device=ctx.device).manual_seed(spec["seed"])
    layers = lm.init_params(cfg, ctx, gen)["layers"]
    shape = (spec["n_micro"], 1, spec["seq"], cfg.d_model)
    gen.manual_seed(spec["seed"] + 1)
    xs = torch.randn(shape, generator=gen, device=ctx.device).to(torch.bfloat16)
    c = torch.randn(shape, generator=gen, device=ctx.device)
    return ctx, layers, xs, c, torch.arange(spec["seq"], device=ctx.device)


def _stack_fn(ctx, positions):
    """The stage body: each layer of a stacked tree through
    ``lm._seq_layer``."""
    from repro_torch.models import lm

    def run(params, h):
        for lp in lm._unstack(params, ctx.compute_dtype):
            h = lm._seq_layer(h, lp, positions, ctx)[0]
        return h
    return run


def _host_timed(fn, record: list):
    """``fn`` with each call's host-clock ms (device synchronised before and
    after) appended to ``record``."""
    import torch

    def timed(*a, **kw):
        sync = torch.cuda.synchronize if a[0].is_cuda else (lambda: None)
        sync()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        sync()
        record.append((time.perf_counter() - t0) * 1e3)
        return out
    return timed


def pipeline_rank(rank, out_dir, device, spec=PIPE) -> None:
    """One rank of the pipeline phase on ``dist.group.WORLD`` (every rank of
    an initialised group calls it): this rank's stage of ``spec``'s stacked
    layers (``pipeline.stage_slice``), one ``pipeline_apply`` forward and
    backward of sum(out * c), each hop and the broadcast timed by host clock
    (``pipeline._shift``, forward and backward, and
    ``pipeline.from_last_stage``), its launches; its dw, dx, launches and
    times saved to ``out_dir``.  Then rank 0 runs the same layers
    sequentially, one microbatch at a time (its launches counted apart),
    and holds the pipelined output, every stage's dw and every rank's dx
    against them (:data:`PIPE_UNIT`), saving what it found."""
    import torch
    import torch.distributed as dist
    from repro_torch.optim import adamw
    from repro_torch.parallel import pipeline
    start = time.perf_counter()
    cfg = phase_config(spec)
    n = dist.get_world_size()
    ctx, whole, xs, c, positions = _pipe_inputs(cfg, spec, device)
    per = cfg.n_layers // n
    stacked = adamw.tree_map(
        lambda p: p.reshape(n, per, *p.shape[1:]), whole)
    mine = adamw.tree_map(lambda p: p.clone().requires_grad_(),
                          pipeline.stage_slice(stacked, rank))
    del stacked
    if rank:
        del whole
    x = xs.clone().requires_grad_()
    hops, bcast = [], []
    shift, last = pipeline._shift, pipeline.from_last_stage
    pipeline._shift = _host_timed(shift, hops)
    pipeline.from_last_stage = _host_timed(last, bcast)
    wrappers = zero_counters()
    t0 = time.perf_counter()
    try:
        out = pipeline.pipeline_apply(_stack_fn(ctx, positions), mine, x,
                                      group=dist.group.WORLD)
        (out.float() * c).sum().backward()
    finally:
        pipeline._shift, pipeline.from_last_stage = shift, last
    if x.is_cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = {"launches": {k: w.launches for k, w in wrappers.items()},
           "hop_ms": hops, "bcast_ms": bcast, "seconds": seconds,
           "dx": x.grad.cpu(),
           "dw": {k: t.grad.cpu() for k, t in zip(adamw.paths(mine),
                                                  adamw.leaves(mine))}}
    torch.save(got, f"{out_dir}/pipe-rank{rank}.pt")
    dist.barrier()
    if rank == 0:
        held = _pipe_held(ctx, whole, xs, c, positions, out.detach(), spec, n,
                          out_dir)
        held["phase_s"] = time.perf_counter() - start
        torch.save(held, f"{out_dir}/pipe-held.pt")


def _pipe_held(ctx, whole, xs, c, positions, out, spec, n, out_dir) -> dict:
    """Rank 0's sequential reference and the comparisons of
    :func:`pipeline_rank`: per microbatch, the 28 layers forward and
    backward alone, the exact sum S and the sum A of |g_m| of its bf16
    gradients in f32; the pipelined output's bits against the sequential
    ones (where they part, the first microbatch and the count), each
    stage's dw and each rank's dx as a share of n_micro * 2^-8 * A (dx:
    one term), and whether each is bit-equal to the bf16 rounding of S."""
    import torch
    from repro_torch.optim import adamw
    n_micro = spec["n_micro"]
    leaves = [p.requires_grad_() for p in adamw.leaves(whole)]
    paths = adamw.paths(whole)
    run = _stack_fn(ctx, positions)
    S = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
         for p in leaves]
    A = [torch.zeros_like(s) for s in S]
    dx_ref, parts = [], []
    wrappers = zero_counters()
    t0 = time.perf_counter()
    for m in range(n_micro):
        xm = xs[m].clone().requires_grad_()
        ym = run(whole, xm)
        *gs, gx = torch.autograd.grad((ym.float() * c[m]).sum(),
                                      leaves + [xm])
        for s, a, g in zip(S, A, gs, strict=True):
            s.add_(g.float())
            a.add_(g.float().abs())
        dx_ref.append(gx)
        if not same_bits(ym.detach(), out[m]):
            diff = ym.detach() != out[m]
            parts.append(f"microbatch {m}: {int(diff.sum())} elements, max "
                         f"|diff| {max_err(ym.detach(), out[m]):.3g}")
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    dx_ref = torch.stack(dx_ref)
    per = whole[next(iter(whole))].shape[0] // n
    share = lambda got, s, a, terms: (
        (got.float() - s).abs() / (terms * PIPE_UNIT * a)).nan_to_num(
        nan=0.0, posinf=float("inf")).max().item()
    shares, dw_bits = [], []
    for r in range(n):
        got = torch.load(f"{out_dir}/pipe-rank{r}.pt")
        cut = slice(r * per, (r + 1) * per)
        worst, exact = 0.0, 0
        for k, s, a in zip(paths, S, A, strict=True):
            g = got["dw"][k].to(s.device)
            worst = max(worst, share(g, s[cut], a[cut], n_micro))
            exact += same_bits(g, s[cut].to(g.dtype))
        dx = got["dx"].to(xs.device)
        shares.append((worst, share(dx, dx_ref.float(), dx_ref.float().abs(),
                                    1), same_bits(dx, dx_ref)))
        dw_bits.append(f"{exact}/{len(paths)}")
    return {"out_bits": not parts, "parts": parts, "shares": shares,
            "dw_bits": dw_bits, "seq_launches": launches, "seq_s": seq_s,
            "loss": (out.float() * c).sum().item()}


def pipeline_check(out_dir, spec=PIPE) -> tuple[list[str], dict]:
    """The pipeline phase's results against ``PIPE``'s tolerances: the
    output bit-equal to the sequential stack's (else where it parts), every
    stage's dw and every rank's dx within n_micro * 2^-8 * sum_m |g_m| (dx:
    2^-8 |g|), the flash forward launched exactly layers / stage x (n_micro
    + stages - 1) times on every rank in the pipelined call and layers x
    n_micro times in rank 0's sequential reference.  Returns the lines and
    rank 0's pipelined launches."""
    import math
    import torch
    cfg = phase_config(spec)
    held = torch.load(f"{out_dir}/pipe-held.pt")
    n = len(held["shares"])
    got = [torch.load(f"{out_dir}/pipe-rank{r}.pt") for r in range(n)]
    per, n_micro = cfg.n_layers // n, spec["n_micro"]
    want_pipe = per * (n_micro + n - 1)
    want_seq = cfg.n_layers * n_micro
    flash = [g["launches"]["flash_attention"] for g in got]
    others = [{k: v for k, v in g["launches"].items()
               if k != "flash_attention" and v} for g in got]
    worst = max(max(w, x) for w, x, _ in held["shares"])
    bad = []
    if flash != [want_pipe] * n or any(others):
        bad.append(f"pipelined launches {[g['launches'] for g in got]}, want "
                   f"flash {want_pipe} a rank and nothing else")
    if held["seq_launches"]["flash_attention"] != want_seq:
        bad.append(f"sequential launches {held['seq_launches']}, want flash "
                   f"{want_seq}")
    if not held["out_bits"]:
        print(f"pipeline: the pipelined output parts from the sequential "
              f"stack's: {held['parts']}")
    if bad or not worst <= 1.0 or not math.isfinite(held["loss"]):
        raise AssertionError(f"pipeline {cfg.name}: {bad}; worst dw / dx "
                             f"share {held['shares']} (tol 1); loss "
                             f"{held['loss']}")
    hops = max(max(g["hop_ms"]) for g in got)
    bcast = max(max(g["bcast_ms"]) for g in got)
    line = (f"{cfg.name} {cfg.n_layers} layers (d {cfg.d_model}, "
            f"{cfg.n_heads} / {cfg.n_kv_heads} heads of {cfg.hd}, f "
            f"{cfg.d_ff}) in {n} stages of {per}, bf16, {n_micro} "
            f"microbatches of (1, {spec['seq']}, {cfg.d_model}): output "
            + ("bit-equal to the sequential stack's" if held["out_bits"] else
               f"parts from the sequential stack's ({held['parts']}; the same "
               f"kernels at the same shapes should give its bits)")
            + f"; worst share of the tolerance (n_micro x 2^-8 x sum |g_m|; "
            f"dx one term) per rank (dw, dx, dx bit-equal) "
            f"{[(round(w, 4), round(x, 4), b) for w, x, b in held['shares']]}; "
            f"dw leaves bit-equal to the rounded exact sum per stage "
            f"{held['dw_bits']}; flash forwards per rank {flash} (want "
            f"{want_pipe} = {per} x ({n_micro} + {n} - 1)), rank 0's "
            f"sequential reference {held['seq_launches']['flash_attention']}"
            f" (want {want_seq}); host clock: longest hop {hops:.3f} ms "
            f"(of {len(got[0]['hop_ms'])} a rank, forward and backward), "
            f"the broadcast {bcast:.3f} ms (gloo through the host: the path "
            f"works, no speed); the pipelined forward+backward "
            f"{[round(g['seconds'], 3) for g in got]} s a rank, the "
            f"sequential reference {held['seq_s']:.3f} s, the phase on rank "
            f"0 {held['phase_s']:.1f} s; loss {held['loss']:.6g}")
    return [line], got[0]["launches"]


# the compress phase: a gradient tree of qwen3-1.7b's leaf shapes in bf16,
# seeded, through ``compress_grads`` and ``decompress_grads`` for 4 rounds of
# error feedback; the card's q and scales against the CPU's on a subtree
COMPRESS = dict(arch="qwen3-1.7b", reduced=False, layers=None, rounds=4,
                block=256, seed=0)
# every block's error within max|block| / 254, with room for the f32
# roundings of the division, the product and the difference (~3e-5 of it)
COMPRESS_SLACK = 1 + 2.0 ** -14


def compress_phase(device="cuda", spec=COMPRESS, timer=time_ms) -> str:
    """``spec``'s rounds of ``compress_grads`` and ``decompress_grads`` on
    ``device``: each round's q and scales meet the per-block bound (every
    element of the new error within max|block| / 254 x
    ``COMPRESS_SLACK`` of its block of g + e); ``decompress_grads`` keeps
    each leaf's shape and dtype; in the last round the same call on
    ``embed`` and one layer's leaves gives the CPU's q, scales and error
    bits; one ``compress_grads`` over the whole tree is timed (``timer``)
    against its bytes bound (g and e read, q, the scales and the new e
    written).  Returns the line."""
    import torch
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.parallel import compress
    cfg = phase_config(spec)
    block = spec["block"]
    ctx = lm.make_context(cfg, device)
    gen = torch.Generator(device=ctx.device).manual_seed(spec["seed"])
    like = lm.init_params(cfg, ctx, gen)
    shapes = adamw.tree_map(lambda p: p.shape, like)
    del like
    draw = lambda: adamw.tree_map(lambda s: torch.randn(
        s, generator=gen, device=ctx.device).to(torch.bfloat16), shapes)
    ef = compress.init_error(draw())
    worst, blocks, cpu_bits = 0.0, 0, None
    for rnd in range(spec["rounds"]):
        grads = draw()
        if rnd == spec["rounds"] - 1:
            # embed and layer 0 of each stacked layer leaf, held on the CPU
            sub_g, sub_e = ({"embed": t["embed"], "layers": adamw.tree_map(
                lambda p: p[0].contiguous(), t["layers"])}
                for t in (grads, ef.error))
            on_card = compress.compress_grads(sub_g, compress.EFState(sub_e),
                                              block)
            on_cpu = compress.compress_grads(
                adamw.tree_map(lambda t: t.cpu(), sub_g),
                compress.EFState(adamw.tree_map(lambda t: t.cpu(), sub_e)),
                block)
            cpu_bits = [
                p for p, (q, s), (qc, sc), e, ec in zip(
                    adamw.paths(on_card[1]), on_card[0], on_cpu[0],
                    adamw.leaves(on_card[2].error),
                    adamw.leaves(on_cpu[2].error), strict=True)
                if not (same_bits(q.cpu(), qc) and same_bits(s.cpu(), sc)
                        and same_bits(e.cpu(), ec))]
            del on_card, on_cpu, sub_g, sub_e
        old = ef.error
        qs, treedef, ef = compress.compress_grads(grads, ef, block)
        for g, e, (q, s), new in zip(adamw.leaves(grads), adamw.leaves(old),
                                     qs, adamw.leaves(ef.error), strict=True):
            val = g.float() + e
            pad = (-val.numel()) % block
            vb = torch.nn.functional.pad(val.reshape(-1), (0, pad))
            nb = torch.nn.functional.pad(new.reshape(-1), (0, pad))
            m = vb.reshape(-1, block).abs().amax(1)
            emax = nb.reshape(-1, block).abs().amax(1)
            ratio = torch.where(m > 0, emax / (m / 254.0),
                                torch.where(emax > 0, float("inf"), 0.0))
            worst = max(worst, ratio.max().item())
            blocks += m.numel()
            del val, vb, nb
        out = compress.decompress_grads(qs, treedef, adamw.leaves(grads),
                                        block)
        kept = all(o.shape == g.shape and o.dtype == g.dtype for o, g in zip(
            adamw.leaves(out), adamw.leaves(grads), strict=True))
        del old, qs, out
        if not kept or not worst <= COMPRESS_SLACK:
            raise AssertionError(f"compress round {rnd}: shapes and dtypes "
                                 f"kept {kept}; worst block error {worst} of "
                                 f"max|block| / 254 (tol {COMPRESS_SLACK})")
    if cpu_bits:
        raise AssertionError(f"compress: the card's q, scales or error "
                             f"differ from the CPU's at {cpu_bits}")
    n = sum(g.numel() for g in adamw.leaves(grads))
    n_blocks = sum(-(-g.numel() // block) for g in adamw.leaves(grads))
    nbytes = n * (2 + 4 + 1 + 4) + n_blocks * 4
    b_ms, b_by = bound(nbytes, 0, BF16_PEAK)
    ms = timer(lambda: compress.compress_grads(grads, ef, block), reps=1,
               warmup=1)
    return (f"{cfg.name} gradient tree, {len(adamw.leaves(grads))} leaves, "
            f"{n} bf16 elements, block {block}, {spec['rounds']} rounds of "
            f"error feedback: worst block error {worst:.6f} of max|block| / "
            f"254 over {blocks} blocks (tol {COMPRESS_SLACK:.6f}); "
            f"decompress_grads keeps every leaf's shape and dtype; the last "
            f"round's q, scales and error on embed and layer 0's leaves "
            f"bit-equal to the CPU's; one compress_grads {ms:.4f} ms"
            f"{spread(ms)} (CUDA events, median of 5) against its bound "
            f"{b_ms:.4f} ms ({b_by}: {nbytes} B, g and e read, q, the scales "
            f"and the new e written), {ms / b_ms:.2f}x; {card_line()}")


def held_params(cfg, model: int, tp: bool = True) -> int:
    """The parameters a rank holds at a model group of ``model`` in the
    training layout: 1 / model of the expert leaves, of ``embed`` and
    ``lm_head`` (``lm.vocab_param_count``: split on the vocab or on d) and,
    with ``tp`` where Megatron TP applies (``lm.ModelContext.tp_eligible``'s
    rule: the dense and moe families, the heads split evenly), of the TP
    leaves (``lm.tp_param_count``); the rest whole."""
    from repro_torch.models import lm
    replicated, experts = lm.param_counts(cfg)
    split = lm.vocab_param_count(cfg, model) + (
        lm.tp_param_count(cfg) if tp and model > 1
        and cfg.n_heads % model == 0 and cfg.family in ("dense", "moe")
        else 0)
    return replicated - split + split // model + experts // model


def _zero1_rank(rank, port, out_dir, argvs, device):
    """One rank of the full-width grid runs: ``train.run`` of each of
    ``argvs`` in turn on the grid, each run's results saved to
    ``out_dir``."""
    import torch
    import torch.distributed as dist
    mesh = _grid_init(rank, port, device)
    try:
        from repro_torch.launch import train
        for i, argv in enumerate(argvs):
            wrappers = zero_counters()
            out = train.run(train.parse_args(argv), device, mesh=mesh)
            torch.save({k: out[k] for k in ("losses", "step_ms", "ms_per_step",
                                            "peak_mem_gib", "opt_state_gib",
                                            "expert_param_bytes")}
                       | {"launches": {k: w.launches
                                       for k, w in wrappers.items()}},
                       f"{out_dir}/zero1-{i}-rank{rank}.pt")
            del out
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


# the full-width grid runs of ``zero1_phase``, in one spawn: ZeRO-1, then
# the same with the expert weights split over the data group too (FSDP)
ZERO1_RUNS = (ZERO1, ZERO1 + ["--fsdp-experts", "on"])


def zero1_phase(argvs=ZERO1_RUNS, device="cuda") -> list[list[str]]:
    """``train.run`` of each of ``argvs`` (qwen3-moe at full width, one
    layer) on a (2, 2) grid of four gloo ranks sharing the card, all in one
    spawn, after the first on the card alone: each rank's AdamW state (the
    bytes of its tensors) must equal the ZeRO-1 reckoning from the
    parameter counts, 12 bytes a held parameter over DP; its losses must be
    finite and the same on all four ranks, the first within
    ``TOL_ZERO1_LOSS`` relative of the one-card run's.  Prints each rank's
    state, peak memory, losses and ms/step (gloo stages every collective
    through the host: not a speed).  Each run after the first
    (``--fsdp-experts on``) splits the expert weights over the data group
    too: its one-card run is the first's, and each rank's bf16 expert bytes
    must be exactly half of the first run's rank's (the AdamW state is the
    same reckoning: ZeRO-1 already cuts the experts' state over DP).
    Returns the lines of each run."""
    import dataclasses
    import math
    import shutil
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    args = train.parse_args(argvs[0])
    cfg = get_arch(args.arch)
    cfg = cfg.reduced() if args.reduced else cfg
    cfg = dataclasses.replace(cfg, n_layers=args.layers or cfg.n_layers)
    data, model = GRID
    held = held_params(cfg, model)
    reckoned = 12 * held // data
    torch.cuda.empty_cache()
    one = train.run(args, device)
    one = {k: one[k] for k in ("losses", "peak_mem_gib", "opt_state_gib")}
    torch.cuda.empty_cache()
    out_dir = ROOT / "build" / "zero1"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    n = data * model
    on_card = torch.device(device).type == "cuda"
    spawn_ranks(_zero1_rank, n, (free_port(), str(out_dir), argvs,
                                 "cuda:0" if on_card else device), 900)
    runs = [[torch.load(out_dir / f"zero1-{i}-rank{r}.pt") for r in range(n)]
            for i in range(len(argvs))]
    shutil.rmtree(out_dir, ignore_errors=True)
    gib = lambda x: "n/a" if x is None else f"{x:.2f}"
    out = []
    for i, got in enumerate(runs):
        against = runs[0] if i else None
        lines = [f"one card: losses {one['losses']}, AdamW state "
                 f"{one['opt_state_gib']:.4f} GiB, peak memory "
                 f"{gib(one['peak_mem_gib'])} GiB"]
        for r, g in enumerate(got):
            lines.append(
                f"rank {r} (data {r // model}, lane {r % model}): AdamW state "
                f"{g['opt_state_gib']:.4f} GiB measured, "
                f"{reckoned / 2**30:.4f} reckoned ({held} parameters held, 12 "
                f"bytes each over DP {data}); peak memory "
                f"{gib(g['peak_mem_gib'])} GiB; losses {g['losses']}; "
                f"{g['ms_per_step']:.1f} ms/step (gloo through the host, not "
                f"a speed); launches {json.dumps(g['launches'])}")
        first = (abs(got[0]["losses"][0] - one["losses"][0])
                 / abs(one["losses"][0]))
        halves = ([g["expert_param_bytes"] * 2 == z["expert_param_bytes"]
                   for g, z in zip(got, against)]
                  if against is not None else [True] * n)
        bad = [r for r, g in enumerate(got)
               if g["opt_state_gib"] * 2**30 != reckoned
               or g["losses"] != got[0]["losses"] or not halves[r]
               or not all(math.isfinite(x) for x in g["losses"])]
        if against is not None:
            lines += [f"rank {r}: bf16 expert parameters "
                      f"{g['expert_param_bytes']} B, the ZeRO-1 rank's "
                      f"{z['expert_param_bytes']} B; peak memory "
                      f"{gib(g['peak_mem_gib'])} GiB beside ZeRO-1's "
                      f"{gib(z['peak_mem_gib'])} GiB"
                      for r, (g, z) in enumerate(zip(got, against))]
        if bad or first > TOL_ZERO1_LOSS:
            raise AssertionError("\n".join(lines) + f"\nfull-width grid run "
                                 f"{' '.join(argvs[i])}: ranks {bad} off "
                                 f"(state, losses, expert bytes); first loss "
                                 f"{first:.3g} from the one-card run's (tol "
                                 f"{TOL_ZERO1_LOSS})")
        lines.append(f"first loss vs the one-card run: {first:.3g} relative "
                     f"(tol {TOL_ZERO1_LOSS})")
        out.append(lines)
    return out


# the full-width steps over a model group (``tp_full_phase``): one train
# step of each argv (``train.setup``'s seed-0 params and first global batch)
# on a (1, m) grid of m gloo ranks sharing the card and on the card alone,
# bf16, B 4 x S 512; the moe steps at capacity factor 16 (no row dropped at
# any EP); every step splits embed and lm_head over the group; label ->
# (argv, m, Megatron TP: False is the moe family's replicated attention,
# ``explicit_tp=False``, its step run again with the vocab pair whole)
TP_FLAGS = ["--batch", "4", "--seq", "512"]
TP_MOE = ["--arch", "qwen3-moe-30b-a3b", "--layers", "1",
          "--capacity-factor", "16"] + TP_FLAGS
TP_FULL = {"qwen3-1.7b TP 2": (["--arch", "qwen3-1.7b", "--layers", "2"]
                               + TP_FLAGS, 2, True),
           "qwen3-moe-30b-a3b TP 2": (TP_MOE, 2, True),
           "qwen3-moe-30b-a3b EP 2, no TP": (TP_MOE, 2, False),
           "qwen3-moe-30b-a3b TP 4": (TP_MOE, 4, True)}
TOL_TP_LOSS = 2e-3        # the step's loss, grid vs one card, relative: bf16


def tp_shapes(argv, model: int):
    """(config, q heads a rank, kv heads rank 0 reads) of a ``TP_FULL``
    step (``tp_blocks.kv_heads``)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    from repro_torch.parallel import tp_blocks
    args = train.parse_args(argv)
    cfg = get_arch(args.arch)
    cfg = dataclasses.replace(cfg.reduced() if args.reduced else cfg,
                              n_layers=args.layers or cfg.n_layers)
    kv, _ = tp_blocks.kv_heads(cfg.n_heads, cfg.n_kv_heads, model, 0)
    return cfg, cfg.n_heads // model, len(kv)


def tp_flash_rows(timer=time_ms, device="cuda") -> list[dict]:
    """The flash forward at each ``TP_FULL`` step's shard shape: B 4 x S
    512, the rank's q heads and the kv heads they read."""
    rows = []
    for label, (argv, model, tp) in TP_FULL.items():
        if not tp:
            continue
        cfg, hl, kv = tp_shapes(argv, model)
        rows.append(dict(flash_row(*attention_inputs(
            device, b=4, sq=512, sk=512, hq=hl, hkv=kv, hd=cfg.hd),
            window=None, timer=timer), path=label))
    return rows


def tp_step(argv, device, mesh=None, explicit_tp: bool = True,
            split_vocab: bool = True) -> dict:
    """One train step of ``argv`` through ``train.setup`` (the seed-0
    params and data source of ``train.run``; its context's
    ``explicit_tp`` and ``split_vocab`` replaced when either is False, the
    params drawn again for it from the same seed) on ``device``, over
    ``mesh`` (None: one rank) on this data rank's rows of the first global
    batch: the loss, this rank's parameter and AdamW bytes, the bytes of
    the gradients ``steps.reduce_replicated`` sums (the replicated bucket;
    0 on one rank), the kernels' launches and the (q, kv) heads of every
    flash call of the TP blocks."""
    import dataclasses
    import torch
    from repro_torch.data.pipeline import to_device
    from repro_torch.launch import steps, train
    from repro_torch.models import lm, zoo
    from repro_torch.optim import adamw
    from repro_torch.parallel import tp_blocks
    args = train.parse_args(argv)
    s = train.setup(args, device, mesh=mesh)
    if not (explicit_tp and split_vocab):
        ctx = dataclasses.replace(s.ctx, explicit_tp=explicit_tp,
                                  split_vocab=split_vocab)
        s = s._replace(ctx=ctx, params=None)
        s = s._replace(params=lm.init_params(s.cfg, ctx, torch.Generator(
            device=ctx.device).manual_seed(train.SEED)))
    model = zoo.build(s.cfg, s.ctx)
    dp, d = (1, 0) if mesh is None else (mesh.data, mesh.data_index)
    batch = to_device(train.shard_batch(s.source.batch_at(0), dp, d)[0],
                      device)
    opt = steps.init_state(model, s.params)
    heads, attn = [], tp_blocks.causal_attention

    def recording(q, k, *a, **kw):
        heads.append((q.shape[2], k.shape[2]))
        return attn(q, k, *a, **kw)

    bucket, sync = [], steps.reduce_replicated

    def measured(grads, paths, group, sharded=lm.lane_sharded):
        bucket.extend(g.numel() * g.element_size()
                      for p, g in zip(paths, grads) if not sharded(p))
        return sync(grads, paths, group, sharded)

    tp_blocks.causal_attention = recording
    steps.reduce_replicated = measured
    wrappers = zero_counters()
    try:
        _, opt, m = steps.make_train_step(model, s.opt_cfg)(
            s.params, opt, batch, train.init_traffic(s.cfg, s.ctx, 1))
    finally:
        tp_blocks.causal_attention = attn
        steps.reduce_replicated = sync
    return {"loss": float(m["loss"]),
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in adamw.leaves(s.params)),
            "opt_bytes": adamw.state_bytes(opt), "bucket_bytes": sum(bucket),
            "launches": {k: w.launches for k, w in wrappers.items()},
            "heads": heads}


def _tp_full_rank(rank, port, out_dir, runs, model, device):
    """One rank of the full-width steps (:func:`tp_step`) of ``runs``
    ((label, argv, tp) triples) on a (1, ``model``) grid, in turn, each
    result saved to ``out_dir``; a step without TP runs again with the
    vocab pair whole (``split_vocab=False``, saved as ``-whole``)."""
    import torch
    import torch.distributed as dist
    mesh = _grid_init(rank, port, device, (1, model))
    try:
        for i, (_, argv, tp) in enumerate(runs):
            for tag, split in (("", True),) + ((("-whole", False),)
                                               if not tp else ()):
                torch.save(tp_step(argv, device, mesh, explicit_tp=tp,
                                   split_vocab=split),
                           f"{out_dir}/tp{i}{tag}-rank{rank}.pt")
                if torch.device(device).type == "cuda":
                    torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def tp_full_phase(device="cuda") -> tuple[list[str], dict]:
    """Each ``TP_FULL`` step on its (1, m) grid of gloo ranks sharing the
    card (Megatron TP over the model group, the default, or the moe
    family's replicated attention; ``embed`` and ``lm_head`` split over
    the group either way) after the same step on the card alone: every
    rank's loss the same and within ``TOL_TP_LOSS`` relative of the
    one-card step's; each rank's bf16 parameter bytes and AdamW bytes (f32
    master, mu, nu) the reckoning of what it holds (``held_params``: 2 and
    12 bytes a parameter); under TP every flash call of rank 0 takes q of
    n_heads / m heads beside the kv heads they read (without TP no call of
    the TP blocks); every kernel of the family's path launched on rank 0.
    A step without TP runs again with the pair whole: its loss within
    ``TOL_TP_LOSS`` too, its replicated bucket on rank 0 2 bytes a
    parameter of the whole replicated tree, and the split step's exactly
    the pair's 4 V d bytes less.  The steps of one m run in one spawn.
    Returns the lines and rank 0's launches by label."""
    import math
    import shutil
    import torch
    out_dir = ROOT / "build" / "tp"
    on_card = torch.device(device).type == "cuda"
    ones, lines, launches, got_of, whole_of = {}, [], {}, {}, {}
    for argv, _, _ in TP_FULL.values():
        if tuple(argv) not in ones:
            ones[tuple(argv)] = tp_step(argv, device)
            if on_card:
                torch.cuda.empty_cache()
    for model in sorted({m for _, m, _ in TP_FULL.values()}):
        runs = [(label, argv, tp) for label, (argv, m, tp) in TP_FULL.items()
                if m == model]
        shutil.rmtree(out_dir, ignore_errors=True)
        out_dir.mkdir(parents=True)
        spawn_ranks(_tp_full_rank, model, (
            free_port(), str(out_dir), runs, model,
            "cuda:0" if on_card else device), 600)
        for i, (label, _, tp) in enumerate(runs):
            got_of[label] = [torch.load(out_dir / f"tp{i}-rank{r}.pt")
                             for r in range(model)]
            if not tp:
                whole_of[label] = [torch.load(out_dir / f"tp{i}-whole-rank"
                                              f"{r}.pt") for r in range(model)]
        shutil.rmtree(out_dir, ignore_errors=True)
    for label, (argv, model, tp) in TP_FULL.items():
        cfg, hl, kv = tp_shapes(argv, model)
        one, got = ones[tuple(argv)], got_of[label]
        held = held_params(cfg, model, tp)
        first = abs(got[0]["loss"] - one["loss"]) / abs(one["loss"])
        required, _ = family_kernels(cfg, train=True)
        never = [k for k in required if got[0]["launches"][k] == 0]
        bad = [r for r, g in enumerate(got)
               if g["param_bytes"] != 2 * held or g["opt_bytes"] != 12 * held
               or g["loss"] != got[0]["loss"] or not math.isfinite(g["loss"])]
        heads = sorted(set(got[0]["heads"]))
        want_heads = [(hl, kv)] if tp else []
        line = (f"{label}: one card loss {one['loss']}, params "
                f"{one['param_bytes']} B, AdamW {one['opt_bytes']} B; ranks' "
                f"losses {[g['loss'] for g in got]} ({first:.3g} relative, "
                f"tol {TOL_TP_LOSS}); params {[g['param_bytes'] for g in got]}"
                f" B and AdamW {[g['opt_bytes'] for g in got]} B a rank, "
                f"reckoned {2 * held} and {12 * held} ({held} parameters "
                f"held; embed and lm_head "
                f"{2 * cfg.vocab * cfg.d_model // model} a rank); rank 0's {len(got[0]['heads'])} TP flash calls at "
                f"(q, kv) heads {heads} (want {want_heads}); rank 0's "
                f"launches {json.dumps(got[0]['launches'])}")
        off = bad or never or first > TOL_TP_LOSS or heads != want_heads
        if not tp:
            from repro_torch.models import lm
            whole = whole_of[label]
            pair = 4 * cfg.vocab * cfg.d_model
            rep_bytes = 2 * lm.param_counts(cfg)[0]
            w_first = abs(whole[0]["loss"] - one["loss"]) / abs(one["loss"])
            less = whole[0]["bucket_bytes"] - got[0]["bucket_bytes"]
            line += (f"; replicated bucket on rank 0 {got[0]['bucket_bytes']}"
                     f" B with the pair split, {whole[0]['bucket_bytes']} B "
                     f"with it whole (loss {whole[0]['loss']}, {w_first:.3g} "
                     f"relative), {less} B less (want {pair}: 4 V d; whole "
                     f"reckoned {rep_bytes})")
            off = off or w_first > TOL_TP_LOSS or (
                whole[0]["bucket_bytes"] != rep_bytes) or (
                got[0]["bucket_bytes"] != rep_bytes - pair)
        if off:
            raise AssertionError(f"full-width step over the model group off "
                                 f"(ranks {bad}, never launched {never}): "
                                 f"{line}")
        lines.append(line)
        launches[label] = got[0]["launches"]
    return lines, launches


# the relayout phases: each train phase (TRAINS) re-laid out after every 4th
# of its 8 steps (two relayouts); at EP 1 a relayout permutes the experts of
# the one lane
RELAYOUT_EVERY = 4
RELAYOUTS = {f"{label} relayout": argv + ["--relayout-every",
                                          str(RELAYOUT_EVERY)]
             for label, argv in TRAINS.items()}
TOL_RELAYOUT = 2e-3     # loss at fixed params and batch before and after a
                        # migration, bf16, relative (the grid's first-loss
                        # figure)
TOL_MEAN = 1e-6         # the replica mean, f32 sums in another order


def relayout_phase(label: str, argv, implied: dict, device="cuda") -> dict:
    """A train phase with ``--relayout-every`` through ``train.run``, every
    launch counter zeroed just before it and read just after (``train_phase``):
    the counts must be ``implied``, the same run's without relayouts, since
    the migration launches none of the kernels.  Each relayout is wrapped to
    hold the loss at fixed parameters and batch (the run's first batch)
    before and after the migration within ``TOL_RELAYOUT`` (bf16; whether the
    bits are equal is reported), to run one MoE layer under the new table with
    the host's waits counted (``host_syncs``: none allowed), and to check that
    the migration itself launched no kernel; the wrapper's own launches are
    taken off the counts.  Returns the run, its launches and each relayout's
    record (``train.apply_relayout``'s stats, device and host ms, the bound
    of reading and writing every rewritten byte once)."""
    import torch
    from repro_torch.data.pipeline import ZipfNgramLM, to_device
    from repro_torch.launch import train
    from repro_torch.models import lm, zoo
    args = train.parse_args(argv)
    real, records = train.apply_relayout, []

    def checked(params, opt, traffic, ctx, **kw):
        wrappers = counters()
        saved = {k: w.launches for k, w in wrappers.items()}
        run_cfg = ctx.cfg
        batch = to_device(ZipfNgramLM(run_cfg.vocab, args.seq, args.batch,
                                      seed=train.SEED).batch_at(0), ctx.device)
        loss = lambda c: zoo.build(run_cfg, c).loss(params, batch)[0]
        with torch.no_grad():
            before = loss(ctx)
        mid = {k: w.launches for k, w in wrappers.items()}
        out = real(params, opt, traffic, ctx, **kw)
        moved = {k: w.launches - mid[k] for k, w in wrappers.items()}
        new_ctx = out[2]
        with torch.no_grad():
            after = loss(new_ctx)
            layer = {k: v[0] for k, v in params["layers"]["moe"].items()}
            x = torch.randn((args.batch, args.seq, run_cfg.d_model),
                            generator=torch.Generator(device=ctx.device)
                            .manual_seed(3), device=ctx.device,
                            dtype=ctx.compute_dtype)
            with host_syncs() as syncs:
                lm._moe_seq_sharded(x, layer, new_ctx)
        torch.cuda.synchronize()
        for k, w in wrappers.items():
            w.launches = saved[k]
        stats = out[3]
        records.append(dict(
            stats, loss_before=float(before), loss_after=float(after),
            same_bits=bool(torch.equal(before, after)), syncs=syncs,
            migration_launches=moved,
            bound_ms=2 * stats["rewritten_bytes"] / MEM_BW * 1e3))
        return out

    train.apply_relayout = checked
    try:
        torch.cuda.empty_cache()
        out, launches = train_phase(argv, device)
    finally:
        train.apply_relayout = real
    if launches != implied:
        raise AssertionError(f"{label}: launches {launches}, the same run "
                             f"without relayouts {implied}")
    want = args.steps // args.relayout_every
    for r in records:
        rel = abs(r["loss_after"] - r["loss_before"]) / abs(r["loss_before"])
        r["loss_rel"] = rel
        if (rel > TOL_RELAYOUT or r["syncs"] or any(r["migration_launches"]
                                                     .values())):
            raise AssertionError(
                f"{label}: a relayout moved the loss at fixed params by "
                f"{rel:.3g} (tol {TOL_RELAYOUT}), made the host wait in a "
                f"layer under the new table ({r['syncs'][:3]}) or launched "
                f"{r['migration_launches']} while migrating")
    if len(records) != want or len(out["relayouts"]) != want:
        raise AssertionError(f"{label}: {len(records)} relayouts, want {want}")
    return {"out": out, "launches": launches, "records": records}


def print_relayouts(label: str, argv, res: dict) -> None:
    """The relayout phase's lines: each relayout's record, then the run."""
    out = res["out"]
    ms = out["step_ms"]
    for r, s in zip(res["records"], out["relayouts"]):
        step = s["step"]
        after = f"{ms[step]:.3f}" if step < len(ms) else "none (the last)"
        lo, hi = r["max_lane_load"]
        print(f"{label}: relayout after step {step}: {r['rows_moved']}/"
              f"{r['slots']} expert blocks moved across lanes "
              f"({r['bytes_moved']} B), max-lane load {lo:.1f} -> {hi:.1f}; "
              f"rewrote {r['rewritten_bytes']} B of expert weights and AdamW "
              f"state: device {r.get('device_ms', float('nan')):.4f} ms (CUDA "
              f"events; bound "
              f"{r['bound_ms']:.4f} ms, each byte read and written once at "
              f"{MEM_BW:.3g} B/s), host {r['host_ms']:.3f} ms for the whole "
              f"swap; loss at fixed params and batch {r['loss_before']:.6f} "
              f"-> {r['loss_after']:.6f} ({r['loss_rel']:.3g} relative, tol "
              f"{TOL_RELAYOUT}; bits equal {r['same_bits']}); host waits in "
              f"one MoE layer under the new table: 0; step ms before "
              f"{ms[step - 1]:.3f}, after {after}")
    print(f"{label}: {' '.join(argv[argv.index('--batch'):])}: "
          f"{out['ms_per_step']:.3f} ms/step (median of the timed steps, the "
          f"swaps not in them), peak memory {out['peak_mem_gib']:.2f} GiB; "
          f"loss per step " + " ".join(f"{x:.5f}" for x in out["losses"])
          + f"; launches {json.dumps(res['launches'])}, the same run's "
          f"without relayouts")


# --engine auto: the qwen3-moe train cell (4 layers, B 4 x S 512) with the
# comm-path policy replanning at every relayout boundary, then a forced mix
# of one engine a layer
AUTO = ["--arch", "qwen3-moe-30b-a3b", "--engine", "auto", "--layers", "4",
        "--batch", "4", "--seq", "512", "--steps", "6", "--data", "zipf",
        "--relayout-every", "2"]
AUTO_MIXED = ("fused_flat", "fused_hier") * 2
AUTO_FORCED_STEPS = 2
TOL_MIXED = 2e-3        # first loss of the forced mix against fused_flat's:
                        # the engines compute one function, bf16 roundings
                        # apart (the relayout's figure)


def letters(engines, sep: str = " ") -> str:
    """A per-layer engine tuple as the [commplan] line writes it: F for
    fused_flat, H for fused_hier."""
    return sep.join("F" if e == "fused_flat" else "H" for e in engines)


def per_layer_step(launches: dict, argv) -> dict:
    """Each kernel's launches a layer a step of the fixed-engine train run
    of ``argv`` (``launches``: its counts); fails unless they divide."""
    steps = int(argv[argv.index("--steps") + 1])
    layers = int(argv[argv.index("--layers") + 1])
    if any(n % (steps * layers) for n in launches.values()):
        raise AssertionError(f"launches {launches} do not split over {steps} "
                             f"steps x {layers} layers")
    return {k: n // (steps * layers) for k, n in launches.items()}


def engines_implied(per_engine: dict, schedule) -> dict:
    """The launches a run implies whose steps ran the engines of
    ``schedule`` (one per-layer tuple a step), from each engine's launches a
    layer a step (``per_engine``)."""
    kernels = next(iter(per_engine.values()))
    return {k: sum(per_engine[e][k] for engines in schedule for e in engines)
            for k in kernels}


def engine_auto_phase(per_engine: dict, flat: dict, device="cuda") -> dict:
    """``--engine auto`` at full width (``AUTO``) through ``train.run``, the
    counters zeroed just before it and read just after (``train_phase``):
    each kernel's launches must equal the sum over steps and layers of its
    engine's per-layer count (``per_engine``: fused_flat's and fused_hier's,
    from their train phases), the layers running fused_hier until the
    first plan.  One step of the final engines is then profiled (device
    busy).  Then a forced mix (``AUTO_MIXED``) for ``AUTO_FORCED_STEPS``
    steps by hand: its launches held exactly, its first loss within
    ``TOL_MIXED`` relative of the fused_flat run's (``flat``: the "train"
    phase's record; the same params and batch).  Returns both runs'
    launches, the plans, the engines of each step, the auto run's losses,
    ms of each step, median ms/step and profiled busy ms, and the forced
    run's losses."""
    import dataclasses
    import torch
    from repro_torch.data.pipeline import to_device
    from repro_torch.launch import steps, train
    from repro_torch.models import zoo
    args = train.parse_args(AUTO)
    torch.cuda.empty_cache()
    out, launches = train_phase(AUTO, device, keep_state=True)
    layers = out["cfg"].n_layers
    plans = {p["step"]: p["engines"] for p in out["plans"]}
    engines, schedule = (train.base_engine(args),) * layers, []
    for i in range(args.steps):
        schedule.append(engines)
        engines = plans.get(i + 1, engines)
    implied = engines_implied(per_engine, schedule)
    if launches != implied or len(plans) != args.steps // args.relayout_every:
        raise AssertionError(f"--engine auto: launches {launches}, its "
                             f"per-layer engines {schedule} imply {implied}; "
                             f"plans {plans}")
    batch = to_device(run_batch(out["cfg"], args, 0), device)
    params, opt = out["state"]
    step, traffic = out["train_step"], out["traffic"]
    step(params, opt, batch, traffic)
    torch.cuda.synchronize()
    busy = profile_once(lambda: step(params, opt, batch, traffic))
    res = {"launches": launches, "plans": plans, "schedule": schedule,
           "ms_per_step": out["ms_per_step"], "step_ms": out["step_ms"],
           "losses": out["losses"],
           "busy_ms": None if busy is None else busy["busy_ms"]}
    del out, params, opt, step, traffic
    torch.cuda.empty_cache()

    s = train.setup(args, device)
    ctx = dataclasses.replace(s.ctx, engines=AUTO_MIXED)
    model = zoo.build(s.cfg, ctx)
    step = steps.make_train_step(model, s.opt_cfg)
    params, opt = s.params, steps.init_state(model, s.params)
    traffic = train.init_traffic(s.cfg, ctx, 1)
    wrappers = zero_counters()
    losses = []
    for i in range(AUTO_FORCED_STEPS):
        params, opt, m = step(params, opt, to_device(s.source.batch_at(i),
                                                     device), traffic)
        traffic = m["traffic"]
        losses.append(float(m["loss"]))
    forced = {k: w.launches for k, w in wrappers.items()}
    del s, ctx, model, step, params, opt, traffic
    torch.cuda.empty_cache()
    want = engines_implied(per_engine, [AUTO_MIXED] * AUTO_FORCED_STEPS)
    rel = abs(losses[0] - flat["losses"][0]) / abs(flat["losses"][0])
    if forced != want or rel > TOL_MIXED:
        raise AssertionError(f"forced engines {AUTO_MIXED}: launches {forced}, "
                             f"implied {want}; first loss {losses[0]} vs "
                             f"fused_flat's {flat['losses'][0]} ({rel:.3g} "
                             f"relative, tol {TOL_MIXED})")
    res.update(forced=forced, forced_implied=want, forced_losses=losses,
               forced_rel=rel)
    return res


def run_batch(cfg, args, step: int) -> dict:
    """The host batch of ``step`` that a train run of ``args`` draws."""
    from repro_torch.data.pipeline import ZipfNgramLM
    from repro_torch.launch import train
    return ZipfNgramLM(cfg.vocab, args.seq, args.batch,
                       seed=train.SEED).batch_at(step)


# the checkpoint phase: moe-ffn-stream-1b at full width cut to one layer,
# relayouts every 2 steps, a step-atomic checkpoint every 2 and one failure
# injected before step 3: the run restarts from step 2
CKPT = ["--arch", "moe-ffn-stream", "--layers", "1", "--batch", "4",
        "--seq", "512", "--steps", "6", "--data", "zipf", "--engine",
        "fused_flat", "--relayout-every", "2"]
CKPT_FLAGS = ["--ckpt-every", "2", "--inject-failure-at", "3"]
TOL_RESUME = 1e-5       # resumed losses, relative, only where the run itself
                        # is not repeatable bit for bit
RESUME = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.launch import train
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
out = train.run(train.parse_args(json.loads(sys.argv[2])), sys.argv[3])
print("RESUMED " + json.dumps({"first_step": out["first_step"],
                               "losses": out["losses"],
                               "restore_s": out["run"].restore_s,
                               "restarts": out["run"].restarts}),
      flush=True)
"""


def _leaves_equal(a, b) -> bool:
    import torch
    from repro_torch.checkpoint import checkpointer
    pairs = zip([t for _, t in checkpointer._flatten(a)],
                [t for _, t in checkpointer._flatten(b)])
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in pairs)


def checkpoint_phase(device="cuda") -> dict:
    """The fault-tolerant loop at full width (``CKPT``: moe-ffn-stream-1b,
    one layer, fused_flat, traffic and relayouts on) into a fresh temporary
    directory, removed at the end.  The bytes the phase writes (four
    committed steps: bf16 params and f32 mu, nu and master) are checked
    against the free space first.  The run with ``CKPT_FLAGS`` restarts
    once, from step 2, with the placement of the history; its losses must
    equal the same run's without injection bit for bit (if they do not, the
    uninterrupted run is taken again: where it too moves, the resumed
    losses are held to ``TOL_RESUME`` and the phase says so; else the resume
    is at fault).  The state restored from ``LATEST`` must equal the run's
    last bit for bit.  A second process then resumes from ``LATEST`` with
    one more step (``RESUME``), whose loss must equal that of this run
    continued by one step.  Returns the launches of the injected run and the
    phase's numbers."""
    import dataclasses
    import os
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint import checkpointer
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import to_device
    from repro_torch.launch import train
    from repro_torch.models import lm
    args = train.parse_args(CKPT)
    cfg = get_arch(args.arch)
    cfg = dataclasses.replace(cfg.reduced() if args.reduced else cfg,
                              n_layers=args.layers)
    replicated, experts = lm.param_counts(cfg)
    step_bytes = 14 * (replicated + experts)     # bf16 + 3 x f32 a parameter
    saves = args.steps // int(CKPT_FLAGS[1]) + 1
    root = tempfile.mkdtemp(prefix="repro-ckpt-")
    try:
        free = shutil.disk_usage(root).free
        if free < saves * step_bytes:
            raise AssertionError(
                f"checkpoint phase: {saves} committed steps of {step_bytes} B "
                f"to write, {free} B free under {root}")
        torch.cuda.empty_cache()
        plain = train.run(args, device)["losses"]
        ckpt = os.path.join(root, "ckpt")
        out, launches = train_phase(CKPT + ["--ckpt-dir", ckpt] + CKPT_FLAGS,
                                    device, keep_state=True, restarts=1)
        run = out["run"]
        if out["first_step"] != 0 or len(out["relayouts"]) != args.steps // 2:
            raise AssertionError(f"checkpoint phase: {run.restarts} restarts, "
                                 f"first step {out['first_step']}, "
                                 f"{len(out['relayouts'])} relayouts")
        res = {"launches": launches, "plain": plain, "losses": out["losses"],
               "bits": out["losses"] == plain, "repeatable": None}
        if not res["bits"]:
            again = train.run(args, device)["losses"]
            res["repeatable"] = again == plain
            worst = max(abs(a - b) / abs(b)
                        for a, b in zip(out["losses"], plain))
            if res["repeatable"] or worst > TOL_RESUME:
                raise AssertionError(
                    f"checkpoint phase: resumed losses {out['losses']}, "
                    f"uninterrupted {plain} (again: {again}): the resume is "
                    f"at fault")
            res["resume_rel"] = worst
        t0 = time.perf_counter()
        got, step = checkpointer.restore(ckpt, out["state"])
        res["restore_s"] = time.perf_counter() - t0
        if step != args.steps or not _leaves_equal(got, out["state"]):
            raise AssertionError(f"checkpoint phase: LATEST ({step}) does "
                                 "not restore the run's last state bit for "
                                 "bit")
        del got
        batch = to_device(run_batch(cfg, args, args.steps), device)
        params, opt = out["state"]
        cont = float(out["train_step"](params, opt, batch,
                                       out["traffic"])[2]["loss"])
        res.update(saves=[(p.gather_ms, p.write_s, p.bytes)
                          for p in run.saves],
                   restart_restore_s=run.restore_s,
                   placement_steps=[s for s, _ in train.load_placement_history(
                       ckpt, cfg.moe.n_experts)],
                   continued=cont)
        del out, params, opt, batch
        torch.cuda.empty_cache()
        argv = [a if a != str(args.steps) else str(args.steps + 1)
                for a in CKPT] + ["--ckpt-dir", ckpt, "--ckpt-every", "2"]
        proc = subprocess.run([sys.executable, "-c", RESUME, str(SRC),
                               json.dumps(argv), device], capture_output=True,
                              text=True, timeout=600, cwd=ROOT)
        line = [x for x in proc.stdout.splitlines()
                if x.startswith("RESUMED ")]
        if proc.returncode or not line:
            raise AssertionError(f"checkpoint phase: the resuming process "
                                 f"exited {proc.returncode}:\n"
                                 f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
        second = json.loads(line[0][len("RESUMED "):])
        res["second"] = second
        if (second["first_step"] != args.steps or second["losses"] != [cont]
                or second["restarts"]):
            raise AssertionError(f"checkpoint phase: the second process "
                                 f"resumed at {second['first_step']} with "
                                 f"losses {second['losses']} after "
                                 f"{second['restarts']} restarts; the run "
                                 f"continued: {cont}")
        res["on_disk"] = sum(os.path.getsize(os.path.join(d, f))
                             for d, _, fs in os.walk(ckpt) for f in fs)
        res["step_bytes"] = step_bytes
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return res


# the reduced card-vs-CPU relayout checks: (arch, engine) of each family
RELAYOUT_REDUCED = (("qwen3-moe-30b-a3b", "fused_flat"),
                    ("moe-tx-stream", "fused_pipe"),
                    ("moe-ffn-stream", "fused_pipe"))


def reduced_relayout_check(arch: str, engine: str, device="cuda") -> dict:
    """Four f32 train steps of the reduced ``arch`` through ``engine``
    (``engine_kwargs``) with ``train.apply_relayout`` after the second (the
    lane EMAs restarted cold and the step rebuilt, as ``train.run`` does),
    on the card (kernels) and on the CPU (plain versions), from the same
    params and batches: the same tables; every loss within ``TOL_TRAIN``;
    the grads of the first step after the relayout within ``TOL_TRAIN`` of
    max(1, max |g|); the migrated params and master within 2 * lr + 1e-5 a
    step taken (AdamW moves an element by about lr; one whose gradient is
    float32 noise may move the other way), mu and nu within ``TOL_TRAIN``
    of max(1, |x|); the kernels of the family's path launched on the card."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import ZipfNgramLM, to_device
    from repro_torch.launch import steps, train
    from repro_torch.models import lm, zoo
    from repro_torch.optim import adamw
    import numpy as np
    cfg = get_arch(arch).reduced()
    f32 = torch.float32
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    base = lm.init_params(cfg, lm.make_context(cfg, "cpu", compute_dtype=f32),
                          torch.Generator().manual_seed(0), dtype=f32)
    source = ZipfNgramLM(cfg.vocab, 32, 4, seed=0)
    quiet = lambda *a, **k: None
    moe = lambda tree: {n: tree["layers"]["moe"][n].detach().cpu().clone()
                        for n in ("w1", "w3", "w2")}
    res = {}
    for dev in ("cpu", device):
        ctx = lm.make_context(cfg, dev, compute_dtype=f32,
                              **engine_kwargs(engine, cfg))
        model = zoo.build(cfg, ctx)
        params = adamw.tree_map(lambda t: t.to(dev, copy=True), base)
        opt = steps.init_state(model, params)
        traffic = train.init_traffic(cfg, ctx, 1)
        step = steps.make_train_step(model, opt_cfg)
        losses = []
        wrappers = zero_counters()
        for i in range(4):
            batch = to_device(source.batch_at(i), dev)
            if i == 2:
                _, _, grads = steps.value_and_grad(model)(params, batch,
                                                          traffic)
                grads = [g.cpu() for g in grads]
            params, opt, m = step(params, opt, batch, traffic)
            traffic = m["traffic"]
            losses.append(float(m["loss"]))
            if i == 1:
                params, opt, ctx, stats = train.apply_relayout(
                    params, opt, traffic, ctx, log=quiet)
                traffic = train.cold_lane_stats(traffic)
                model = zoo.build(cfg, ctx)
                step = steps.make_train_step(model, opt_cfg)
                migrated = {k: moe(t) for k, t in (
                    ("params", params), ("mu", opt.mu), ("nu", opt.nu),
                    ("master", opt.master))}
                table = ctx.placement.lane_expert.copy()
        res[dev] = dict(losses=losses, grads=grads, migrated=migrated,
                        table=table, stats=stats,
                        launches={k: w.launches for k, w in wrappers.items()})
    cpu, card = res["cpu"], res[device]
    rel = lambda a, b: max_err(a.float(), b.float()) / max(
        1.0, b.float().abs().max().item())
    lr = adamw.schedule(opt_cfg, 1)
    err = {"loss": max(abs(a - b) for a, b in zip(cpu["losses"],
                                                  card["losses"])),
           "grads": max(rel(a, b) for a, b in zip(card["grads"],
                                                   cpu["grads"]))}
    for kind in ("params", "mu", "nu", "master"):
        for n, t in cpu["migrated"][kind].items():
            got = card["migrated"][kind][n]
            e = max_err(got, t) if kind in ("params", "master") else rel(got, t)
            err[kind] = max(err.get(kind, 0.0), e)
    p_tol = 2 * (2 * lr) + 1e-5
    required, _ = family_kernels(cfg, train=True)
    never = [k for k in required if card["launches"][k] == 0]
    if not (np.array_equal(cpu["table"], card["table"])
            and err["loss"] <= TOL_TRAIN and err["grads"] <= TOL_TRAIN
            and err["params"] <= p_tol and err["master"] <= p_tol
            and err["mu"] <= TOL_TRAIN and err["nu"] <= TOL_TRAIN
            and not never):
        raise AssertionError(
            f"reduced {arch} {engine} relayout, card vs CPU: tables "
            f"{cpu['table'].tolist()} / {card['table'].tolist()}; {err} (tol "
            f"{TOL_TRAIN}, params and master {p_tol}); never launched {never}")
    return dict(err, p_tol=p_tol, table=card["table"].tolist(),
                stats=card["stats"], launches=card["launches"])


# the replicated tables on one card: two gloo ranks sharing it, the reduced
# qwen3-moe in f32, its 8 experts on 2 lanes x 5 slots (the solver's table of
# a skewed load: replicas of the hottest experts), capacity factor 8
REPLICATED_SLOTS = 5
REPLICATED_LOADS = (9.0, 5.0, 1.0, 1.0, 2.0, 1.0, 1.0, 1.0)


def _replicated_table():
    import numpy as np
    from repro_torch.core import relayout
    return relayout.solve_placement(np.array(REPLICATED_LOADS), ep=EP2,
                                    node_size=1,
                                    slots_per_lane=REPLICATED_SLOTS)


def _replicated_run(rank, out_dir, device) -> None:
    """One rank of the replicated-table check, in the EP-2 spawn
    (``_ep2_rank``): a train step of the reduced qwen3-moe (f32,
    fused_flat) under the replicated table from the canonical seed-0
    weights laid out by it, then a relayout from it (the replicas have
    drifted: each took its own share of the tokens); one MoE layer under
    the table with the host's waits recorded."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.core import relayout, traffic
    from repro_torch.data.pipeline import ZipfNgramLM, to_device
    from repro_torch.launch import steps, train
    from repro_torch.models import lm, zoo
    from repro_torch.optim import adamw
    cfg = get_arch("qwen3-moe-30b-a3b").reduced()
    f32 = torch.float32
    table = _replicated_table()
    slots = relayout.slot_table(table)
    base = lm.init_params(cfg, lm.make_context(cfg, "cpu",
                                               compute_dtype=f32),
                          torch.Generator().manual_seed(0), dtype=f32)
    for n in ("w1", "w3", "w2"):       # canonical (L, 1, 8, ...) -> table
        w = base["layers"]["moe"][n]
        base["layers"]["moe"][n] = w[:, 0, slots].reshape(
            w.shape[0], EP2, REPLICATED_SLOTS, *w.shape[3:])
    # the replicated attention: the table's relayout in that layout
    ctx = lm.make_context(cfg, device, ep_group=dist.group.WORLD,
                          capacity_factor=EP2_CAPACITY,
                          compute_dtype=f32, engine="fused_flat",
                          explicit_tp=False)
    ctx = dataclasses.replace(ctx, placement=table)
    model = zoo.build(cfg, ctx)
    params = lm.shard_params(adamw.tree_map(lambda t: t.to(device),
                                            base), ctx)
    batch = to_device(ZipfNgramLM(cfg.vocab, 32, 4, seed=0).batch_at(0),
                      device)
    cold = traffic.init_traffic_state(cfg.moe.n_experts, EP2,
                                      n_layers=cfg.n_layers, device=device)
    wrappers = zero_counters()
    loss, _, grads = steps.value_and_grad(model)(params, batch, cold)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    params, opt, m = steps.make_train_step(model, opt_cfg)(
        params, steps.init_state(model, params), batch, cold)
    launches = {k: w.launches for k, w in wrappers.items()}
    moe = lambda tree: {n: tree["layers"]["moe"][n].detach().cpu().clone()
                        for n in ("w1", "w3", "w2")}
    trees = lambda: {"params": moe(params), "mu": moe(opt.mu),
                     "nu": moe(opt.nu), "master": moe(opt.master)}
    before = trees()
    hot = m["traffic"]._replace(expert_ema=m["traffic"].expert_ema.flip(-1))
    params, opt, new_ctx, stats = train.apply_relayout(
        params, opt, hot, ctx, log=lambda *a, **k: None)
    layer = {k: v[0] for k, v in params["layers"]["moe"].items()}
    x = torch.randn((4, 32, cfg.d_model), device=device,
                    generator=torch.Generator(device=device).manual_seed(3))
    on_card = torch.device(device).type == "cuda"
    with torch.no_grad():
        lm._moe_seq_sharded(x, layer, new_ctx)     # the first use, built
        with (host_syncs() if on_card
              else contextlib.nullcontext([])) as syncs:
            lm._moe_seq_sharded(x, layer, new_ctx)
    torch.save({"loss": float(loss),
                "grads": dict(zip(adamw.paths(params),
                                  (g.cpu() for g in grads))),
                "launches": launches, "before": before, "after": trees(),
                "table": new_ctx.placement.lane_expert.copy(),
                "stats": stats, "syncs": syncs},
               f"{out_dir}/replicated-rank{rank}.pt")


def replicated_card_check(out_dir, device="cuda") -> list[str]:
    """The replicated table (``_replicated_table``) on two gloo ranks sharing
    the card (``_replicated_run``, in the EP-2 spawn, which saved its
    results to ``out_dir``) against the one-rank card step under the
    canonical weights: each rank's loss and replicated leaves' gradients
    within ``TOL_TRAIN`` of max(1, |x|), and the expert gradients of both
    ranks' slots, scattered onto the canonical experts, within ``TOL_TRAIN``
    of the one-rank step's; then the relayout from the drifted replicas held
    to the CPU's unsharded ``relayout.migrate_lane_major`` of the ranks'
    gathered leaves (the replica mean, ``TOL_MEAN`` relative): params, mu,
    nu and master.  Every kernel of the train path launched on each rank;
    no host wait in a layer under the table from the port's code, on the
    calling thread (gloo copies CUDA tensors through the host on its own
    threads, which ``host_syncs`` does not see)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import relayout
    from repro_torch.launch import steps
    from repro_torch.data.pipeline import ZipfNgramLM, to_device
    from repro_torch.models import lm, zoo
    from repro_torch.optim import adamw
    cfg = get_arch("qwen3-moe-30b-a3b").reduced()
    f32 = torch.float32
    ctx = lm.make_context(cfg, device, capacity_factor=EP2_CAPACITY,
                          compute_dtype=f32, engine="fused_flat")
    base = lm.init_params(cfg, lm.make_context(cfg, "cpu", compute_dtype=f32),
                          torch.Generator().manual_seed(0), dtype=f32)
    params = adamw.tree_map(lambda t: t.to(device), base)
    batch = to_device(ZipfNgramLM(cfg.vocab, 32, 4, seed=0).batch_at(0),
                      device)
    loss, _, grads = steps.value_and_grad(zoo.build(cfg, ctx))(params, batch)
    want = dict(zip(adamw.paths(params), (g.cpu() for g in grads)))
    got = [torch.load(Path(out_dir) / f"replicated-rank{r}.pt",
                      weights_only=False) for r in range(EP2)]
    table = _replicated_table()
    slots = relayout.slot_table(table)
    rel = lambda a, b: max_err(a, b) / max(1.0, b.abs().max().item())
    err = {"loss": 0.0, "grads": 0.0, "expert_grads": 0.0, "mean": 0.0}
    required, _ = family_kernels(cfg, train=True)
    for r, g in enumerate(got):
        err["loss"] = max(err["loss"], abs(g["loss"] - float(loss)))
        for k, w in want.items():
            if not lm.lane_sharded(k):     # embed and lm_head: the rank's
                err["grads"] = max(err["grads"], rel(
                    g["grads"][k], rank_cut(k, w, EP2, r, False)))
        never = [k for k in required if g["launches"][k] == 0]
        if never:
            raise AssertionError(f"replicated table rank {r} never launched "
                                 f"{never}: {g['launches']}")
        if not np.array_equal(g["table"], got[0]["table"]):
            raise AssertionError("the ranks took different tables")
    for k in (k for k in want if lm.lane_sharded(k)):
        lanes = torch.cat([g["grads"][k] for g in got], 1)   # (L, 2, 5, ...)
        flat = lanes.reshape(lanes.shape[0], -1, *lanes.shape[3:])
        canon = torch.zeros_like(want[k][:, 0]).index_add_(1, slots, flat)
        err["expert_grads"] = max(err["expert_grads"],
                                  rel(canon, want[k][:, 0]))
    new = relayout.TablePlacement(got[0]["table"], node_size=1,
                                  n_experts=cfg.moe.n_experts)
    drifted = False
    for kind in ("params", "mu", "nu", "master"):
        for n in ("w1", "w3", "w2"):
            whole = torch.cat([g["before"][kind][n] for g in got], 1)
            flat = whole.reshape(whole.shape[0], -1, *whole.shape[3:])
            rep = int(np.argmax(table.n_replicas))
            a, b = np.flatnonzero(relayout.placement_table(table).reshape(-1)
                                  == rep)[:2]
            drifted |= not torch.equal(flat[:, a], flat[:, b])
            mean = relayout.migrate_lane_major(whole, table, new, lane_axis=1)
            mine = torch.cat([g["after"][kind][n] for g in got], 1)
            err["mean"] = max(err["mean"], max_err(mine, mean) / max(
                1e-30, mean.abs().max().item()))
    own = [s for g in got for s in g["syncs"] if "repro_torch" in s]
    if not (err["loss"] <= TOL_TRAIN and err["grads"] <= TOL_TRAIN
            and err["expert_grads"] <= TOL_TRAIN and err["mean"] <= TOL_MEAN
            and drifted and not own):
        raise AssertionError(
            f"replicated table on two ranks: {err} (tol {TOL_TRAIN}, mean "
            f"{TOL_MEAN}); replicas drifted before the relayout {drifted}; "
            f"host waits in the port's code {own[:3]}")
    other = sorted({s for g in got for s in g["syncs"]})
    return [f"table {relayout.placement_table(table).tolist()} (replicas "
            f"{table.n_replicas.tolist()}): loss {err['loss']:.3g}, "
            f"replicated grads {err['grads']:.3g}, expert grads scattered "
            f"onto the canonical experts {err['expert_grads']:.3g} (tol "
            f"{TOL_TRAIN}) against one rank under the canonical weights; "
            f"launches per rank {json.dumps([g['launches'] for g in got])}",
            f"relayout from the drifted replicas onto "
            f"{new.lane_expert.tolist()}: params, mu, nu and master within "
            f"{err['mean']:.3g} of the CPU's replica mean (tol {TOL_MEAN}); "
            f"{got[0]['stats']['rows_moved']}/{got[0]['stats']['slots']} "
            f"blocks moved across lanes",
            f"host waits in one MoE layer under the table, on the calling "
            f"thread: 0 from the port's code, {len(other)} elsewhere "
            f"{other[:2]} (gloo stages CUDA tensors through the host on its "
            f"own threads, outside this count)"]


def hier_swiglu_row(inp, timer=time_ms) -> dict:
    """fused_swiglu on fused_hier's expansion buffer at ``inp``'s shape
    (EP = 1), with the expansion's counts: held and timed (``swiglu_row``)."""
    from repro_torch.core import dcomm
    from repro_torch.core.routing import ExpertPlacement
    w = (inp["w1"], inp["w3"], inp["w2"])
    res = dcomm.hier_dispatch(inp["x"], inp["A"], inp["route_gates"],
                              ExpertPlacement(w[0].shape[0], 1, 1),
                              dcomm.DcommConfig(engine="fused_hier"))
    row = swiglu_row("fused_swiglu", res.expert_rows, *w, res.counts, timer)[0]
    return dict(row, shape=f"fused_hier expansion: {row['shape']}")


def admission_rows(timer=time_ms) -> list[dict]:
    """The serve kernels at the continuous qwen3-moe path's admission
    shapes: one request of T tokens (``ADMISSION_T``) through fused_hier's
    gathers, scatter-adds and fused_swiglu, and its flash forward (B 1 x
    S T, hd 128), each held against its plain version and timed."""
    moe = {k: v for k, v in PATHS["qwen3-moe-30b-a3b"][1].items() if k != "t"}
    rows = []
    for t in ADMISSION_T:
        rows.append(flash_row(*attention_inputs("cuda", sq=t, sk=t,
                                                **ADMISSION_ATTN),
                              window=None, timer=timer))
        inp = main_path_inputs("cuda", t=t, **moe)
        rows += hier_kernel_rows(inp, timer)
        rows.append(hier_swiglu_row(inp, timer))
    return rows


def continuous_engine(spec: dict, device="cuda"):
    """A ``ContinuousServingEngine`` of ``spec``'s full-width model (depth
    cut to ``layers``) with traffic tracked, its random parameters (seed 0)
    and its requests: prompt lengths cycling through ``lens``, tokens and
    ``max_new`` (in ``MAX_NEW``) drawn from seed 0."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import lm, zoo
    from repro_torch.serving.engine import ContinuousServingEngine
    cfg = get_arch(spec["arch"])
    if spec["layers"]:
        cfg = dataclasses.replace(cfg, n_layers=spec["layers"])
    ctx = lm.make_context(cfg, device, engine=spec["engine"], node_size=1)
    bundle = zoo.build(cfg, ctx)
    params = bundle.init(torch.Generator(device=ctx.device).manual_seed(0))
    rng = np.random.default_rng(0)
    n, lens = spec["requests"], spec["lens"]
    max_new = rng.integers(MAX_NEW[0], MAX_NEW[1] + 1, n)
    prompts = [rng.integers(0, cfg.vocab, lens[i % len(lens)]) for i in range(n)]
    eng = ContinuousServingEngine(bundle, max_batch=spec["max_batch"],
                                  max_len=spec["max_len"], track_traffic=True)
    return eng, params, list(zip(prompts, (int(m) for m in max_new)))


def host_ms(*fns, rounds: int = 8) -> list[float]:
    """The median host time (ms) of each of ``fns`` (each ends in a host
    read) over ``rounds`` rounds, after a warm-up call of each; the rounds
    take the functions in turns, forward then backward, so that a drift of
    the shared host falls on all of them alike."""
    for fn in fns:
        fn()
    walls = [[] for _ in fns]
    for r in range(rounds):
        order = range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))
        for i in order:
            t0 = time.perf_counter()
            fns[i]()
            walls[i].append((time.perf_counter() - t0) * 1e3)
    return [statistics.median(w) for w in walls]


# the host's pause between a trace's start and the call it traces: the
# profiler drops a device record whose start it reads before the trace's
# own, and the card's clock reads up to 5.4 ms early against the host's
# (tools/profile_loss.py on an H100, below)
TRACE_PAUSE_S = 0.05


def profile_once(fn) -> dict | None:
    """One call of ``fn`` under torch.profiler, the device synchronized
    before the trace stops: ``device_summary`` of its trace.  ``fn`` starts
    ``TRACE_PAUSE_S`` after the trace: traced at once, mixtral-8x22b's
    train forward and backward lost its first device records (up to 55 of
    504, the flash forward the 56th) in 22 of 1,528 traces over a
    450 s process, and none of 1,528 with the pause (``python3
    tools/profile_loss.py --reps 20 --seconds 450``, NVIDIA H100 80GB HBM3,
    700 W)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_PAUSE_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return device_summary(prof, wall_ms)


def continuous_phase(label: str, spec: dict) -> tuple[dict, dict]:
    """A continuous serving path at full width: ``warmup()``, then every
    request queued and ``run()``, with the launch counters zeroed just
    before the run and read just after.  Fails if the run built a callable
    (``compile_count`` moved after warmup), if a serve kernel never
    launched, if a request did not get its ``max_new`` in-vocabulary tokens
    (no eos), or if the host waited on the card other than once per
    admission and once per decode step.  Then profiles one admission
    prefill per prompt length and one pool decode step.  Returns the
    launch counts and the times."""
    import numpy as np
    import torch
    from repro_torch.models import lm
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng, params, requests = continuous_engine(spec)
    cfg, ctx = eng.bundle.cfg, eng.bundle.ctx
    warm_s = eng.warmup(params)
    built = eng.compile_count
    for prompt, max_new in requests:
        eng.submit(prompt, max_new=max_new)
    wrappers = zero_counters()
    with host_syncs() as syncs:
        t0 = time.perf_counter()
        done = eng.run(params)
        run_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    never = [k for k in SERVE_KERNELS if launches[k] == 0]
    if eng.compile_count != built or never:
        raise AssertionError(f"{label}: compile_count {built} -> "
                             f"{eng.compile_count} over the run, or kernels "
                             f"never launched {never}: {launches}")
    if (len(done) != len(requests)
            or any(len(r.output) != r.max_new for r in done)
            or not all(0 <= t < cfg.vocab for r in done for t in r.output)):
        raise AssertionError(f"{label}: a request lacks its tokens")
    reads = len(requests) + eng.decode_steps
    if len(syncs) != reads:
        raise AssertionError(f"{label}: the host waited {len(syncs)} times, "
                             f"expected one per admission and decode step "
                             f"({reads}): {syncs[:6]}")
    st = eng.stats()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"serve {label}: {cfg.name} full width, {cfg.n_layers} layers, "
          f"{spec['engine']}, pool {spec['max_batch']}, max_len "
          f"{spec['max_len']} (buckets {list(eng.buckets)}), {len(requests)} "
          f"requests of {list(spec['lens'])} tokens, max_new {MAX_NEW[0]}-"
          f"{MAX_NEW[1]} (seed 0): {eng.compile_count} prepared callables "
          f"built in {eng.compile_s:.2f} s (warmup {warm_s:.2f} s), flat over "
          f"the run; run {run_s:.3f} s, {eng.decode_steps} decode steps, "
          f"{len(syncs)} host reads; ttft p50 {st['p50_ttft_s'] * 1e3:.3f} "
          f"p95 {st['p95_ttft_s'] * 1e3:.3f} p99 "
          f"{st['p99_ttft_s'] * 1e3:.3f} ms (queued before the run); decode "
          f"{st['decode_tok_s']:.1f} tok/s; mean occupancy "
          f"{st['mean_slot_occupancy']:.3f}; lane imbalance mean "
          f"{st['mean_lane_imbalance']:.3f} max {st['max_lane_imbalance']:.3f}; "
          f"top-expert share {st['mean_top_expert_share']:.4f}; peak memory "
          f"{peak:.2f} GiB")
    print(f"launches on the {label} path: {json.dumps(launches)}")
    print(f"sample tokens: {done[0].output}")
    times = {"ttft_p50_ms": st["p50_ttft_s"] * 1e3,
             "ttft_p99_ms": st["p99_ttft_s"] * 1e3,
             "decode_tok_s": st["decode_tok_s"],
             "mean_occupancy": st["mean_slot_occupancy"]}

    with torch.inference_mode():
        for n in spec["lens"]:
            exe = eng.get_prefill(params, 1, eng.bucket_of(n))
            toks = torch.from_numpy(requests[spec["lens"].index(n)][0][None]
                                    ).to(ctx.device)
            mask = torch.ones(toks.shape, dtype=torch.bool, device=ctx.device)
            scratch = eng._fresh_traffic()
            tracked = lambda: exe(params, toks, scratch, mask)[0].argmax(
                -1).cpu()
            # what the traffic statistics cost an admission: the same
            # prefill without them, host clock, in turns with it
            wall, untracked = host_ms(tracked, lambda: eng.bundle.prefill(
                params, {"tokens": toks}, eng.max_len)[0].argmax(-1).cpu())
            p = profile_once(tracked)
            print_profile(f"{label} admission prefill S {n}", p, wall)
            print(f"  the same prefill without traffic statistics: "
                  f"{untracked:.3f} ms host clock (with: {wall:.3f}; medians "
                  f"of 8 in turns)")
            check_profile(f"{label} prefill", p, flash=True)
            times[f"prefill_{n}_ms"] = wall
            times[f"prefill_{n}_untracked_ms"] = untracked
            times[f"prefill_{n}_busy_share"] = (None if p is None
                                                else p["busy_ms"] / wall)
        state = lm.init_decode_state(cfg, eng.max_batch, eng.max_len,
                                     ctx.compute_dtype, ctx, per_slot=True)
        dec = eng.get_decode(params, state, eng.max_batch)
        tok = torch.zeros(eng.max_batch, dtype=torch.int64, device=ctx.device)
        step = lambda: dec(params, state, tok)[0].argmax(-1).cpu()
        wall = host_ms(step)[0]
        p = profile_once(step)
        print_profile(f"{label} pool decode step", p, wall)
        check_profile(f"{label} decode", p, flash=False)
        times["decode_step_ms"] = wall
        times["decode_busy_share"] = None if p is None else p["busy_ms"] / wall
    del eng, state
    torch.cuda.empty_cache()
    return launches, times


def continuous_check(arch: str, engine: str, device="cuda",
                     lanes: int = 1) -> dict:
    """The continuous engine over the reduced model in float32: 6 requests
    on bucket boundaries (16 / 32) through a pool of 4 with ``max_new``
    4-6 (seed 0), traffic tracked (a family with MoE), on the card
    (kernels) and on the CPU
    (plain versions).  With ``lanes`` > 1 (``engine_kwargs``) an admission
    prefills a chunk of that many rows, one a lane, at ``lane_capacity``:
    a chunk's left-pad positions share its lanes' capacity, so with a drop
    a request's stream would depend on its chunk, and the batch-1 oracle
    (each request alone in its lane) holds only where none is dropped.  Fails unless the card gives the CPU's
    token streams and the streams of its own batch-1 waved oracle, and the
    CPU's traffic state within ``TOL_TRAFFIC``.  Returns the streams'
    count, the traffic error and the admission chunk."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import lm, zoo
    from repro_torch.serving.engine import (ContinuousServingEngine,
                                            ServingEngine)
    cfg = get_arch(arch).reduced()
    f32 = torch.float32
    bundles = {dev: zoo.build(cfg, lm.make_context(
        cfg, dev, node_size=1, compute_dtype=f32,
        **engine_kwargs(engine, cfg, lanes), **lane_capacity(lanes)))
        for dev in ("cpu", device)}
    params = bundles["cpu"].init(torch.Generator().manual_seed(0), f32)
    move = lambda t, dev: ({k: move(v, dev) for k, v in t.items()}
                           if isinstance(t, dict) else t.to(dev))
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab, (16, 32)[i % 2]),
             int(rng.integers(4, 7))) for i in range(6)]
    kw = dict(max_len=40, buckets=(16, 32))

    def run(dev):
        eng = ContinuousServingEngine(bundles[dev], max_batch=4,
                                      track_traffic=cfg.moe is not None, **kw)
        if eng.admit_chunk != lanes:
            raise AssertionError(f"continuous {arch} {engine}: admission "
                                 f"chunk {eng.admit_chunk}, lanes {lanes}")
        p = move(params, dev)
        eng.warmup(p)
        for prompt, n in reqs:
            eng.submit(prompt, max_new=n)
        eng.run(p)
        return ([q.output for q in sorted(eng.finished, key=lambda q: q.rid)],
                [leaf.cpu() for leaf in eng.traffic or ()], p)

    card, card_tr, p = run(device)
    cpu, cpu_tr, _ = run("cpu")
    oracle = []
    for prompt, n in reqs:
        eng = ServingEngine(bundles[device], max_batch=1, **kw)
        eng.submit(prompt, max_new=n)
        oracle.append(eng.run_wave(p)[0].output)
    err = max((max_err(a, b) / max(1.0, b.float().abs().max().item())
               for a, b in zip(card_tr, cpu_tr)), default=0.0)
    if card != cpu or card != oracle or not err <= TOL_TRAFFIC:
        raise AssertionError(f"continuous {arch} {engine} on the card: "
                             f"streams {card}, CPU {cpu}, batch-1 oracle "
                             f"{oracle}; traffic error {err} (tol "
                             f"{TOL_TRAFFIC})")
    return dict(requests=len(card), tokens=sum(map(len, card)),
                traffic_err=err, admit_chunk=lanes)


def print_row(r: dict) -> None:
    lse = (f", worst row {r['worst_row_share']:.3f} of its row's tolerance, "
           f"lse {r['max_abs_err_lse']:.4g} (tol {TOL_LSE})"
           if "max_abs_err_lse" in r else "")
    split = (f"  loads only {r['loads_only_ms']:.4f} ms, products only "
             f"{r['products_only_ms']:.4f} ms" if "loads_only_ms" in r else "")
    causal = (f"  SDPA is_causal {r['library_causal_ms']:.4f} ms"
              f"{spread(r['library_causal_ms'])}"
              if "library_causal_ms" in r else "")
    print(f"kernel {r['name']:<20} {r['shape']}: max_abs_err "
          f"{r['max_abs_err']:.4g} (tol {r['tol']:.4g}){lse}  {r['ms']:.4f} ms"
          f"{spread(r['ms'])}  plain {r['plain_ms']:.4f} ms  bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']})  library "
          f"{r['library_ms']:.4f} ms{spread(r['library_ms'])} "
          f"[{r['library']}]{causal}{split}")


def serve_and_profile(label: str, argv, required=SERVE_KERNELS,
                      absent=(), implied=None) -> tuple[dict, dict]:
    """One serving path at full width: the serve phase with its launch
    counts, each held to ``implied`` (default ``SERVE_LAUNCHES``' entry),
    then the profile phase.  Returns the launch counts and the times (TTFT,
    decode, and each profiled step's device busy share)."""
    import torch
    from repro_torch.models import lm
    torch.cuda.reset_peak_memory_stats()
    out, launches = serve_phase(argv, required=required, absent=absent)
    cfg = out["cfg"]
    implied = SERVE_LAUNCHES.get(label, {}) if implied is None else implied
    if any(launches[k] != n for k, n in implied.items()):
        raise AssertionError(f"{label}: launches {launches}, its code implies "
                             f"{implied}")
    # moe_tx's streamed prefill runs its attention once a lane
    from repro_torch.launch import serve
    args = serve.parse_args(argv)
    lanes = (args.moe_interleave if cfg.family == "moe_tx"
             and args.engine == "fused_pipe" else 1)
    per_prefill = prefill_flash(cfg)
    if (lm.has_attention(cfg)
            and launches["flash_attention"] != 2 * per_prefill * lanes):
        raise AssertionError(f"{label}: flash launched "
                             f"{launches['flash_attention']} times, expected "
                             f"2 prefills x {per_prefill} attention layers x "
                             f"{lanes} lanes")
    enc = (f" + {cfg.encoder_layers} encoder" if cfg.family == "encdec"
           else "")
    print(f"serve {label}: {cfg.name} full width, {cfg.n_layers}{enc} layers, "
          f"{' '.join(argv[2:])}: ttft "
          f"{out['ttft_s'] * 1e3:.3f} ms  decode "
          f"{out['decode_s_per_tok'] * 1e3:.3f} ms/token  warmup "
          f"{out['warmup_s']:.2f} s  peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"launches on the {label} path: {json.dumps(launches)}"
          + (f"; its code implies {json.dumps(implied)}" if implied else "")
          + f"; fused_swiglu by form {json.dumps(out['swiglu_forms'])}")
    print(f"sample tokens: {out['tokens'][0].tolist()}")
    unprofiled = {"prefill": out["ttft_s"] * 1e3,
                  "decode": out["decode_s_per_tok"] * 1e3}
    times = {"ttft_ms": unprofiled["prefill"],
             "decode_ms_per_token": unprofiled["decode"]}
    del out
    torch.cuda.empty_cache()

    for step, p in profile_phase(argv).items():
        print_profile(f"{label} {step}", p, unprofiled[step])
        if p is not None:
            print("  device ms by kind: " + ", ".join(
                f"{k} {ms:.4f}"
                for k, ms in device_kinds(p["by_kernel"]).items()))
        check_profile(f"{label} {step}", p,
                      flash=step == "prefill" and lm.has_attention(cfg))
        times[f"{step}_busy_share"] = (None if p is None
                                       else p["busy_ms"] / unprofiled[step])
    torch.cuda.empty_cache()
    return launches, times


def prefill_flash(cfg) -> int:
    """Flash forwards a prefill of ``cfg`` runs: one a layer, and for the
    encoder-decoder one an encoder layer (its prefill decodes the first
    token by the plain decode attention)."""
    return cfg.encoder_layers if cfg.family == "encdec" else cfg.n_layers


def short_name(name: str, width: int = 90) -> str:
    """A device item's name without its namespaces and return type, cut to
    ``width``: enough to tell PyTorch's elementwise functors apart."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::", "c10::"):
        name = name.replace(noise, "")
    return name[:width]


# kernels no full-width step may run: the combine's retired zero fill,
# atomics and cast, the SwiGLU's FMA form, and the flash tensor-core form
# (the bf16 shapes the Hopper form refuses: hd 16 and 32, which no
# full-width config has; every group size up to 64 takes the Hopper form)
OFF_PATH = ("scatter_add_rows", "cast_from_f32", "swiglu_tile", "flash_fwd_tc")


def check_profile(label: str, p: dict | None, flash: bool) -> None:
    """Fails if a profiled step ran a kernel of ``OFF_PATH``, or
    (``flash``) ran no ``flash_fwd_wgmma``."""
    if p is None:
        return
    names = [name for name, _ in p["by_kernel"]]
    off = [n for n in names if any(x in n for x in OFF_PATH)]
    if off:
        raise AssertionError(f"profile {label} shows kernels off the "
                             f"full-width path {off}")
    if flash and not any("flash_fwd_wgmma" in n for n in names):
        raise AssertionError(f"profile {label} shows no flash_fwd_wgmma")


def print_profile(label: str, p: dict | None, unprofiled_ms: float) -> None:
    if p is None:
        print(f"profile {label}: the trace shows no device activity: device "
              "busy time not measured")
        return
    top = ", ".join(f"{short_name(name)} {ms:.4f} ms"
                    for name, ms in p["by_kernel"][:8])
    print(f"profile {label}: device busy {p['busy_ms']:.4f} ms over "
          f"{p['activities']} device activities; host wall under the "
          f"profiler {p['wall_ms']:.3f} ms; busy share of the unprofiled "
          f"{unprofiled_ms:.3f} ms: {p['busy_ms'] / unprofiled_ms:.3f}"
          f"\n  top device time: {top}")


def train_and_profile(label: str, argv, implied=None,
                      record: dict | None = None) -> dict:
    """A training path at full width: the train phase with its launch
    counts, each held to ``implied`` where given, then one profiled step.
    Returns the launch counts; ``record`` gets the losses, the ms per step
    and the profiled step's device busy ms (None where not measured)."""
    import torch
    from repro_torch.launch.train import WARMUP
    from repro_torch.models import lm
    torch.cuda.empty_cache()
    out, launches = train_phase(argv)
    if implied and any(launches[k] != n for k, n in implied.items()):
        raise AssertionError(f"{label}: launches {launches}, its code implies "
                             f"{implied}")
    cfg, n = out["cfg"], len(out["losses"])
    print(f"{label}: {cfg.name} full width, {cfg.n_layers} layers, "
          f"{' '.join(argv[argv.index('--batch'):])}: "
          f"{out['ms_per_step']:.3f} ms/step (median of {n - WARMUP} timed), "
          f"{out['tokens_per_s']:.1f} tokens/s, peak memory "
          f"{out['peak_mem_gib']:.2f} GiB, AdamW state "
          f"{out['opt_state_gib']:.2f} GiB")
    print(f"{label} loss per step: " + " ".join(f"{x:.5f}" for x in out["losses"]))
    print(f"{label} ms per step: " + " ".join(f"{x:.3f}" for x in out["step_ms"]))
    tr = out["traffic"]
    if tr is not None:
        print(f"{label} traffic state after {n} steps: steps "
              f"{tr.steps.tolist()}, expert EMA sum per layer "
              f"{[round(x, 3) for x in tr.expert_ema.sum(-1).tolist()]}, "
              f"top-expert share "
              f"{(tr.expert_ema.max(-1).values / tr.expert_ema.sum(-1)).max().item():.4f}")
    print(f"launches on the {label} path ({n} steps): {json.dumps(launches)}; "
          f"per step: {json.dumps({k: v / n for k, v in launches.items()})}"
          + (f"; its code implies {json.dumps(implied)}" if implied else "")
          + f"; fused_swiglu by form {json.dumps(out['swiglu_forms'])}")
    unprofiled = out["ms_per_step"]
    if record is not None:
        record.update(losses=out["losses"], ms_per_step=unprofiled)
    del out
    torch.cuda.empty_cache()
    for part, p in train_profile(argv).items():
        if record is not None and part == "step":
            record["busy_ms"] = None if p is None else p["busy_ms"]
        print_profile(f"{label} {part}", p, unprofiled)
        check_profile(f"{label} {part}", p, flash=part != "adamw.update"
                      and lm.has_attention(cfg))
        if p is not None:
            print("  device ms by kind: " + ", ".join(
                f"{k} {ms:.4f}" for k, ms in device_kinds(p["by_kernel"]).items())
                + "; of the elementwise: " + ", ".join(
                f"{k} {ms:.4f}" for k, ms in assembly_ms(p["by_kernel"]).items()))
    torch.cuda.empty_cache()
    return launches


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    return smi.splitlines()[0]


def print_auto(auto: dict, fixed: dict) -> None:
    """The --engine auto phase's lines, beside the fixed-engine runs."""
    share = lambda busy, ms: ("not measured" if busy is None
                              else f"{busy:.4f} ms, share {busy / ms:.3f}")
    steps = " ".join(letters(s, "") for s in auto["schedule"])
    print(f"auto: {' '.join(AUTO[AUTO.index('--layers'):])}: per-layer "
          f"engines by step {steps} (F fused_flat, H fused_hier; plans after "
          f"steps {sorted(auto['plans'])}); {auto['ms_per_step']:.3f} ms/step, "
          f"device busy of one step of the final engines "
          f"{share(auto['busy_ms'], auto['ms_per_step'])}; beside fused_flat "
          f"{fixed['train']['ms_per_step']:.3f} ms/step, busy "
          f"{share(fixed['train']['busy_ms'], fixed['train']['ms_per_step'])}"
          f", fused_hier {fixed['train fused_hier']['ms_per_step']:.3f} "
          f"ms/step, busy {share(fixed['train fused_hier']['busy_ms'], fixed['train fused_hier']['ms_per_step'])}")
    print(f"auto loss per step: " + " ".join(f"{x:.5f}" for x in auto["losses"]))
    print(f"auto ms per step (a rebuilt train step from each plan's next "
          f"step on): " + " ".join(f"{x:.3f}" for x in auto["step_ms"]))
    print(f"auto launches {json.dumps(auto['launches'])}, equal to the "
          f"per-layer engines' counts")
    print(f"auto forced {AUTO_MIXED}, {AUTO_FORCED_STEPS} steps: launches "
          f"{json.dumps(auto['forced'])} (implied "
          f"{json.dumps(auto['forced_implied'])}); losses "
          f"{auto['forced_losses']}; first loss vs fused_flat's "
          f"{fixed['train']['losses'][0]}: {auto['forced_rel']:.3g} relative "
          f"(tol {TOL_MIXED})")


def print_checkpoint(ck: dict) -> None:
    """The checkpoint phase's lines, with the card's name and power limit."""
    card = card_line()
    for i, (gather_ms, write_s, nbytes) in enumerate(ck["saves"]):
        print(f"checkpoint save {i + 1} ({card}): host copy {gather_ms:.3f} "
              f"ms, files {write_s:.3f} s on the writing thread, {nbytes} B "
              f"({nbytes / write_s / 1e9:.3f} GB/s)")
    same = ("bit for bit" if ck["bits"] else
            f"within {ck['resume_rel']:.3g} relative (the run itself is not "
            f"repeatable bit for bit)")
    print(f"checkpoint: {' '.join(CKPT[CKPT.index('--layers'):])} "
          f"{' '.join(CKPT_FLAGS)}: one restart, from step 2, placement "
          f"history active from steps {ck['placement_steps']}; losses "
          + " ".join(f"{x:.6f}" for x in ck["losses"])
          + f" equal the uninterrupted run's {same}; restore of the restart "
          f"{', '.join(f'{x:.3f}' for x in ck['restart_restore_s'])} s, of "
          f"LATEST {ck['restore_s']:.3f} s (the run's last state, bit for "
          f"bit); {ck['on_disk']} B on disk ({ck['step_bytes']} B a step "
          f"reckoned); a second process resumed at step "
          f"{ck['second']['first_step']} (its restore "
          f"{ck['second']['restore_s']} s) with loss "
          f"{ck['second']['losses'][0]!r}, the continued run's "
          f"{ck['continued']!r}; launches {json.dumps(ck['launches'])}")


# the reference's large MoE configs at full width, depth cut: mixtral-8x22b
# (d 6144, 48 / 8 heads of 128: group size 6; 8 experts, top-2, f 16384;
# window 4096) at 2 of its 56 layers, served 8 x 512 through fused_flat and
# fused_hier and one prompt of 5120 tokens (past the window) with decode,
# and trained at 1 layer, B 4 x S 512; deepseek-v3-bench (d 7168, 56 / 8
# heads: group size 7; 256 experts, top-8, f 2048) at 1 of its 61 layers,
# served 8 x 512 (its training, ~182 GB a layer, needs more cards)
MIXTRAL, DEEPSEEK = "mixtral-8x22b", "deepseek-v3-bench"
LARGE_FLAGS = ["--requests", "8", "--prompt-len", "512", "--gen", "16"]
WINDOW_PROMPT = 5120
LARGE_SERVE = {
    MIXTRAL: ["--arch", MIXTRAL, "--engine", "fused_flat", "--layers", "2"]
    + LARGE_FLAGS,
    f"{MIXTRAL} fused_hier": ["--arch", MIXTRAL, "--engine", "fused_hier",
                              "--layers", "2"] + LARGE_FLAGS,
    f"{MIXTRAL} window": ["--arch", MIXTRAL, "--engine", "fused_flat",
                          "--layers", "2", "--requests", "1", "--prompt-len",
                          str(WINDOW_PROMPT), "--gen", "16"],
    DEEPSEEK: ["--arch", DEEPSEEK, "--engine", "fused_flat", "--layers", "1"]
    + LARGE_FLAGS,
}
LARGE_TRAINS = {f"{MIXTRAL} train": ["--arch", MIXTRAL, "--engine",
                                     "fused_flat", "--layers", "1"]
                + TRAIN_FLAGS}
# the kernels at each large path's shapes: (MoE shapes, None for the window
# path, whose MoE shapes are the serve path's at T 5120; attention; window)
LARGE_SHAPES = {
    MIXTRAL: (dict(t=4096, d=6144, n_experts=8, top_k=2, f=16384,
                   decode_t=8),
              dict(b=8, sq=512, sk=512, hq=48, hkv=8, hd=128), 4096),
    f"{MIXTRAL} window": (None, dict(b=1, sq=WINDOW_PROMPT, sk=WINDOW_PROMPT,
                                     hq=48, hkv=8, hd=128), 4096),
    DEEPSEEK: (dict(t=4096, d=7168, n_experts=256, top_k=8, f=2048,
                    decode_t=8),
               dict(b=8, sq=512, sk=512, hq=56, hkv=8, hd=128), None),
}
# qwen3-14b's flash at its serve prefill shape (G 5): a kernel row with no
# model path, held and timed beside the large paths'
QWEN14, QWEN14_ATTN = "qwen3-14b", dict(b=8, sq=512, sk=512, hq=40, hkv=8,
                                        hd=128)
LARGE_TRAIN_SHAPES = {f"{MIXTRAL} train": (
    dict(t=2048, d=6144, n_experts=8, top_k=2, f=16384, decode_t=8),
    dict(b=4, sq=512, sk=512, hq=48, hkv=8, hd=128))}


def serve_implied(argv) -> dict:
    """The launches a fused_flat or fused_hier serve run of ``argv`` implies
    at EP 1: two prefills and gen + 1 decode steps (2 warm-up, gen - 1
    timed) over its layers; a prefill layer gathers and combines once
    (fused_hier twice: stage 1 and the expansion, the pre-combine and the
    origin sum) and runs one fused_swiglu and one flash forward, a decode
    step one fused_swiglu a layer."""
    from repro_torch.launch import serve
    args = serve.parse_args(argv)
    per = ENGINE_LAUNCHES[args.engine](1)
    n = 2 * args.layers
    return {"segment_gather": n * per[0], "segment_scatter_add": n * per[1],
            "fused_swiglu": (2 + args.gen + 1) * args.layers,
            "flash_attention": n, "grouped_matmul": 0,
            "segment_scatter_add_bwd": 0}


def train_implied(argv) -> dict:
    """The launches a fused_flat train run of ``argv`` implies at EP 1: a
    layer a step gathers once, combines once and scatter-adds once more as
    the gather's backward, runs the scatter-add's own backward, one
    fused_swiglu, one flash forward and the SwiGLU backward's five
    grouped_matmul products."""
    from repro_torch.launch import train
    args = train.parse_args(argv)
    n = args.layers * args.steps
    return {"segment_gather": n, "segment_scatter_add": 2 * n,
            "segment_scatter_add_bwd": n, "fused_swiglu": n,
            "flash_attention": n, "grouped_matmul": 5 * n}


def large_rows(timer=time_ms) -> list[dict]:
    """Every kernel at the large serving paths' shapes (``LARGE_SHAPES``)
    against its plain version: the MoE kernels at the prefill and decode
    shapes (fused_swiglu's large-f form), and the flash forward at each
    path's group size (mixtral's 6, deepseek's 7: the Hopper form's tiles of
    10 and 9 queries) and window, at 512 tokens and at the 5120-token
    prompt; then the flash forward at qwen3-14b's prefill (G 5, tiles of 12
    queries), a row of no model path (``main_path`` False)."""
    import torch
    rows = []
    for label, (moe, attn, window) in LARGE_SHAPES.items():
        with torch.inference_mode():
            if moe is not None:
                inp = main_path_inputs("cuda", **moe)
                rows += [dict(r, path=label) for r in kernel_phase(
                    inp, timer, fma=False, counting=False)]
                del inp
                torch.cuda.empty_cache()
            rows.append(dict(flash_row(*attention_inputs("cuda", **attn),
                                       window=window, timer=timer),
                             path=label))
        torch.cuda.empty_cache()
    with torch.inference_mode():
        rows.append(dict(flash_row(*attention_inputs("cuda", **QWEN14_ATTN),
                                   window=None, timer=timer),
                         path=QWEN14, main_path=False))
    return rows


def large_train_rows(timer=time_ms) -> list[dict]:
    """The kernels of the large train paths (``LARGE_TRAIN_SHAPES``) at
    their shapes: the forwards (``train_rows``) and the backwards
    (``backward_report``, printed)."""
    import torch
    rows = []
    for label, (moe, attn) in LARGE_TRAIN_SHAPES.items():
        inp = main_path_inputs("cuda", **moe)
        with torch.no_grad():
            rows += [dict(r, path=label) for r in train_rows(inp, attn,
                                                             timer)]
        back = backward_report(inp, attn, label, timer)
        del inp
        torch.cuda.empty_cache()
    return rows, back


# the ssm and hybrid families at full width: mamba2-2.7b (attention-free;
# d 2560, 80 SSM heads of 64, d_state 128, chunk 256) and hymba-1.5b (25 / 5
# heads of 64: group size 5, the Hopper flash form's tiles of 12 queries;
# window 1024 on every layer but 0, 15 and 31; its SSM branch 50 heads of
# 64, d_state 16), served at full depth 8 x 512 (+16) lock-step and through
# the continuous engine (buckets 256 and 512), hymba also one 2048-token
# prompt (the window binds on 29 layers), and trained B 4 x S 512, 8 AdamW
# steps: hymba at its 32 layers (~26.3 GB of parameters and AdamW state),
# mamba2 at 16 of its 64 (14.4 GB; at 64 the state alone would be 45.3 GB
# and each layer keeps (B, chunks, 80, 256, 256) SSD scores and decays for
# the backward).  Every prompt length a multiple of the SSD chunk
MAMBA, HYMBA = "mamba2-2.7b", "hymba-1.5b"
SSM_ARCHS = (MAMBA, HYMBA)
HYMBA_PROMPT = 2048
SSM_SERVE = {MAMBA: ["--arch", MAMBA] + LARGE_FLAGS,
             HYMBA: ["--arch", HYMBA] + LARGE_FLAGS,
             f"{HYMBA} window": ["--arch", HYMBA, "--requests", "1",
                                 "--prompt-len", str(HYMBA_PROMPT), "--gen",
                                 "16"]}
SSM_CONTINUOUS = {f"{a} continuous": ["--arch", a, "--continuous"]
                  + LARGE_FLAGS for a in SSM_ARCHS}
MAMBA_TRAIN_LAYERS = 16
SSM_TRAINS = {f"{MAMBA} train": ["--arch", MAMBA, "--layers",
                                 str(MAMBA_TRAIN_LAYERS)] + TRAIN_FLAGS,
              f"{HYMBA} train": ["--arch", HYMBA] + TRAIN_FLAGS}
# hymba's flash forward at its paths' shapes: (attention shape, windows)
HYMBA_ATTN = {
    HYMBA: (dict(b=8, sq=512, sk=512, hq=25, hkv=5, hd=64), (1024, None)),
    f"{HYMBA} window": (dict(b=1, sq=HYMBA_PROMPT, sk=HYMBA_PROMPT, hq=25,
                             hkv=5, hd=64), (1024,)),
    f"{HYMBA} train": (dict(b=4, sq=512, sk=512, hq=25, hkv=5, hd=64),
                       (1024,))}
# the bf16 prefill of mamba2 at full width, cut to these depths, against the
# same weights in f32: the SSD's decays and cumulative sums in bf16, as the
# reference computes them; then the SSD alone at one layer's shapes (B 2 x S
# 512, 80 heads of 64, d_state 128) at these chunks, whose log-decay
# cumsums reach about -0.8 x chunk
SSD_GAP_LAYERS = (1, 4)
SSD_GAP_CHUNKS = (256, 64, 16)


def ssm_serve_implied(argv) -> dict:
    """The launches a lock-step serve run of an ssm or hybrid ``argv``
    implies: two prefills of one flash forward a hybrid layer (none in
    decode, plain torch as the reference's jnp), no other kernel."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import lm
    args = serve.parse_args(argv)
    cfg = get_arch(args.arch).reduced() if args.reduced else get_arch(args.arch)
    layers = args.layers or cfg.n_layers
    out = dict.fromkeys(counters(), 0)
    if lm.has_attention(cfg):
        out["flash_attention"] = 2 * layers
    return out


def ssm_train_implied(argv) -> dict:
    """The launches a train run of an ssm or hybrid ``argv`` implies: one
    flash forward a hybrid layer a step, no other kernel."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    from repro_torch.models import lm
    args = train.parse_args(argv)
    cfg = get_arch(args.arch).reduced() if args.reduced else get_arch(args.arch)
    out = dict.fromkeys(counters(), 0)
    if lm.has_attention(cfg):
        out["flash_attention"] = (args.layers or cfg.n_layers) * args.steps
    return out


def hymba_flash_rows(timer=time_ms, device="cuda") -> list[dict]:
    """The flash forward at hymba's shapes (``HYMBA_ATTN``: hd 64, group
    size 5): its serve prefill with the window of 1024 (not binding at 512)
    and global, the 2048-token prompt (the window binds) and the train
    forward, each held against its plain version and timed beside SDPA."""
    import torch
    rows = []
    for path, (attn, windows) in HYMBA_ATTN.items():
        with torch.inference_mode():
            inp = attention_inputs(device, **attn)
            rows += [dict(flash_row(*inp, window=w, timer=timer), path=path)
                     for w in windows]
            del inp
    return rows


def ssm_continuous_phase(label: str, argv, device="cuda") -> dict:
    """``serve.run --continuous`` of an ssm or hybrid model at full width
    (a pool of as many slots as requests, buckets the SSD chunk's
    multiples), with the launch counters zeroed just before it and read
    just after: every request gets its tokens in the vocabulary, every
    bucket is a multiple of the chunk, and the flash forward launched once
    a hybrid layer a prefill (one per bucket at warm-up, one per admission
    of one request), nothing else.  Returns the launch counts."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import lm
    args = serve.parse_args(argv)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wrappers = zero_counters()
    out = serve.run(args, device=device)
    launches = {k: w.launches for k, w in wrappers.items()}
    eng, cfg = out["engine"], out["cfg"]
    implied = dict.fromkeys(launches, 0)
    if lm.has_attention(cfg):
        implied["flash_attention"] = cfg.n_layers * (len(eng.buckets)
                                                     + args.requests)
    if launches != implied or any(b % lm.seq_multiple(cfg)
                                  for b in eng.buckets):
        raise AssertionError(f"{label}: launches {launches}, its code implies "
                             f"{implied}; buckets {eng.buckets}")
    done = out["done"]
    if (len(done) != args.requests
            or any(len(r.output) != args.gen for r in done)
            or not all(0 <= t < cfg.vocab for r in done for t in r.output)):
        raise AssertionError(f"{label}: a request lacks its tokens")
    st = out["stats"]
    print(f"serve {label}: {cfg.name} full width, {cfg.n_layers} layers, "
          f"{args.requests} requests of {args.prompt_len} tokens, "
          f"{args.gen} each, pool {args.requests}, buckets "
          f"{list(eng.buckets)}: {eng.compile_count} prepared callables "
          f"built in {out['compile_s']:.2f} s; ttft p50 "
          f"{st['p50_ttft_s'] * 1e3:.3f} p99 {st['p99_ttft_s'] * 1e3:.3f} ms "
          f"(queued before the run); decode {st['decode_tok_s']:.1f} tok/s; "
          f"occupancy {st['mean_slot_occupancy']:.3f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{json.dumps(launches)}, as its code implies")
    print(f"sample tokens: {done[0].output}")
    del out, eng, done
    torch.cuda.empty_cache()
    return launches


def ssd_bf16_gap(device="cuda", depths=SSD_GAP_LAYERS) -> list[str]:
    """mamba2-2.7b at full width cut to each of ``depths``: the bf16
    prefill (2 x 512 tokens) of seed-0 weights against the same weights in
    f32 on the card; the SSD's decays and cumulative sums take the compute
    dtype, as the reference's do, so over a 256-step chunk the log-decay's
    cumsum (about -180) keeps a bf16 spacing of 1.  Returns one line per
    depth: the worst logit gap and the f32 logits' largest magnitude; then
    one per chunk of ``SSD_GAP_CHUNKS``: ``ssd_chunked`` alone in bf16
    against f32 on the same inputs (x and B, C normal, the log-decay
    -softplus of a normal, as dt x A with A = -1), its worst output gap
    relative to the f32 output's largest magnitude."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    lines = []
    for layers in depths:
        cfg = dataclasses.replace(get_arch(MAMBA), n_layers=layers)
        gen = torch.Generator(device=device).manual_seed(0)
        params = lm.init_params(cfg, lm.make_context(cfg, device), gen)
        tokens = torch.randint(0, cfg.vocab, (2, 512), generator=gen,
                               device=device)
        pos = torch.arange(512, device=device)
        logits = {}
        with torch.inference_mode():
            for dt in (torch.bfloat16, torch.float32):
                p = adamw.tree_map(lambda t: t.to(dt), params)
                logits[dt] = lm.prefill(p, tokens, pos, lm.make_context(
                    cfg, device, compute_dtype=dt), 512)[0]
        gap = max_err(logits[torch.bfloat16], logits[torch.float32])
        scale = logits[torch.float32].abs().max().item()
        if not all(bool(torch.isfinite(v).all()) for v in logits.values()):
            raise AssertionError(f"mamba2 {layers} layers: non-finite logits")
        lines.append(f"{layers} layers: worst logit gap {gap:.4g}, f32 "
                     f"|logit| max {scale:.4g} (relative {gap / scale:.4g})")
        del params, logits
        torch.cuda.empty_cache()
    from repro_torch.layers import ssm
    g = torch.Generator(device=device).manual_seed(1)
    randn = lambda *shape: torch.randn(shape, generator=g, device=device)
    x, b, c = randn(2, 512, 80, 64), randn(2, 512, 1, 128), randn(2, 512, 1, 128)
    a_log = -torch.nn.functional.softplus(randn(2, 512, 80))
    for chunk in SSD_GAP_CHUNKS:
        with torch.inference_mode():
            y = {dt: ssm.ssd_chunked(*(t.to(dt) for t in (x, a_log, b, c)),
                                     chunk)[0]
                 for dt in (torch.bfloat16, torch.float32)}
        scale = y[torch.float32].abs().max().item()
        gap = max_err(y[torch.bfloat16], y[torch.float32])
        lines.append(f"the SSD alone, chunk {chunk}: worst output gap "
                     f"{gap:.4g} of f32 |y| max {scale:.4g} (relative "
                     f"{gap / scale:.4g})")
    return lines


T0 = time.perf_counter()


# the vlm and encdec families: qwen2-vl-7b (M-RoPE, its 28 / 4 heads of 128:
# group size 7) and seamless-m4t-large-v2 (24 encoder + 24 decoder layers,
# 16 / 16 heads of 64: group size 1), served at full width and depth and
# trained through steps.make_train_step on zoo.make_smoke_batch batches
VLM, SEAMLESS = "qwen2-vl-7b", "seamless-m4t-large-v2"
EMBED_ARCHS = (VLM, SEAMLESS)
EMBED_SERVE = {a: ["--arch", a] + LARGE_FLAGS for a in EMBED_ARCHS}
# qwen2-vl cut to 4 of its 28 layers (2.02 B parameters, ~32 GB with the
# bf16 grads and AdamW's f32 master, mu and nu); seamless whole (2.03 B)
VLM_TRAIN_LAYERS = 4
EMBED_TRAINS = {f"{VLM} train": (VLM, VLM_TRAIN_LAYERS),
                f"{SEAMLESS} train": (SEAMLESS, 0)}
EMBED_TRAIN = dict(batch=4, seq=512, n_steps=6)
EMBED_LR = 1e-3           # AdamW on one fixed batch: its loss must fall
# a Qwen2-VL prompt of 512 positions (``zoo.vl_positions``): 100 text tokens,
# one frame of 16 x 16 patches at one temporal id, 156 tokens after
VL_LAYOUT = (100, (16, 16), 156)
VL_REDUCED_LAYOUT = (3, (3, 3), 4)      # the same, in 16 positions
# the flash forward at these families' shapes: (path, attention shape,
# causal, positions "image" (VL_LAYOUT's temporal row) or None (arange),
# on a phase's path); the seamless decoder's causal and cross calls at B 8
# run in no phase (its decode attention is plain torch, as the reference's
# jnp), so their rows are printed, not listed
SEAM_ATTN = dict(sq=512, sk=512, hq=16, hkv=16, hd=64)
VL_ATTN = dict(sq=512, sk=512, hq=28, hkv=4, hd=128)
EMBED_ATTN = (
    (SEAMLESS, dict(b=8, **SEAM_ATTN), False, None, True),
    (f"{SEAMLESS} decoder", dict(b=8, **SEAM_ATTN), True, None, False),
    (f"{SEAMLESS} cross", dict(b=8, **SEAM_ATTN), False, None, False),
    (VLM, dict(b=8, **VL_ATTN), True, "image", True),
    (f"{SEAMLESS} train", dict(b=4, **SEAM_ATTN), False, None, True),
    (f"{SEAMLESS} train", dict(b=4, **SEAM_ATTN), True, None, True),
    (f"{SEAMLESS} train", dict(b=4, **SEAM_ATTN), False, None, True),
    (f"{VLM} train", dict(b=4, **VL_ATTN), True, None, True))
# held only (b, sq, sk, hq, hkv, hd, causal): cross-attention with Sq != Sk
# both ways, qwen2-vl's serve shape at 3 x arange
EMBED_FLASH_HELD = ((8, 100, 512, 16, 16, 64, False),
                    (8, 512, 100, 16, 16, 64, False),
                    (8, 512, 512, 28, 4, 128, True))


def vl_attention_inputs(device, layout, b, sq, sk, hq, hkv, hd, seed=0):
    """:func:`attention_inputs`, its positions the temporal row of a
    Qwen2-VL ``layout`` (``zoo.vl_positions``: flat across the image) for
    both the queries and the keys."""
    import torch
    from repro_torch.models import zoo
    q, k, v, _, _ = attention_inputs(device, b, sq, sk, hq, hkv, hd,
                                     seed=seed)
    pos = zoo.vl_positions(*layout, device=device)[0].to(torch.int32)
    if pos.numel() != sq or sq != sk:
        raise ValueError(f"layout {layout} has {pos.numel()} positions for "
                         f"Sq {sq}, Sk {sk}")
    return q, k, v, pos, pos


def embed_flash_rows(timer=time_ms, device="cuda") -> tuple[list, list]:
    """The flash forward at the vlm's and encdec's shapes (``EMBED_ATTN``):
    seamless's bidirectional encoder, its decoder's causal self-attention
    and its cross-attention over 512 encoder keys (group size 1), and
    qwen2-vl's causal attention at group size 7 masked by the image layout's
    plateau of equal positions, at the serve and the train shapes, each
    held against its plain version and timed beside SDPA; then the held
    shapes of ``EMBED_FLASH_HELD``.  Returns the rows and one line per held
    shape."""
    import torch
    rows, lines = [], []
    for path, attn, causal, layout, main_path in EMBED_ATTN:
        with torch.inference_mode():
            inp = (vl_attention_inputs(device, VL_LAYOUT, **attn) if layout
                   else attention_inputs(device, **attn))
            rows.append(dict(flash_row(*inp, window=None, timer=timer,
                                       causal=causal), path=path,
                             main_path=main_path))
            del inp
    for b, sq, sk, hq, hkv, hd, causal in EMBED_FLASH_HELD:
        what = (f"q ({b}, {sq}, {hq}, {hd}) k ({sk}, {hkv}) "
                f"{'causal' if causal else 'bidirectional'}")
        with torch.inference_mode():
            _, _, err, tol, worst, err_lse = hold_flash(
                f"flash_attention {what}",
                *attention_inputs(device, b, sq, sk, hq, hkv, hd, seed=5),
                None, causal)
        lines.append(f"{what}: max_abs_err {err:.4g}, worst row {worst:.3f} "
                     f"of its row's tolerance, lse {err_lse:.4g}")
    return rows, lines


def embed_serve_implied(argv) -> dict:
    """The launches a lock-step serve run of a vlm or encdec ``argv``
    implies: two prefills of :func:`prefill_flash` flash forwards (a
    decoder layer each for the vlm, an encoder layer each for encdec; the
    decode attention is plain torch), no other kernel."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    args = serve.parse_args(argv)
    cfg = get_arch(args.arch).reduced() if args.reduced else get_arch(args.arch)
    out = dict.fromkeys(counters(), 0)
    out["flash_attention"] = 2 * prefill_flash(cfg)
    return out


def train_flash(cfg) -> int:
    """Flash forwards a train step of ``cfg`` runs: one a layer, and for
    the encoder-decoder one an encoder layer and two a decoder layer (its
    self- and cross-attention); the backward is plain torch."""
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.n_layers
    return cfg.n_layers


def embed_train_phase(arch: str, layers: int = 0, device="cuda",
                      reduced: bool = False, batch: int = 4, seq: int = 512,
                      n_steps: int = 6) -> dict:
    """A vlm or encdec model trained on the card: ``layers`` (0: all) of
    ``arch`` at full width (or ``reduced``), bf16 weights from seed 0,
    ``n_steps`` AdamW steps of ``steps.make_train_step`` on one
    ``zoo.make_smoke_batch`` batch (``batch`` x ``seq``), with every launch
    counter zeroed just before the steps and read just after.  Fails if a
    loss is not finite, the last loss is not below the first, or the flash
    forward did not launch :func:`train_flash` times a step or another
    kernel ran.  Returns the config, the losses, each step's ms, the
    launches, the peak memory (GiB; None on the CPU) and what
    :func:`step_profile` takes."""
    import dataclasses
    import math
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    from repro_torch.models import lm, zoo
    from repro_torch.optim import adamw
    cfg = get_arch(arch).reduced() if reduced else get_arch(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    model = zoo.build(cfg, lm.make_context(cfg, device))
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(gen)
    data = zoo.make_smoke_batch(cfg, gen, batch, seq)
    opt_cfg = adamw.AdamWConfig(lr=EMBED_LR, warmup_steps=2,
                                total_steps=n_steps)
    opt = steps.init_state(model, params)
    step = steps.make_train_step(model, opt_cfg)
    wrappers = zero_counters()
    losses, ms = [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, data)
        if on_card:
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    launches = {k: w.launches for k, w in wrappers.items()}
    implied = dict.fromkeys(launches, 0)
    implied["flash_attention"] = train_flash(cfg) * n_steps
    required, _ = family_kernels(cfg, train=True)
    if launches != implied or any(launches[k] == 0 for k in required):
        raise AssertionError(f"{arch} train: launches {launches}, its code "
                             f"implies {implied}")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"{arch} train: losses {losses} not finite or "
                             "not falling")
    return dict(cfg=cfg, losses=losses, step_ms=ms, launches=launches,
                implied=implied, tokens=batch * seq,
                peak_mem_gib=(torch.cuda.max_memory_allocated() / 2**30
                              if on_card else None),
                params_n=sum(p.numel() for p in adamw.leaves(params)),
                profile=(model, step, params, opt, data, opt_cfg))


def embed_train_and_profile(label: str, arch: str, layers: int,
                            device="cuda", shape=EMBED_TRAIN) -> dict:
    """:func:`embed_train_phase` at ``shape`` (``EMBED_TRAIN``), printed,
    then :func:`step_profile` of the same model, state and batch.  Returns
    the launch counts."""
    import torch
    out = embed_train_phase(arch, layers, device, **shape)
    cfg, n = out["cfg"], len(out["losses"])
    timed = statistics.median(out["step_ms"][2:])
    enc = (f" + {cfg.encoder_layers} encoder" if cfg.family == "encdec"
           else "")
    peak = ("n/a" if out["peak_mem_gib"] is None
            else f"{out['peak_mem_gib']:.2f}")
    print(f"{label}: {cfg.name} full width, {cfg.n_layers}{enc} layers, "
          f"{out['params_n']} parameters, B {shape['batch']} x S "
          f"{shape['seq']}, {n} AdamW steps on one batch: "
          f"{timed:.3f} ms/step (median of {n - 2} timed), "
          f"{out['tokens'] / timed * 1e3:.1f} tokens/s, peak memory {peak} GiB")
    print(f"{label} loss per step: " + " ".join(f"{x:.5f}"
                                                for x in out["losses"]))
    print(f"{label} ms per step: " + " ".join(f"{x:.3f}"
                                              for x in out["step_ms"]))
    print(f"launches on the {label} path ({n} steps): "
          f"{json.dumps(out['launches'])}; its code implies "
          f"{json.dumps(out['implied'])}")
    for part, p in step_profile(*out.pop("profile")).items():
        print_profile(f"{label} {part}", p, timed)
        check_profile(f"{label} {part}", p, flash=part != "adamw.update")
        if p is not None:
            print("  device ms by kind: " + ", ".join(
                f"{k} {ms:.4f}"
                for k, ms in device_kinds(p["by_kernel"]).items()))
    launches = out["launches"]
    del out
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return launches


def embed_reduced_check(arch: str, device="cuda") -> dict:
    """The reduced vlm or encdec model in float32 on the card (kernels)
    against the CPU (plain versions): the loss and every gradient
    (``steps.value_and_grad``) of a ``zoo.make_smoke_batch`` batch of 4 x
    16 (the vlm's at the image layout ``VL_REDUCED_LAYOUT``), then the
    bundle's prefill of its prompts and three greedy decode steps fed the
    CPU's tokens.  Fails past ``TOL_TRAIN`` (loss, gradients, relative to
    max(1, |x|)) or ``TOL_REDUCED`` (logits), or if the card launched no
    flash forward.  Returns the errors and the card's launches."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    from repro_torch.models import lm, zoo
    cfg = get_arch(arch).reduced()
    f32 = torch.float32
    models = {dev: zoo.build(cfg, lm.make_context(cfg, dev, compute_dtype=f32))
              for dev in ("cpu", device)}
    params = models["cpu"].init(torch.Generator().manual_seed(0), f32)
    batch = zoo.make_smoke_batch(cfg, torch.Generator().manual_seed(1), 4, 16)
    if cfg.family == "vlm":
        batch["positions"] = zoo.vl_positions(*VL_REDUCED_LAYOUT)
        prompt = {k: batch[k] for k in ("embeds", "positions")}
    else:
        prompt = {"frames": batch["frames"], "tokens": batch["tokens"][:, 0]}
    copy = lambda t, dev: ({k: copy(v, dev) for k, v in t.items()}
                           if isinstance(t, dict) else t.clone().to(dev))

    def run(dev, feed):
        model, p = models[dev], copy(params, dev)
        loss, _, grads = steps.value_and_grad(model)(p, copy(batch, dev))
        with torch.no_grad():
            logits, st = model.prefill(p, copy(prompt, dev), 20)
            seq = [logits.cpu()]
            for tok in feed or [None] * 3:
                tok = logits.argmax(-1).cpu() if tok is None else tok
                logits, st = model.decode_step(p, st, tok.to(dev), 20)
                seq.append(logits.cpu())
        return loss.detach().cpu(), [g.cpu() for g in grads], seq

    loss_r, grads_r, ref = run("cpu", None)
    wrappers = zero_counters()
    loss_c, grads_c, card = run(device, [lg.argmax(-1) for lg in ref[:-1]])
    launches = {k: w.launches for k, w in wrappers.items()}
    rel = lambda a, b: max_err(a, b) / max(1.0, b.abs().max().item())
    out = dict(loss=rel(loss_c, loss_r),
               grads=max(rel(a, b) for a, b in zip(grads_c, grads_r)),
               logits=max(max_err(a, b) for a, b in zip(card, ref)),
               launches=launches)
    if not (out["loss"] <= TOL_TRAIN and out["grads"] <= TOL_TRAIN
            and out["logits"] <= TOL_REDUCED and launches["flash_attention"]):
        raise AssertionError(f"reduced {arch} f32 card vs CPU: {out}")
    return out


def stamp(what: str) -> None:
    """The seconds since the script started, after ``what``."""
    print(f"[{time.perf_counter() - T0:.1f} s] {what} done", flush=True)


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"no src/repro_torch next to {Path(__file__).name}: run it from "
             "a checkout of the repository")
    import torch
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device; this smoke runs only on the GPU")
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"device {name}  torch {torch.__version__}  cuda {torch.version.cuda}")

    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:   # every nvcc started together
        split = ex.submit(_build.build_all, SPLIT_KERNELS,
                          tuple((d,) for d in SPLIT.values()))
        logs = _build.build_all()
        print(f"build: {len(logs)} kernels in {time.perf_counter() - t0:.2f} s "
              f"into {_build.BUILD}")
        split.result()
    print(f"build with the time-split variants: {time.perf_counter() - t0:.2f} s")
    lines, spilling = ptxas_report()
    print("\n".join(lines))
    if spilling:
        fail(f"the Hopper-form kernels spill registers: {spilling}")
    print(f"SASS of the Hopper forms: {json.dumps(sass_counts())}")

    rows = []
    with torch.inference_mode():
        for arch, (_, moe_shape, attn_shape) in PATHS.items():
            inp = main_path_inputs("cuda", **moe_shape)
            path_rows = kernel_phase(inp, fma=arch == "qwen3-moe-30b-a3b")
            path_rows.append(flash_row(*attention_inputs("cuda", **attn_shape),
                                       window=None))
            rows += [dict(r, path=arch) for r in path_rows]
            # the same kernels at the slices of the path's fused_pipe phase
            slice_rows, line = pipe_slice_rows(inp, pipe_config(arch))
            print(f"fused_pipe slices of {arch}: {line}")
            rows += [dict(r, path=f"{arch} fused_pipe") for r in slice_rows]
            if arch == "qwen3-moe-30b-a3b":     # the slice-7 engines' shapes
                rows += [dict(r, path=f"{arch} fused_hier")
                         for r in hier_kernel_rows(inp)]
                rows += [dict(r, path=f"{arch} ragged")
                         for r in ragged_kernel_rows(inp)]
            del inp
            torch.cuda.empty_cache()
        rows += [dict(r, path="qwen3-moe-30b-a3b continuous")
                 for r in admission_rows()]
        shifted = attention_inputs("cuda", **SHIFTED)
        for window in (None, WINDOW):
            rows.append(dict(flash_row(*shifted, window=window),
                             path="moe-tx-stream", main_path=False))
        del shifted
    # the training shapes, made outside inference mode: the backward rows
    # save them for autograd
    train_inp = main_path_inputs("cuda", **TRAIN[1])
    with torch.no_grad():
        rows += [dict(r, path="train") for r in gmm_rows(train_inp)]
        rows.append(dict(train_swiglu_row(train_inp), path="train"))
        # the forwards of the train step's flash and combine
        rows.append(dict(flash_row(*attention_inputs("cuda", **TRAIN[2]),
                                   window=None), path="train"))
        from repro_torch.kernels.ref import segment_gather_ref
        rows += [dict(r, path="train") for r in scatter_rows(
            segment_gather_ref(train_inp["x"], train_inp["idx"]), train_inp,
            train_inp["x"].shape[0])]
        rows += [dict(r, path="train fused_hier")
                 for r in hier_kernel_rows(train_inp)]
        for line in odd_shape_checks():
            print(f"odd shape {line}")
    # the moe-tx train step's kernels at its shapes, and at the slices of
    # its streamed fused_pipe phase
    tx_inp = main_path_inputs("cuda", **TX_TRAIN[1])
    tx_cfg, (tx_cap, tx_s) = tx_train_pipe_config()
    with torch.no_grad():
        rows += [dict(r, path="moe-tx train")
                 for r in train_rows(tx_inp, TX_TRAIN[2])]
        slice_rows, line = pipe_slice_rows(tx_inp, tx_cfg)
        print(f"fused_pipe slices of the moe-tx train step (streamed, "
              f"{TX_LAYERS} layers a block; capacity {tx_cap}): {line}")
        rows += [dict(r, path="moe-tx train fused_pipe") for r in slice_rows]
        # qwen3-1.7b's flash at group size 2
        dense_rows, lines = dense_flash_rows()
        rows += dense_rows
        # and at one microbatch of its pipeline's stages
        rows.append(dict(flash_row(*attention_inputs("cuda", **PIPE_ATTN),
                                   window=None),
                         path=f"{PIPE['arch']} pipeline"))
        for line in lines:
            print(f"flash group size 2, held: {line}")
    # moe-ffn-stream-1b's MoE kernels at its serve and train shapes and at
    # the slices of its streamed phases (its own seed)
    ffn_slices = {}
    with torch.inference_mode():
        ffn_inp = main_path_inputs("cuda", **FFN_SHAPES[FFN], seed=1)
        rows += [dict(r, path=FFN) for r in kernel_phase(
            ffn_inp, fma=False, counting=False)]
        ffn_cfg, ffn_slices[FFN] = ffn_pipe_config(FFN_SHAPES[FFN]["t"])
        slice_rows, line = pipe_slice_rows(ffn_inp, ffn_cfg)
        print(f"fused_pipe slices of the moe-ffn serve prefill (streamed, "
              f"{FFN_LAYERS} layers a block): {line}")
        rows += [dict(r, path=f"{FFN} fused_pipe") for r in slice_rows]
        del ffn_inp
    ffn_train = main_path_inputs("cuda", **FFN_SHAPES["moe-ffn train"], seed=1)
    with torch.no_grad():
        rows += [dict(r, path="moe-ffn train")
                 for r in train_rows(ffn_train, None)]
        ffn_cfg, ffn_slices["moe-ffn train"] = ffn_pipe_config(
            FFN_SHAPES["moe-ffn train"]["t"])
        slice_rows, line = pipe_slice_rows(ffn_train, ffn_cfg)
        print(f"fused_pipe slices of the moe-ffn train step (streamed, "
              f"{FFN_LAYERS} layers a block): {line}")
        rows += [dict(r, path="moe-ffn train fused_pipe") for r in slice_rows]
    # the interleaved paths' kernels at one lane's shapes
    lane_plans = {}
    for label, argv in (LANE_SERVE | LANE_TRAINS).items():
        train = label in LANE_TRAINS
        plan = lane_plans[label] = lane_plan(argv, train)
        with torch.no_grad() if train else torch.inference_mode():
            lane_kernel_rows, line = lane_rows(plan, train)
        print(f"{label}: {plan['lanes']} lanes of {plan['rows']} rows "
              f"({plan['t']} tokens each); S {plan['slices']} per lane "
              f"(capacity {plan['cap']}, Cs {plan['cap'] // plan['slices']}); "
              f"the slices of one lane: {line}")
        rows += [dict(r, path=label) for r in lane_kernel_rows]
        torch.cuda.empty_cache()
    del train_inp
    stamp("the kernel rows of the earlier paths")
    rows += large_rows()
    large_train, large_back = large_train_rows()
    rows += large_train
    with torch.no_grad():
        rows += tp_flash_rows()
    rows += hymba_flash_rows()
    embed_rows, lines = embed_flash_rows()
    rows += embed_rows
    for line in lines:
        print(f"flash held (vlm / encdec shapes): {line}")
    stamp("the kernel rows of the large paths")
    train_inp = main_path_inputs("cuda", **TRAIN[1])
    for r in rows:
        print_row(r)
    rows += large_back
    rows += backward_report(train_inp, TRAIN[2], "train")
    rows += backward_report(tx_inp, TX_TRAIN[2], "moe-tx train")
    rows += backward_report(ffn_train, None, "moe-ffn train")
    backward_report(None, DENSE_ATTN[f"{DENSE} train"], f"{DENSE} train")
    backward_report(None, HYMBA_ATTN[f"{HYMBA} train"][0], f"{HYMBA} train")
    del train_inp, tx_inp, ffn_train
    torch.cuda.empty_cache()

    # the pipe constants measured on this card, and the slice counts they give
    table, lines = calibrate_phase()
    print(f"calibrated pipe constants: {json.dumps(table.as_dict())} (spec "
          f"point: stage 3.35e12 B/s, wire 4.5e11 B/s, overhead 2e-06 s)")
    for line in lines:
        print(f"  slices, {line}")
    # the engine phase: one full-width MoE layer through every engine
    engines = []
    for shape, moe_shape in ENGINE_SHAPES.items():
        with torch.inference_mode():
            for r in engine_rows(main_path_inputs("cuda", **moe_shape), table):
                engines.append(dict(r, shape=shape))
                print(f"engine {shape} T {r['t']} {r['label']:<29}: S "
                      f"{r['slices']} (Cs {r['slice_rows']}, capacity "
                      f"{r['capacity']}); device {r['ms']:.4f} ms"
                      f"{spread(r['ms'])}, host clock {r['wall_ms']:.4f} ms"
                      f"{spread(r['wall_ms'])}; fused_swiglu launches "
                      f"{r['swiglu_launches']}, weight bytes "
                      f"{r['weight_bytes']} ({r['live_expert_launches']} live "
                      f"expert-launches); gathers "
                      f"{r['launches']['segment_gather']}, scatter-adds "
                      f"{r['launches']['segment_scatter_add']}; max_abs_err vs fused_flat "
                      f"{r['max_abs_err']:.4g} (per-element tolerance "
                      f"(n + 2) u a, at most {r['tol']:.4g}; worst element "
                      f"at {r['tol_share']:.3f} of its own)")
        torch.cuda.empty_cache()
    with torch.inference_mode():
        errs = engine_f32_check(table)
    print(f"engines f32 (d 256, f 128) vs fused_flat on the card: "
          f"{json.dumps(errs)}")
    print(json.dumps({"engines": [
        {k: (float(v) if isinstance(v, float) else v) for k, v in r.items()}
        | {"ms_min": r["ms"].lo, "ms_max": r["ms"].hi}
        for r in engines]}))

    launches, serve_times = {}, {}
    for arch in PATHS:
        launches[arch], serve_times[arch] = serve_and_profile(arch, PATHS[arch][0])
    for label, (argv, required, absent) in ENGINE_SERVE.items():
        launches[label], serve_times[label] = serve_and_profile(
            label, argv, required, absent)
    for label, argv in NEW_SERVE.items():
        if "--moe-stream" in argv:
            cap, s = ffn_slices[FFN]
            print(f"{label} --moe-stream {FFN_LAYERS}: pipesim's joint S at T "
                  f"{FFN_SHAPES[FFN]['t']} is {s} (capacity {cap}, Cs "
                  f"{cap // s})")
        launches[label], serve_times[label] = serve_and_profile(
            label, argv, *family_kernels(get_arch(argv[1]), train=False))
    for label, argv in LANE_SERVE.items():
        plan = lane_plans[label]
        implied = lane_launches(plan, train=False)
        print(f"{label}: {plan['lanes']} lanes of {plan['rows']} requests, S "
              f"{plan['slices']} per lane (capacity {plan['cap']}); launches "
              f"its code implies: {json.dumps(implied)}")
        launches[label], serve_times[label] = serve_and_profile(
            label, argv, *family_kernels(plan["cfg"], train=False),
            implied=implied)
    stamp("the serve phases of the earlier paths")
    for label, argv in LARGE_SERVE.items():
        launches[label], serve_times[label] = serve_and_profile(
            label, argv, *family_kernels(get_arch(argv[1]), train=False),
            implied=serve_implied(argv))
    stamp("the large serve phases")
    for label, argv in SSM_SERVE.items():
        launches[label], serve_times[label] = serve_and_profile(
            label, argv, *family_kernels(get_arch(argv[1]), train=False),
            implied=ssm_serve_implied(argv))
    for label, argv in SSM_CONTINUOUS.items():
        launches[label] = ssm_continuous_phase(label, argv)
    for line in ssd_bf16_gap():
        print(f"mamba2-2.7b bf16 prefill (2 x 512) vs the same weights in f32 "
              f"on the card ({card_line()}): {line}")
    stamp("the ssm and hybrid serve phases")
    for label, argv in EMBED_SERVE.items():
        launches[label], serve_times[label] = serve_and_profile(
            label, argv, *family_kernels(get_arch(argv[1]), train=False),
            implied=embed_serve_implied(argv))
    stamp("the vlm and encdec serve phases")
    for label, spec in CONTINUOUS.items():
        launches[label], serve_times[label] = continuous_phase(label, spec)
    print(f"serve times by path: {json.dumps(serve_times)}")
    fixed = {}
    for label, argv in TRAINS.items():
        launches[label] = train_and_profile(label, argv,
                                            record=fixed.setdefault(label, {}))
    print(f"moe-tx train fused_pipe --moe-stream {TX_LAYERS}: pipesim's "
          f"streamed S at T {TX_TRAIN[1]['t']} is {tx_s} (capacity {tx_cap}, "
          f"Cs {tx_cap // tx_s})")
    for label, argv in RELAYOUTS.items():
        res = relayout_phase(label, argv, launches[label[:-len(" relayout")]])
        launches[label] = res["launches"]
        print_relayouts(label, argv, res)
    auto = engine_auto_phase({e: per_layer_step(launches[label], argv)
                              for label, argv, e in (
                                  ("train", TRAINS["train"], "fused_flat"),
                                  ("train fused_hier",
                                   TRAINS["train fused_hier"], "fused_hier"))},
                             fixed["train"])
    launches["auto"] = auto["launches"]
    launches[f"auto forced {letters(AUTO_MIXED)}"] = auto["forced"]
    print_auto(auto, fixed)
    for label, argv in TX_TRAINS.items():
        launches[label] = train_and_profile(label, argv)
    cap, s = ffn_slices["moe-ffn train"]
    print(f"moe-ffn train fused_pipe --moe-stream {FFN_LAYERS}: pipesim's "
          f"joint S at T {FFN_SHAPES['moe-ffn train']['t']} is {s} (capacity "
          f"{cap}, Cs {cap // s})")
    for label, argv in NEW_TRAINS.items():
        launches[label] = train_and_profile(label, argv)
    for label, argv in LANE_TRAINS.items():
        plan = lane_plans[label]
        implied = lane_launches(plan, train=True)
        print(f"{label}: {plan['lanes']} lanes of {plan['rows']} rows, the "
              f"{plan['lanes']} accumulation micro-batches fused into them; S "
              f"{plan['slices']} per lane (capacity {plan['cap']}); launches "
              f"its code implies: {json.dumps(implied)}")
        launches[label] = train_and_profile(label, argv, implied=implied)
    stamp("the train phases of the earlier paths")
    for label, argv in LARGE_TRAINS.items():
        launches[label] = train_and_profile(label, argv,
                                            implied=train_implied(argv))
    stamp("the large train phases")
    for label, argv in SSM_TRAINS.items():
        launches[label] = train_and_profile(label, argv,
                                            implied=ssm_train_implied(argv))
    stamp("the ssm and hybrid train phases")
    for label, (arch, layers) in EMBED_TRAINS.items():
        launches[label] = embed_train_and_profile(label, arch, layers)
    stamp("the vlm and encdec train phases")
    ckpt = checkpoint_phase()
    launches["checkpoint"] = ckpt["launches"]
    print_checkpoint(ckpt)
    cost = traffic_cost_phase(TRAIN[0])
    print("qwen3-moe-30b-a3b train step with and without the traffic "
          "statistics, in turns: " + "; ".join(
              f"{k}: host {v['host_ms']:.3f} ms, device busy "
              + ("not measured" if v["busy_ms"] is None else
                 f"{v['busy_ms']:.4f} ms over {v['activities']} activities")
              for k, v in cost.items()))
    torch.cuda.empty_cache()
    stamp("checkpoints and the traffic cost")
    for arch, engine in ([(a, e) for e in REDUCED_ENGINES for a in PATHS]
                         + NEW_REDUCED):
        worst = reduced_check(arch, engine=engine)
        print(f"reduced {arch} {engine} f32, card (kernels) vs CPU "
              f"(plain): max logit error {worst:.3g} (tol {TOL_REDUCED})")
    for arch in EMBED_ARCHS:
        err = embed_reduced_check(arch)
        print(f"reduced {arch} f32, card (kernels) vs CPU (plain): loss "
              f"{err['loss']:.3g}, grads {err['grads']:.3g} of max(1, |x|) "
              f"(tol {TOL_TRAIN}), prefill and 3 decode steps' logits "
              f"{err['logits']:.3g} (tol {TOL_REDUCED}); launches on the card "
              f"{json.dumps(err['launches'])}")
    for arch in (FFN, TX):
        worst = reduced_check(arch, engine="fused_pipe", lanes=LANES)
        one = reduced_check(arch, engine="fused_pipe", lanes=LANES,
                            against=("cuda", 1))
        print(f"reduced {arch} fused_pipe at {LANES} lanes f32, card (kernels) "
              f"vs CPU (plain) at {LANES} lanes: max logit error {worst:.3g}; "
              f"vs the card at one lane: {one:.3g} (tol {TOL_REDUCED})")
    for arch, engine, lanes in CONTINUOUS_CHECKS:
        out = continuous_check(arch, engine, lanes=lanes)
        print(f"continuous {arch} {engine} reduced f32, admission chunk "
              f"{out['admit_chunk']}: card (kernels) streams "
              f"equal the CPU's (plain) and the card's batch-1 waved oracle "
              f"({out['requests']} requests, {out['tokens']} tokens); traffic "
              f"state vs the CPU's {out['traffic_err']:.3g} of max(1, |x|) "
              f"(tol {TOL_TRAFFIC})")
    for arch, engine in RELAYOUT_REDUCED:
        err = reduced_relayout_check(arch, engine)
        print(f"reduced {arch} {engine} f32, relayout after step 2 of 4, card "
              f"(kernels) vs CPU (plain): the same table {err['table']}; "
              f"losses {err['loss']:.3g}, grads after it {err['grads']:.3g} "
              f"(tol {TOL_TRAIN}), migrated params {err['params']:.3g} and "
              f"master {err['master']:.3g} (tol {err['p_tol']:.3g}), mu "
              f"{err['mu']:.3g} and nu {err['nu']:.3g} (tol {TOL_TRAIN}); "
              f"{err['stats']['rows_moved']}/{err['stats']['slots']} blocks "
              f"moved; launches on the card {json.dumps(err['launches'])}")
    for run, n in reduced_bf16_runs().items():
        print(f"reduced {run} bf16 on the card (flash tensor-core form): "
              f"launches {json.dumps(n)}")
    # the train step over an explicit one-rank NCCL group: no group's bits
    import torch.distributed as dist
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1)
    try:
        for arch, engine, lanes in (
                [("qwen3-moe-30b-a3b", e, 1) for e in REDUCED_ENGINES]
                + [("moe-tx-stream", e, 1) for e in TX_REDUCED_ENGINES]
                + [(a, e, 1) for a, e in NEW_REDUCED]
                + [(a, "fused_pipe", LANES) for a in (FFN, TX)]):
            err = reduced_train_check(engine=engine, arch=arch,
                                      group=dist.group.WORLD, lanes=lanes)
            if lanes > 1:
                print(f"reduced {arch} train step {engine} at {lanes} lanes, "
                      f"accum {lanes} fused, f32 on the card vs the card at "
                      f"one lane: {json.dumps(err['one_lane'])}")
            engine = f"{engine} at {lanes} lanes" if lanes > 1 else engine
            print(f"reduced {arch} train step {engine} f32, card "
                  f"(kernels) vs CPU (plain): loss {err['loss']:.3g}, grads "
                  f"{err['grads']:.3g} of max(1, max |grad|) (tol {TOL_TRAIN}), "
                  f"updated params {err['params']:.3g} (tol "
                  f"{err['params_tol']:.3g}), traffic {err['traffic']:.3g} of "
                  f"max(1, |x|) (tol {TOL_TRAFFIC}); over a one-rank NCCL "
                  f"group: {err['one_rank_group']}; launches on the card "
                  f"{json.dumps(err['launches'])}")
    finally:
        dist.destroy_process_group()
    stamp("the reduced checks")
    ep2_lines, replicated_lines = ep2_card_check()
    for line in ep2_lines:
        print(f"EP 2 on one card (two gloo ranks), f32 train step vs EP 1: "
              f"{line}")
    for line in replicated_lines:
        print(f"replicated table on one card (two gloo ranks, reduced "
              f"qwen3-moe f32, 8 experts on 2 lanes x {REPLICATED_SLOTS} "
              f"slots): {line}")
    grid_lines, grid_launches, grid_rows = grid_card_check()
    for line in grid_lines[GRID]:
        print(f"(2, 2) grid on one card (four gloo ranks), f32 train step vs "
              f"one rank: {line}")
    for line in grid_lines[TP4]:
        print(f"(1, 4) grid on one card (four gloo ranks), Megatron TP, f32 "
              f"train step vs one rank: {line}")
    for line in grid_lines["serve"]:
        print(f"serving on the (2, 2) grid on one card (four gloo ranks, "
              f"batch rows over the data group) vs the card alone: {line}")
    for line in grid_lines["pipeline"]:
        print(f"pipeline over the four gloo ranks sharing the card (GPipe, "
              f"forward and backward) vs the sequential stack: {line}")
    for r in grid_rows:
        print_row(r)
    rows += grid_rows
    launches.update(grid_launches)
    stamp("the grid checks and the pipeline")
    print(f"gradient compression (int8, error feedback) on the card: "
          f"{compress_phase()}")
    torch.cuda.empty_cache()
    stamp("gradient compression")
    zero1_lines, fsdp_lines = zero1_phase()
    for line in zero1_lines:
        print(f"full-width ZeRO-1 run, (2, 2) grid on one card: {line}")
    for line in fsdp_lines:
        print(f"full-width FSDP run (ZeRO-3 of the experts), (2, 2) grid on "
              f"one card: {line}")
    stamp("ZeRO-1 and FSDP grids (one spawn)")
    tp_lines, tp_launches = tp_full_phase()
    for line in tp_lines:
        print(f"full-width step over a model group (gloo ranks sharing the "
              f"card; embed and lm_head split), bf16, one train step: {line}")
    launches.update(tp_launches)
    stamp("full-width TP")

    print(card_line())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "path", "launches_by_phase", "ms_min", "ms_max")
    for r in rows:
        r["ms_min"], r["ms_max"] = (getattr(r["ms"], "lo", None),
                                    getattr(r["ms"], "hi", None))
    rows = [r for r in rows if r.get("main_path", True)]
    for r in rows:
        counter = max((c for c in launches[r["path"]] if r["name"].startswith(c)),
                      key=len)
        r["launches_by_phase"] = {a: n[counter] for a, n in launches.items()}
        r["launches"] = r["launches_by_phase"][r["path"]]
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
