"""Serving driver, lock-step batch: prefill through the FUSCO shuffle, then
greedy decode (port of the lock-step path of ``repro/launch/serve.py``).

``python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --engine fused_flat
--layers 4 --requests 8 --prompt-len 64 --gen 16``

Runs on the card (``cuda``).  Weights and prompts are random, drawn from
seed 0.  A warm-up prefill and two decode steps (which also build the
kernels) run before the clock starts; every timed region ends in
``torch.cuda.synchronize()``.  ``--layers N`` cuts depth only.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import NamedTuple

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-moe-30b-a3b")
    ap.add_argument("--reduced", action="store_true",
                    help="the reference's tiny smoke-test dims")
    ap.add_argument("--engine", default="fused_flat", choices=["fused_flat"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to its first N layers (depth only)")
    args = ap.parse_args(argv)
    if args.gen < 2:
        ap.error("--gen must be at least 2 (one prefill token, one decode step)")
    return args


class Setup(NamedTuple):
    cfg: ArchConfig
    ctx: lm.ModelContext
    params: dict
    tokens: torch.Tensor       # (requests, prompt_len) prompts
    positions: torch.Tensor    # (prompt_len,)
    max_len: int


def setup(args, device="cuda") -> Setup:
    """The model, its random parameters and the prompts of a serve run, all
    drawn from seed 0."""
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    ctx = lm.make_context(cfg, device, engine=args.engine)
    gen = torch.Generator(device=ctx.device).manual_seed(0)
    params = lm.init_params(cfg, ctx, gen)
    tokens = torch.randint(0, cfg.vocab, (args.requests, args.prompt_len),
                           generator=gen, device=ctx.device)
    positions = torch.arange(args.prompt_len, device=ctx.device)
    return Setup(cfg, ctx, params, tokens, positions,
                 args.prompt_len + args.gen)


def run(args, device="cuda") -> dict:
    """Serve one lock-step batch; returns the generated tokens (B, gen), the
    last logits and the timings."""
    cfg, ctx, params, tokens, positions, max_len = setup(args, device)

    def serve():
        logits, state = lm.prefill(params, tokens, positions, ctx, max_len)
        return logits, state, logits.argmax(-1)

    with torch.inference_mode():
        t0 = time.perf_counter()
        _, state, tok = serve()
        for _ in range(2):
            _, state = lm.decode_step(params, state, tok, ctx, max_len)
        _sync(ctx.device)
        warmup_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        logits, state, tok = serve()
        _sync(ctx.device)
        ttft = time.perf_counter() - t0
        seqs = [tok]
        t0 = time.perf_counter()
        for _ in range(args.gen - 1):
            logits, state = lm.decode_step(params, state, tok, ctx, max_len)
            tok = logits.argmax(-1)
            seqs.append(tok)
        _sync(ctx.device)
        t_dec = time.perf_counter() - t0
    return {"tokens": torch.stack(seqs, 1), "logits": logits,
            "warmup_s": warmup_s, "ttft_s": ttft,
            "decode_s_per_tok": t_dec / (args.gen - 1), "cfg": cfg}


def main(argv=None):
    args = parse_args(argv)
    out = run(args)
    print(f"warmup {out['warmup_s']:.2f} s")
    print(f"ttft {out['ttft_s'] * 1e3:.1f} ms   decode "
          f"{out['decode_s_per_tok'] * 1e3:.1f} ms/tok  "
          f"({args.requests} requests)")
    print("sample:", out["tokens"][0][:12].tolist())
    return out


if __name__ == "__main__":
    main()
