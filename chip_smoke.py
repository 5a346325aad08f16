#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

1. Builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` with
   nvcc (one process per source, in parallel) and prints the build time and
   the compiler's register / shared-memory report.
2. Kernel phase: holds each kernel against its plain PyTorch version on the
   card, in bf16, at the shapes the serving main path gives it (the
   qwen3-moe-30b-a3b prefill of 8 requests x 64 tokens through fused_flat:
   T = 512 tokens, 128 experts, top-8, capacity 64; and the decode shape),
   and times kernel, plain version and a PyTorch yardstick with CUDA events.
3. Serve phase: zeroes the kernels' launch counters, serves the full-width
   qwen3-moe-30b-a3b (4 layers, random bf16 weights from a seed) through
   ``repro_torch.launch.serve``, reads the counters and fails if a kernel of
   the path never launched.  Then profiles one prefill and one decode step
   of the same path (torch.profiler) and prints the device's busy time
   beside the step's wall time, and the kernels with the most device time.
4. Checks the outputs: finite logits and in-vocabulary tokens of the right
   shape, and the reduced model's logits on the card (kernels) against the
   same model on the CPU (plain versions).
5. Prints the card's name and power limit, the kernels' numbers as one JSON
   line, and last ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero before the last line.  Without a CUDA
device, or outside a checkout that holds ``src/repro_torch``, it exits
non-zero and prints no result.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
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

# the serving main path (qwen3-moe-30b-a3b, --requests 8 --prompt-len 64)
MAIN = dict(t=512, d=2048, n_experts=128, top_k=8, f=768, decode_t=8)
SERVE_ARGS = ["--arch", "qwen3-moe-30b-a3b", "--engine", "fused_flat",
              "--layers", "4", "--requests", "8", "--prompt-len", "64",
              "--gen", "16"]

# tolerances on the card, bf16 outputs against the plain versions
TOL_GATHER = 0.0          # a copy: exact
TOL_REL = 1e-2            # f32 sums in another order, then one bf16 rounding:
                          # 1% of the output's largest magnitude (~2 bf16 steps)
TOL_REDUCED = 1e-3        # reduced model in f32, card vs CPU, on logits


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, reps: int = 10, warmup: int = 2, rounds: int = 3) -> float:
    """Device time of one call of ``fn``: CUDA events around ``reps``
    back-to-back calls, divided by ``reps``; the median of ``rounds``.  Each
    round is queued behind a device-side sleep, so the host has issued every
    call before the first event fires and its launch overhead is not timed."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(rounds):
        slept, start, end = (torch.cuda.Event(enable_timing=True)
                             for _ in range(3))
        slept.record()
        torch.cuda._sleep(SLEEP_CYCLES)
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
    return statistics.median(ts)


def bound(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    """Least time (ms) for the work and what bounds it."""
    tb, to = nbytes / MEM_BW, ops / peak
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def main_path_inputs(device, t, d, n_experts, top_k, f, decode_t, seed=0):
    """The tensors each kernel meets on the serving main path: routed tokens,
    the flat plan's descriptors, the landed buffer with its real per-expert
    counts, the expert weights, and the decode layout."""
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
    return dict(x=x, w1=w1, w3=w3, w2=w2, cap=cap, counts=counts,
                idx=plan.src_of_slot.contiguous(),
                gates=plan.gate_of_slot.float().contiguous(),
                decode_rows=xd[None, None].expand(1, n_experts, decode_t, d).contiguous(),
                decode_counts=torch.full((1, n_experts), decode_t,
                                         dtype=torch.int32, device=device))


def kernel_phase(inp, timer=time_ms) -> list[dict]:
    """Each kernel against its plain version at the main path's shapes.
    Returns one row per kernel and shape, without the launch counts."""
    import torch
    from repro_torch.kernels import fused_staging as fs_k
    from repro_torch.kernels import segment_gather as g_k
    from repro_torch.kernels import segment_scatter_add as s_k

    x, idx, gates = inp["x"], inp["idx"], inp["gates"]
    w1, w3, w2 = inp["w1"], inp["w3"], inp["w2"]
    t, d = x.shape
    n_e, _, f = w1.shape
    es = x.element_size()
    rows = []

    # segment_gather: src (T, d), idx (R,)
    got = g_k.segment_gather(x, idx)
    want = g_k.segment_gather_plain(x, idx)
    err = max_err(got, want)
    if err > TOL_GATHER:
        raise AssertionError(f"segment_gather: max_abs_err {err} > {TOL_GATHER}")
    r = idx.shape[0]
    live_src = int(torch.unique(idx[idx >= 0]).numel())
    b_ms, b_by = bound(r * 4 + live_src * d * es + r * d * es, 0, F32_PEAK)
    safe_idx = idx.clamp_min(0).long()
    rows.append(dict(
        name="segment_gather", shape=f"src ({t}, {d}) idx ({r},) bf16",
        route="cuda", source="src/repro_torch/csrc/segment_gather.cu",
        replaces="src/repro/kernels/segment_gather.py:38",
        max_abs_err=err, tol=TOL_GATHER,
        ms=timer(lambda: g_k.segment_gather(x, idx)),
        plain_ms=timer(lambda: g_k.segment_gather_plain(x, idx)),
        bound_ms=b_ms, bound_by=b_by,
        library="torch.index_select (no zero rows for -1)",
        library_ms=timer(lambda: torch.index_select(x, 0, safe_idx))))

    # fused_swiglu at the prefill shape (real counts) and the decode shape
    buf = got.reshape(1, n_e, inp["cap"], d)
    for name, xs, counts in (("fused_swiglu", buf, inp["counts"]),
                             ("fused_swiglu_decode", inp["decode_rows"],
                              inp["decode_counts"])):
        y = fs_k.fused_swiglu(xs, w1, w3, w2, counts)
        want = fs_k.fused_swiglu_plain(xs, w1, w3, w2, counts)
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
        xb = xs.reshape(n_e, c, d)

        def bmm_swiglu():
            h = torch.bmm(xb, w1)
            u = torch.bmm(xb, w3)
            return torch.bmm(torch.nn.functional.silu(h) * u, w2)

        rows.append(dict(
            name=name, shape=f"x {tuple(xs.shape)} live rows {live_rows} bf16",
            route="cuda", source="src/repro_torch/csrc/fused_swiglu.cu",
            replaces="src/repro/kernels/fused_staging.py:83",
            max_abs_err=err, tol=tol,
            ms=timer(lambda: fs_k.fused_swiglu(xs, w1, w3, w2, counts), reps=5),
            plain_ms=timer(lambda: fs_k.fused_swiglu_plain(xs, w1, w3, w2, counts),
                           reps=3, warmup=1),
            bound_ms=b_ms, bound_by=b_by,
            library="torch.bmm x3 + silu*mul (all rows, bf16 hidden)",
            library_ms=timer(bmm_swiglu, reps=5)))
        if name == "fused_swiglu":
            expert_out = y
            # the FMA variant (what the kernel takes off the tensor-core
            # path), held and timed at the same shape for comparison
            fma = lambda: fs_k._launch_fma(xs, w1, w3, w2, counts,
                                           torch.empty_like(xs))
            y_fma = torch.empty_like(xs)
            fs_k._launch_fma(xs, w1, w3, w2, counts, y_fma)
            err_fma = max_err(y_fma, want)
            if not err_fma <= tol:
                raise AssertionError(f"fused_swiglu FMA variant: max_abs_err "
                                     f"{err_fma} > {tol}")
            rows.append(dict(rows[-1], name="fused_swiglu_fma", main_path=False,
                             max_abs_err=err_fma, ms=timer(fma, reps=5)))

    # segment_scatter_add: (R, d) -> T rows, gated
    src = expert_out.reshape(-1, d)
    got = s_k.segment_scatter_add(src, idx, gates, t)
    want = s_k.segment_scatter_add_plain(src, idx, gates, t)
    err = max_err(got, want)
    tol = TOL_REL * want.float().abs().max().item()
    if not err <= tol:
        raise AssertionError(f"segment_scatter_add: max_abs_err {err} > {tol}")
    live_rows = int((idx >= 0).sum())
    b_ms, b_by = bound(live_rows * d * es + r * 8 + t * d * es,
                       2 * live_rows * d, F32_PEAK)
    dump = torch.where(idx < 0, t, idx).long()
    scaled = src.float() * gates[:, None]
    acc = torch.zeros(t + 1, d, device=x.device)
    rows.append(dict(
        name="segment_scatter_add", shape=f"src ({r}, {d}) -> ({t}, {d}) bf16",
        route="cuda", source="src/repro_torch/csrc/segment_scatter_add.cu",
        replaces="src/repro/kernels/segment_scatter_add.py:37",
        max_abs_err=err, tol=tol,
        ms=timer(lambda: s_k.segment_scatter_add(src, idx, gates, t)),
        plain_ms=timer(lambda: s_k.segment_scatter_add_plain(src, idx, gates, t)),
        bound_ms=b_ms, bound_by=b_by,
        library="Tensor.index_add_ (f32, pre-gated rows, dump row for -1)",
        library_ms=timer(lambda: acc.index_add_(0, dump, scaled))))
    return rows


def counters():
    from repro_torch.kernels import fused_staging, segment_gather, segment_scatter_add
    return {"segment_gather": segment_gather.segment_gather,
            "segment_scatter_add": segment_scatter_add.segment_scatter_add,
            "fused_swiglu": fused_staging.fused_swiglu}


def serve_phase(argv, device="cuda"):
    """The main path once, with every launch counter zeroed just before it
    and read just after.  Returns the serve result and the counts."""
    import torch
    from repro_torch.launch import serve
    args = serve.parse_args(argv)
    wrappers = counters()
    for w in wrappers.values():
        w.launches = 0
    out = serve.run(args, device=device)
    launches = {k: w.launches for k, w in wrappers.items()}
    never = [k for k, n in launches.items() if n == 0]
    if never:
        raise AssertionError(f"main path never launched {never}: {launches}")
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
    and one decode step of the serve path, each under torch.profiler.
    Returns per step the host's wall time under the profiler, the device's
    busy time (the union of its activities' intervals) and the device time
    by kernel, most first; None for a step whose trace shows no device
    activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    from repro_torch.models import lm
    s = serve.setup(serve.parse_args(argv), device)
    prefill = lambda: lm.prefill(s.params, s.tokens, s.positions, s.ctx,
                                 s.max_len)
    out = {}
    with torch.inference_mode():
        logits, state = prefill()
        tok = logits.argmax(-1)
        decode = lambda: lm.decode_step(s.params, state, tok, s.ctx, s.max_len)
        decode()
        torch.cuda.synchronize()
        for step, fn in (("prefill", prefill), ("decode", decode)):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            spans = sorted((e.time_range.start, e.time_range.end, e.name)
                           for e in prof.events()
                           if e.device_type == DeviceType.CUDA)
            if not spans:
                out[step] = None
                continue
            busy_us, reach, by_name = 0.0, float("-inf"), {}
            for a, b, name in spans:
                busy_us += max(0.0, b - max(a, reach))
                reach = max(reach, b)
                by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3
            out[step] = dict(wall_ms=wall_ms, busy_ms=busy_us / 1e3,
                             activities=len(spans),
                             by_kernel=sorted(by_name.items(),
                                              key=lambda kv: -kv[1]))
    return out


def reduced_check(device="cuda") -> float:
    """The reduced model (float32) on the card through the kernels against
    the same model on the CPU through the plain versions: prefill and three
    decode steps fed the same tokens.  Returns the max logit error."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    cfg = get_arch("qwen3-moe-30b-a3b").reduced()
    f32 = torch.float32
    ctxs = {dev: lm.make_context(cfg, dev, compute_dtype=f32)
            for dev in ("cpu", device)}
    params = lm.init_params(cfg, ctxs["cpu"], torch.Generator().manual_seed(0),
                            dtype=f32)
    move = lambda t, dev: ({k: move(v, dev) for k, v in t.items()}
                           if isinstance(t, dict) else t.to(dev))
    tokens = torch.randint(0, cfg.vocab, (4, 16),
                           generator=torch.Generator().manual_seed(1))
    max_len = 20

    def run(dev, feed):
        p, ctx = move(params, dev), ctxs[dev]
        logits, st = lm.prefill(p, tokens.to(dev), torch.arange(16, device=dev),
                                ctx, max_len)
        seq = [logits.cpu()]
        for tok in feed or [None] * 3:
            tok = logits.argmax(-1).cpu() if tok is None else tok
            logits, st = lm.decode_step(p, st, tok.to(dev), ctx, max_len)
            seq.append(logits.cpu())
        return seq

    on_cpu = run("cpu", None)
    fed = [lg.argmax(-1) for lg in on_cpu[:-1]]
    worst = max(max_err(a, b) for a, b in zip(on_cpu, run(device, fed)))
    if not worst <= TOL_REDUCED:
        raise AssertionError(f"reduced model card vs CPU: {worst} > {TOL_REDUCED}")
    return worst


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"no src/repro_torch next to {Path(__file__).name}: run it from "
             "a checkout of the repository")
    import torch
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device; this smoke runs only on the GPU")
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"device {name}  torch {torch.__version__}  cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {len(logs)} kernels in {time.perf_counter() - t0:.2f} s "
          f"into {_build.BUILD}")
    for k, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {k}: {line.strip()}")

    with torch.inference_mode():
        rows = kernel_phase(main_path_inputs("cuda", **MAIN))
    for r in rows:
        print(f"kernel {r['name']:<20} {r['shape']}: max_abs_err "
              f"{r['max_abs_err']:.4g} (tol {r['tol']:.4g})  {r['ms']:.4f} ms  "
              f"plain {r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})  library {r['library_ms']:.4f} ms "
              f"[{r['library']}]")
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    out, launches = serve_phase(SERVE_ARGS)
    print(f"serve qwen3-moe-30b-a3b full width, 4 layers, 8 requests x 64 "
          f"prompt, 16 generated: ttft {out['ttft_s'] * 1e3:.3f} ms  decode "
          f"{out['decode_s_per_tok'] * 1e3:.3f} ms/token  warmup "
          f"{out['warmup_s']:.2f} s  peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"launches on the main path: {json.dumps(launches)}")
    print(f"sample tokens: {out['tokens'][0].tolist()}")
    unprofiled = {"prefill": out["ttft_s"] * 1e3,
                  "decode": out["decode_s_per_tok"] * 1e3}
    del out
    torch.cuda.empty_cache()

    for step, p in profile_phase(SERVE_ARGS).items():
        if p is None:
            print(f"profile {step}: the trace shows no device activity: "
                  "device busy time not measured")
            continue
        top = ", ".join(f"{name[:60]} {ms:.4f} ms"
                        for name, ms in p["by_kernel"][:6])
        print(f"profile {step}: device busy {p['busy_ms']:.4f} ms over "
              f"{p['activities']} device activities; host wall under the "
              f"profiler {p['wall_ms']:.3f} ms; busy share of the unprofiled "
              f"{unprofiled[step]:.3f} ms: {p['busy_ms'] / unprofiled[step]:.3f}"
              f"\n  top device time: {top}")
    torch.cuda.empty_cache()

    worst = reduced_check()
    print(f"reduced model f32, card (kernels) vs CPU (plain): max logit error "
          f"{worst:.3g} (tol {TOL_REDUCED})")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for r in rows:
        r["launches"] = launches["fused_swiglu" if r["name"].startswith(
            "fused_swiglu") else r["name"]]
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows
                                  if r.get("main_path", True)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
