"""How often a torch.profiler trace loses device records: ``chip_smoke.py``'s
mixtral-8x22b train phase (full width, 1 layer, B 4 x S 512) traced many
times over, its forward and backward and its whole step.

    python3 tools/profile_loss.py [--reps 60] [--seconds 450]

Builds the kernels, sets the step up as ``chip_smoke.train_profile`` does,
and traces each part ``--reps`` times (the whole step a third as often).
Prints for each part the number of device records per trace (each trace
runs the same kernels), the traces that lack the flash forward's Hopper
form while its launch counter says it ran, and what every short trace
lacks against the longest.  With ``--seconds``, then traces the forward
and backward until the process is that old, in turns with and without
``chip_smoke.TRACE_PAUSE_S`` between the trace's start and the call
(:func:`lead_watch`).  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=60)
    ap.add_argument("--seconds", type=float, default=0.0)
    a = ap.parse_args(argv)
    reps, seconds = a.reps, a.seconds
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import chip_smoke as cs
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import to_device
    from repro_torch.kernels import _build
    from repro_torch.launch import steps, train
    from repro_torch.models import zoo
    from repro_torch.optim import adamw
    if not torch.cuda.is_available():
        cs.fail("torch sees no CUDA device; this tool runs only on the GPU")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), torch.__version__, torch.version.cuda)
    _build.build_all()
    cs.stamp("build")
    args = train.parse_args(cs.LARGE_TRAINS[f"{cs.MIXTRAL} train"])
    s = train.setup(args, "cuda")
    model = zoo.build(s.cfg, s.ctx)
    step = steps.make_train_step(model, s.opt_cfg, args.accum)
    batch = to_device(s.source.batch_at(0), "cuda")
    traffic = train.init_traffic(s.cfg, s.ctx, args.accum)
    params, opt = s.params, adamw.init(s.params)
    step(params, opt, batch, traffic)
    torch.cuda.synchronize()
    value_and_grad = steps.value_and_grad(model)
    parts = {"forward+backward": lambda: value_and_grad(params, batch, traffic),
             "step": lambda: step(params, opt, batch, traffic)}
    cs.stamp("setup")

    def names(fn):
        wrappers = cs.zero_counters()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return ([e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA],
                wrappers["flash_attention"].launches)

    for part, fn in parts.items():
        traces = [names(fn) for _ in range(reps if part != "step"
                                           else max(1, reps // 3))]
        sizes = collections.Counter(len(t) for t, _ in traces)
        full = collections.Counter(max(traces, key=lambda t: len(t[0]))[0])
        lacking = [n for t, n in traces
                   if n and not any(cs.HOPPER_FLASH in x for x in t)]
        print(f"{part}: {len(traces)} traces, device records per trace "
              f"{dict(sizes)}; {len(lacking)} lack {cs.HOPPER_FLASH} while "
              "its counter says it ran")
        for t, _ in traces:
            if len(t) < sum(full.values()):
                gone = full - collections.Counter(t)
                print("  a short trace lacks " + ", ".join(
                    f"{cs.short_name(k, 60)} x{v}" for k, v in gone.items()))
        cs.stamp(part)

    if seconds:
        lead_watch(parts["forward+backward"], seconds, cs)


def lead_watch(fn, seconds: float, cs) -> None:
    """Traces ``fn`` until the process is ``seconds`` old, in turns with and
    without a host pause of ``TRACE_PAUSE_S`` between the trace's start and
    ``fn``; every 30 s prints per turn the traces, the short ones, and the
    least lead of a kernel's device start over its launch's host start (ms;
    a negative lead is a device clock read early against the host's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def lead(pause):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if pause:
                time.sleep(pause)
            fn()
            torch.cuda.synchronize()
        ev = prof.profiler.kineto_results.events()
        dev = [e for e in ev if e.device_type() == torch.autograd.DeviceType.CUDA]
        launch = {e.correlation_id(): e.start_ns() for e in ev
                  if e.device_type() != torch.autograd.DeviceType.CUDA
                  and "Launch" in e.name()}
        gaps = [(e.start_ns() - launch[e.correlation_id()]) / 1e6
                for e in dev if e.correlation_id() in launch]
        return len(dev), (min(gaps) if gaps else float("nan"))

    while time.perf_counter() - cs.T0 < seconds:
        window = {0.0: [], cs.TRACE_PAUSE_S: []}
        t = time.perf_counter()
        while time.perf_counter() - t < 30:
            for pause in window:
                window[pause].append(lead(pause))
        for pause, got in window.items():
            most = max(n for n, _ in got)
            print(f"  pause {pause * 1e3:.0f} ms: {len(got)} traces, "
                  f"{sum(n < most for n, _ in got)} short (most {most} "
                  f"records), least lead {min(g for _, g in got):.3f} ms")
        cs.stamp("a 30 s window")


if __name__ == "__main__":
    main()
