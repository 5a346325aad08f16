"""Runtime calibration of the pipe cost constants (port of
``repro/core/calibrate.py``).

The slice planner (:func:`pipesim.plan_slices` and the stream planners,
through ``dcomm.pipe_geometry``) runs off three constants on
:class:`dcomm.DcommConfig`:

    pipe_stage_bw    descriptor-interpreting staging copy (HBM-class)
    pipe_wire_bw     cross-device link (NVLink-class)
    pipe_overhead_s  per-slice setup (descriptor fetch + launch)

The defaults are the H100 SXM spec point.  :func:`calibrate` measures all
three on the running device with small timed probes, and :func:`apply`
threads them into a ``DcommConfig`` via ``dataclasses.replace``.

Probes (best of ``repeats`` after one warm-up call), timed by CUDA events on
the card and by ``time.perf_counter`` around the call on the CPU:

    stage_bw    a row gather over a ~4 MiB buffer, read + write counted; on
                the card ``QUEUED`` calls behind a device-side sleep, so the
                host has issued them all before the first event and the
                time is the copy's, not the launch path's
    wire_bw     a copy of the buffer to a second device when one exists
                (timed as the gather is); with one device the reference's
                stage_bw / 4, so the wire-slower-than-staging ordering the
                simulator assumes holds
    overhead_s  one launch of an empty kernel (a one-element fill) on an
                idle card, events around it: the host's launch path plus
                the launch, the dispatch latency every slice pays

Measured rates are clamped to positive finite bounds: a calibration that
produced 0, inf or nan would wedge the discrete-event simulator.
"""

from __future__ import annotations

import dataclasses
import time

import torch

_MIN_BW = 1e6           # 1 MB/s — below this the timer, not the copy, is wrong
_MAX_BW = 1e16
_MIN_OVH = 1e-9
_MAX_OVH = 1e-1
QUEUED = 20                  # calls a bandwidth probe times behind the sleep
_SLEEP_CYCLES = 20_000_000   # ~10 ms of device sleep: the host issues them


@dataclasses.dataclass(frozen=True)
class CalibrationTable:
    """Measured pipe constants for the running device."""
    stage_bw: float          # bytes/s
    wire_bw: float           # bytes/s
    overhead_s: float        # seconds per launch
    platform: str = "unknown"
    payload_bytes: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _clamp(x: float, lo: float, hi: float) -> float:
    if not (x == x) or x <= 0:      # nan or nonpositive -> floor
        return lo
    return min(max(x, lo), hi)


def _timeit(fn, repeats: int, device: torch.device,
            queued: int = 1) -> float:
    """Best-of-N seconds of one ``fn()`` after a warm-up call.  On the card,
    CUDA events around ``queued`` calls, divided by ``queued``; with
    ``queued > 1`` the calls wait behind a device-side sleep, which times
    the device's work alone.  On the CPU, the host clock around one call."""
    fn()
    best = float("inf")
    for _ in range(repeats):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            if queued > 1:
                torch.cuda._sleep(_SLEEP_CYCLES)
            start.record()
            for _ in range(queued):
                fn()
            end.record()
            end.synchronize()
            t = start.elapsed_time(end) / 1e3 / queued
        else:
            t0 = time.perf_counter()
            fn()
            t = time.perf_counter() - t0
        best = min(best, t)
    return max(best, 1e-9)


def calibrate(payload_bytes: int = 1 << 22, repeats: int = 5,
              device="cuda") -> CalibrationTable:
    """Measure stage/wire/overhead on ``device`` (the card unless the
    caller asks for the CPU; raises if it asks for a card that is not
    there)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("calibrate: device 'cuda' asked for, but torch "
                               "sees no CUDA device")
        device = torch.device("cuda", torch.cuda.current_device()
                              if device.index is None else device.index)
    n = max(1, payload_bytes // 4)               # f32 elements
    d = 128
    rows = max(1, n // d)
    x = torch.ones((rows, d), dtype=torch.float32, device=device)
    idx = torch.arange(rows - 1, -1, -1, device=device)
    actual_bytes = rows * d * 4

    t_stage = _timeit(lambda: torch.index_select(x, 0, idx), repeats, device,
                      QUEUED)
    stage_bw = 2.0 * actual_bytes / t_stage      # read + write

    if device.type == "cuda" and torch.cuda.device_count() > 1:
        peer = torch.device("cuda", (device.index + 1) % torch.cuda.device_count())
        dst = torch.empty_like(x, device=peer)
        t_wire = _timeit(lambda: dst.copy_(x, non_blocking=True), repeats,
                         device, QUEUED)
        wire_bw = actual_bytes / t_wire
    else:
        wire_bw = stage_bw / 4.0                 # keep wire < stage ordering

    one = torch.empty(1, device=device)
    overhead = _timeit(lambda: one.fill_(0.0), repeats, device)

    return CalibrationTable(
        stage_bw=_clamp(stage_bw, _MIN_BW, _MAX_BW),
        wire_bw=_clamp(wire_bw, _MIN_BW, _MAX_BW),
        overhead_s=_clamp(overhead, _MIN_OVH, _MAX_OVH),
        platform=(torch.cuda.get_device_name(device) if device.type == "cuda"
                  else "cpu"),
        payload_bytes=actual_bytes,
    )


def apply(table: CalibrationTable, cfg):
    """Return ``cfg`` (a DcommConfig) with the measured pipe constants;
    ``dcomm.pipe_geometry`` builds ``pipesim.PipeParams`` from them."""
    return dataclasses.replace(cfg,
                               pipe_stage_bw=table.stage_bw,
                               pipe_wire_bw=table.wire_bw,
                               pipe_overhead_s=table.overhead_s)
