"""Discrete-event model of the dComm slice pipeline (paper §3.2, Fig. 5):
the port's copy of ``repro/core/pipesim.py``.

The paper's engine streams a transfer as *slices*: the producer interprets
segment descriptors and stages each slice into the ring buffer; the
consumer (the wire) streams completed slices.  Two claims it verifies
quantitatively:

  1. slices amortise per-transfer setup: too-small slices are overhead-bound;
  2. when wire time per slice ≥ staging time, staging is fully hidden —
     total ≈ setup + first-slice staging + wire time.

The ``fused_pipe`` engine (``dcomm.pipe_*``) calls :func:`plan_slices` to
choose how many capacity-axis slices to stream a shuffle as, and the
attention-separated ``moe_tx`` stream calls :func:`plan_tx_stream` for one
joint slice count.  :func:`simulate_interleaved_stream` additionally models
the *boundary bubble*: the compute idle while a layer's deferred tail
combine is on the wire, which micro-batch interleaving fills and a K=1
chain cannot.

Every planning function is the reference's, line for line
(``tests/test_torch_pipesim.py`` pins them equal).  Only the defaults of
:class:`PipeParams` differ: they are the NVIDIA H100 80GB HBM3's point in
place of the reference's TPU v5e one.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PipeParams:
    payload_bytes: float
    # spec-sheet values for the NVIDIA H100 80GB HBM3 (SXM), until
    # ``core.calibrate`` measures them on the running card
    stage_bw: float = 3.35e12        # descriptor-interpreting copy (HBM3)
    wire_bw: float = 450e9           # NVLink 4, per direction
    per_slice_overhead_s: float = 2e-6   # descriptor fetch + launch
    ring_slots: int = 2              # double buffering


def params_from_dcomm(payload_bytes: float, cfg) -> PipeParams:
    """PipeParams at a DcommConfig's hardware point: the H100 spec-sheet
    defaults, or whatever ``core.calibrate`` measured on the running card."""
    return PipeParams(payload_bytes=float(payload_bytes),
                      stage_bw=cfg.pipe_stage_bw,
                      wire_bw=cfg.pipe_wire_bw,
                      per_slice_overhead_s=cfg.pipe_overhead_s)


def simulate(p: PipeParams, slice_bytes: float) -> dict:
    """Event-driven simulation of producer/consumer over a bounded ring."""
    n = max(1, int(-(-p.payload_bytes // slice_bytes)))
    stage_t = slice_bytes / p.stage_bw + p.per_slice_overhead_s
    wire_t = slice_bytes / p.wire_bw

    # producer can run at most `ring_slots` slices ahead of the consumer
    stage_done = [0.0] * n
    wire_done = [0.0] * n
    t_prod = 0.0
    for i in range(n):
        if i >= p.ring_slots:
            # wait for the slot to free (consumer finished slice i - slots)
            t_prod = max(t_prod, wire_done[i - p.ring_slots])
        t_prod += stage_t
        stage_done[i] = t_prod
    t_cons = 0.0
    for i in range(n):
        t_cons = max(t_cons, stage_done[i]) + wire_t
        wire_done[i] = t_cons

    total = wire_done[-1]
    unpipelined = n * stage_t + n * wire_t
    lower_bound = p.payload_bytes / p.wire_bw     # wire is the floor
    return {
        "n_slices": n,
        "total_s": total,
        "unpipelined_s": unpipelined,
        "speedup": unpipelined / total,
        "wire_bound_s": lower_bound,
        "efficiency": lower_bound / total,        # 1.0 = staging fully hidden
    }


def sweep(p: PipeParams, slice_sizes) -> list[dict]:
    out = []
    for s in slice_sizes:
        r = simulate(p, s)
        r["slice_bytes"] = s
        out.append(r)
    return out


def _geometric_sizes(lo: float = 4096, hi: float = 2 ** 26) -> list[float]:
    sizes = []
    s = lo
    while s <= hi:
        sizes.append(s)
        s *= 2
    return sizes


def _knee(results: list[dict]) -> dict:
    """Max efficiency, smallest slice on ties."""
    return max(results,
               key=lambda r: (round(r["efficiency"], 4), -r["slice_bytes"]))


def _with_slice_count(p: PipeParams, best: dict,
                      max_slices: int | None) -> dict:
    """Convert a knee slice size into the slice *count* a statically-shaped
    engine needs; returns a copy of ``best`` extended with ``n_slices``."""
    n = max(1, int(-(-p.payload_bytes // best["slice_bytes"])))
    if max_slices is not None:
        n = min(n, max_slices)
    b = dict(best)
    b["n_slices"] = n
    return b


def best_slice(p: PipeParams, lo: float = 4096, hi: float = 2 ** 26) -> dict:
    """Geometric sweep → the knee (max efficiency, smallest slice on ties)."""
    return _knee(sweep(p, _geometric_sizes(lo, hi)))


def plan_slices(p: PipeParams, payload_bytes: float | None = None,
                max_slices: int | None = None) -> dict:
    """Slice plan for a concrete payload: how many slices to stream it as.

    Runs :func:`best_slice` at ``p``'s hardware point (overriding
    ``payload_bytes`` when given) and converts the knee slice size into a
    slice *count*, which is what a statically-shaped engine needs.  Returns
    the ``best_slice`` result dict extended with ``n_slices``.
    """
    if payload_bytes is not None:
        p = dataclasses.replace(p, payload_bytes=float(payload_bytes))
    return _with_slice_count(p, best_slice(p), max_slices)


# ---------------------------------------------------------------------------
# Cross-layer stream (MegaScale-MoE-style: combine of layer i overlaps
# dispatch of layer i+1)
# ---------------------------------------------------------------------------

def simulate_layer_stream(p: PipeParams, slice_bytes: float,
                          n_layers: int) -> dict:
    """Model a chain of ``n_layers`` identical shuffles streamed back to back.

    The per-layer pipeline is :func:`simulate`.  A *barriered* chain pays the
    full per-layer total at every layer.  The *streamed* chain keeps the tail
    slice of layer i's combine on the wire across the layer boundary, hiding
    up to the smaller of (tail wire time, head staging time) per boundary.
    This is the BEST-CASE window of the structure the cross-layer engine
    exposes (``dcomm.pipe_shuffle_ffn_stream`` deferring the tail scatter-add
    into the next layer's prologue): realising it requires tail-independent
    work co-scheduled at the boundary.  A pure serial MoE chain has none;
    interleaved token micro-batches do (now landed —
    ``fusco.interleaved_layer_stream``, modelled with its schedule-level
    bubble accounting by :func:`simulate_interleaved_stream`), and
    inter-layer attention would too (still open, ROADMAP.md).
    """
    per = simulate(p, slice_bytes)
    stage_t = slice_bytes / p.stage_bw + p.per_slice_overhead_s
    wire_t = slice_bytes / p.wire_bw
    overlap = min(stage_t, wire_t)
    barriered = n_layers * per["total_s"]
    streamed = barriered - (n_layers - 1) * overlap
    wire_floor = n_layers * per["wire_bound_s"]
    return {
        "n_layers": n_layers,
        "n_slices": per["n_slices"],
        "slice_bytes": slice_bytes,
        "per_layer_s": per["total_s"],
        "barriered_s": barriered,
        "total_s": streamed,
        "overlap_per_boundary_s": overlap,
        "speedup_vs_barriered": barriered / streamed,
        "efficiency": wire_floor / streamed,
    }


def plan_layer_stream(p: PipeParams, n_layers: int,
                      payload_bytes: float | None = None,
                      max_slices: int | None = None) -> dict:
    """Joint slice plan for a chain of layers: one slice count for all.

    The cross-layer engine needs a single static slice count shared by every
    layer in the stream (the deferred tail slice of layer i must have the
    same shape as layer i+1's slices).  Sweeps slice sizes and picks the knee
    of *streamed* efficiency — which can differ from the per-shuffle knee of
    :func:`plan_slices` because larger slices widen the per-boundary overlap
    window while smaller ones pipeline better within a layer.
    """
    if payload_bytes is not None:
        p = dataclasses.replace(p, payload_bytes=float(payload_bytes))
    best = _knee([simulate_layer_stream(p, sz, n_layers)
                  for sz in _geometric_sizes()])
    return _with_slice_count(p, best, max_slices)


# ---------------------------------------------------------------------------
# Micro-batch interleaved stream (K micro-batches round-robin through one
# chained schedule: lane j+1's compute fills lane j's boundary window)
# ---------------------------------------------------------------------------

def simulate_interleaved_stream(p: PipeParams, n_slices: int, n_layers: int,
                                interleave: int = 1) -> dict:
    """Event model of the micro-batch interleaved cross-layer stream.

    Models the schedule ``fusco.interleaved_layer_stream`` runs: the token
    batch is split into ``interleave`` micro-batch lanes of
    ``payload_bytes / interleave`` per layer each, issued round-robin through
    ONE chained schedule — per layer, lane j's shuffle (``n_slices`` staged +
    exchanged slices, tail combine exchange issued) is followed by lane
    j+1's shuffle, and lane j's deferred tail lands only when lane j reaches
    the next layer.  Two serially reused resources: *compute* (descriptor
    gather + grouped FFN staging) and *wire*.  Lane j's first stage op of
    layer l+1 (its router) must wait for lane j's layer-l tail; every OTHER
    lane's compute is tail-independent and can fill that window.  With
    ``interleave=1`` this IS the chained schedule of the plain layer stream,
    whose boundary window holds no independent work (the pure-MoE-chain
    bubble): comparing K>=2 against K=1 *at equal slice counts* quantifies
    exactly what interleaving buys.

    Reported bubbles:

      * ``bubble_fraction`` — total compute idle / makespan (includes
        in-pipeline ring stalls, which exist at any K);
      * ``boundary_bubble_fraction`` — compute idle attributable
        specifically to waiting on a deferred tail (the ``s==0`` router
        stall) plus the final tail drain, / makespan.  This is the boundary
        window itself; interleaving shrinks it, slicing alone cannot.

    Per-lane slices are ``payload/(K*n_slices)`` bytes, so K>1 pays more
    per-slice overhead for the same bytes — the model is honest about the
    trade the engine makes.
    """
    k = max(1, int(interleave))
    n = max(1, int(n_slices))
    slice_bytes = p.payload_bytes / (k * n)
    stage_t = slice_bytes / p.stage_bw + p.per_slice_overhead_s
    wire_t = slice_bytes / p.wire_bw

    t_comp = 0.0                       # compute resource frontier
    t_wire = 0.0                       # wire resource frontier
    tail_done = [0.0] * k              # per-lane: previous layer's tail landed
    boundary_stall = 0.0
    for _layer in range(n_layers):
        for j in range(k):
            wire_done = [0.0] * n
            for s in range(n):
                start = t_comp
                if s == 0:             # router reads the completed h: wait
                    start = max(start, tail_done[j])
                    boundary_stall += start - t_comp
                if s >= p.ring_slots:  # bounded ring, as in simulate()
                    start = max(start, wire_done[s - p.ring_slots])
                t_comp = start + stage_t
                t_wire = max(t_wire, t_comp) + wire_t      # dispatch exchange
                wire_done[s] = t_wire
            t_wire = max(t_wire, t_comp) + wire_t          # tail combine
            tail_done[j] = t_wire
    makespan = max(t_comp, max(tail_done))
    boundary_stall += makespan - t_comp                    # final tail drain
    busy = n_layers * k * n * stage_t
    out = {
        "n_layers": n_layers,
        "interleave": k,
        "n_slices": n,
        "slice_bytes": slice_bytes,
        "total_s": makespan,
        "compute_busy_s": busy,
        "bubble_fraction": (makespan - busy) / makespan,
        "boundary_stall_s": boundary_stall,
        "boundary_bubble_fraction": boundary_stall / makespan,
        "wire_bound_s": n_layers * p.payload_bytes / p.wire_bw,
        "efficiency": (n_layers * p.payload_bytes / p.wire_bw) / makespan,
    }
    if k > 1:
        chained = simulate_interleaved_stream(p, n, n_layers, 1)
        out["speedup_vs_chained"] = chained["total_s"] / makespan
        out["boundary_bubble_reduction"] = (
            chained["boundary_bubble_fraction"] - out["boundary_bubble_fraction"])
    return out


# ---------------------------------------------------------------------------
# Attention-separated stream (moe_tx: parallel attention+MoE transformer
# blocks — the attention block is tail-independent compute scheduled between
# a layer's tail combine issue and its consume at the next layer)
# ---------------------------------------------------------------------------

def simulate_tx_stream(p: PipeParams, n_slices: int, n_layers: int,
                       attn_s: float, interleave: int = 1) -> dict:
    """Event model of the attention-separated cross-layer stream.

    Models the schedule ``fusco.tx_layer_stream`` runs over ``n_layers``
    *parallel* attention+MoE transformer blocks: per layer (per micro-batch
    lane when interleaved), the MoE shuffle is issued FIRST (``n_slices``
    staged + exchanged slices, tail combine exchange issued), then the
    attention block — ``attn_s`` seconds of compute that reads the block
    *input* and is therefore independent of the in-flight tail — runs while
    the tail is on the wire; the tail lands only in that lane's next-layer
    prologue.  This is exactly what a pure MoE chain lacks: with
    ``attn_s == 0`` and ``interleave == 1`` this IS
    :func:`simulate_interleaved_stream`'s chained K=1 schedule, so comparing
    ``attn_s > 0`` against it at equal slice counts quantifies what the
    attention window-filler buys.  Composes with ``interleave``: lane j+1's
    whole block (shuffle staging + attention) also sits in lane j's window.

    Reported bubbles as in :func:`simulate_interleaved_stream`:
    ``bubble_fraction`` (total compute idle / makespan) and
    ``boundary_bubble_fraction`` (idle attributable to waiting on a deferred
    tail + the final tail drain).  Attention counts as compute busy time.
    """
    k = max(1, int(interleave))
    n = max(1, int(n_slices))
    a = max(0.0, float(attn_s))
    slice_bytes = p.payload_bytes / (k * n)
    stage_t = slice_bytes / p.stage_bw + p.per_slice_overhead_s
    wire_t = slice_bytes / p.wire_bw

    t_comp = 0.0
    t_wire = 0.0
    tail_done = [0.0] * k
    boundary_stall = 0.0
    for _layer in range(n_layers):
        for j in range(k):
            wire_done = [0.0] * n
            for s in range(n):
                start = t_comp
                if s == 0:             # router reads the completed h: wait
                    start = max(start, tail_done[j])
                    boundary_stall += start - t_comp
                if s >= p.ring_slots:  # bounded ring, as in simulate()
                    start = max(start, wire_done[s - p.ring_slots])
                t_comp = start + stage_t
                t_wire = max(t_wire, t_comp) + wire_t      # dispatch exchange
                wire_done[s] = t_wire
            t_wire = max(t_wire, t_comp) + wire_t          # tail combine
            tail_done[j] = t_wire
            t_comp += a          # attention: tail-independent window filler
    makespan = max(t_comp, max(tail_done))
    boundary_stall += makespan - t_comp                    # final tail drain
    busy = n_layers * k * (n * stage_t + a)
    out = {
        "n_layers": n_layers,
        "interleave": k,
        "n_slices": n,
        "attn_s": a,
        "slice_bytes": slice_bytes,
        "total_s": makespan,
        "compute_busy_s": busy,
        "bubble_fraction": (makespan - busy) / makespan,
        "boundary_stall_s": boundary_stall,
        "boundary_bubble_fraction": boundary_stall / makespan,
        "wire_bound_s": n_layers * p.payload_bytes / p.wire_bw,
        "efficiency": (n_layers * p.payload_bytes / p.wire_bw) / makespan,
    }
    if a > 0 or k > 1:
        pure = simulate_interleaved_stream(p, n, n_layers, 1)
        out["pure_chained_boundary_bubble_fraction"] = (
            pure["boundary_bubble_fraction"])
        out["boundary_bubble_reduction_vs_pure_chained"] = (
            pure["boundary_bubble_fraction"] - out["boundary_bubble_fraction"])
    return out


def _makespan_knee(p: PipeParams, simulate_fn,
                   payload_bytes: float | None, max_slices: int | None) -> dict:
    """Shared slice-count sweep for the statically-shaped stream planners:
    power-of-two counts, makespan knee, smallest count on ties."""
    if payload_bytes is not None:
        p = dataclasses.replace(p, payload_bytes=float(payload_bytes))
    counts = [1 << i for i in range(11)]
    if max_slices is not None:
        counts = [n for n in counts if n <= max_slices] or [1]
    return min((simulate_fn(p, n) for n in counts),
               key=lambda r: (round(r["total_s"], 12), r["n_slices"]))


def plan_tx_stream(p: PipeParams, n_layers: int, interleave: int,
                   attn_s: float, payload_bytes: float | None = None,
                   max_slices: int | None = None) -> dict:
    """Joint slice plan for the attention-separated stream: ONE static slice
    count shared by every (layer, micro-batch lane) shuffle of the tx chain.

    ``payload_bytes`` is the FULL per-layer MoE payload (all K lanes); each
    lane stages ``payload/K``.  Sweeps slice counts and picks the makespan
    knee — attention widens the window a deferred tail can hide in, which can
    move the knee relative to :func:`plan_interleaved_stream`'s pure-MoE pick.
    """
    return _makespan_knee(
        p, lambda pp, n: simulate_tx_stream(pp, n, n_layers, attn_s,
                                            interleave),
        payload_bytes, max_slices)


def plan_interleaved_stream(p: PipeParams, n_layers: int, interleave: int,
                            payload_bytes: float | None = None,
                            max_slices: int | None = None) -> dict:
    """Joint slice plan for the interleaved stream: ONE static slice count
    shared by every (layer, micro-batch lane) shuffle.

    ``payload_bytes`` is the FULL per-layer payload (all K micro-batches);
    each lane stages ``payload/K``.  Sweeps slice *counts* directly (the
    statically-shaped engine's knob) and picks the makespan knee — more
    slices pipeline better within a lane but pay K× the per-slice overhead.
    """
    return _makespan_knee(
        p, lambda pp, n: simulate_interleaved_stream(pp, n, n_layers,
                                                     interleave),
        payload_bytes, max_slices)
