"""Serving engines: continuous per-slot batching and the waved compatibility
mode, over the zoo's prefill and decode steps (port of
``repro/serving/engine.py``).

Two admission disciplines share one base (queue, prompt-length buckets,
prepared callables, traffic statistics, metrics):

  * :class:`ContinuousServingEngine`, the production path.  A fixed pool of
    ``max_batch`` decode slots with per-row lengths in the ``DecodeState``
    (``models/lm.decode_step`` RoPE-rotates, writes its cache and masks each
    row at its own position).  A queued request is prefilled at a bucketed
    prompt length and inserted into a free slot while the other slots keep
    decoding; a slot retires on eos or ``max_new`` and is refilled on the
    next step.
  * :class:`ServingEngine`, the waved engine: pending requests are padded to
    a common bucketed prompt length, prefilled as one batch and decoded
    lock-step until every member finishes.

For a moe_ffn or moe_tx bundle whose ``ModelContext.moe_interleave`` is K,
prefill rows ARE the micro-batch lanes of the interleaved stream (with the
``fused_pipe`` engine; the barriers ignore the lanes).  Over a (data,
model) grid of D data ranks (the bundle's context built on a
``launch.mesh.HostMesh``) the batch rows split over the data group in
blocks (``models/lm.data_rows``), so a prefill's rows come in multiples of
``_wave_mult`` = K x D, as the reference's (engine.py:143-151): the waved
engine pads each wave with pad rows up to that multiple, masked out of the
results and the traffic, and the continuous engine admits K x D rows a
call (``admit_chunk``), drawn from the queue, each data rank prefilling
its K.

The reference compiles one AOT executable per shape.  Here the counterpart
is a prepared callable per shape: one per (rows, bucket) prefill, one for
the pool decode and one for the slot insert (``get_prefill``,
``get_decode``, ``_get_insert``; ``warmup`` builds them all).  Building one
runs it once, untimed, on a scratch input of its shape, which builds the
kernels, fills the per-shape caches (``dcomm.pipe_geometry``) and warms the
GEMM libraries, so no TTFT holds first-shape work; the build touches
neither the pool nor the traffic state.  ``compile_count`` and
``compile_s`` count them as the reference counts its executables, and after
``warmup`` ``compile_count`` stays flat under any admission pattern whose
prompts fit the buckets.

The pool is fixed tensors that the decode and the insert write in place,
with the lengths on the device.  The host reads the card once per decode
step (the argmax) and once per admission (the prefill's argmax, with
``track_traffic`` the admission's expert counts in the same read), as the
reference's ``np.asarray``, and nowhere inside a prefill, decode or
insert; the tokens go to the card from pinned memory without waiting.
Over a data group each of those reads is of the argmax all-gathered over
it first (one ``all_gather_into_tensor`` of a few ints beside each read),
so every rank holds every row's token and makes the same retire and refill
decisions; with gloo, which stages a card's tensors through the host, that
collective waits on the card too.

The continuous engine's slot pool splits over the data group in blocks:
slot i lives on data rank i // (max_batch / D), which decodes it.  The
admission keeps the reference's slot choice (chunk row j to the j-th free
slot), so row j, prefilled on data rank j // K, may land on another rank's
slot: the insert all-gathers the chunk's KV caches over the data group
(one ``all_gather_into_tensor``), and each rank copies the rows of the
slots it holds.

Metrics: TTFT per request (p50/p95/p99 in ``stats()``), decode tok/s, slot
occupancy and, for MoE models with ``track_traffic=True``, per-admission
expert-load statistics: the prefill threads the layer-stacked
``traffic.TrafficState`` through the MoE layers, and each admission's raw
counts are reported as max/mean lane load and hot-expert share.  Every
prefill passes a (rows, S) pad mask (False on left-pad positions), so
pad positions are routed but not counted.

Over an EP group or a grid every rank runs the same engine loop with the
same queue, so every rank makes the same decisions and meets every
collective of the prefill and decode at the same point.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import commplan, dcomm, relayout
from repro_torch.core import traffic as traffic_lib
from repro_torch.models import lm
from repro_torch.models.zoo import EMBED_INPUTS

def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without making the host wait: through
    pinned memory and an asynchronous copy on the card."""
    t = torch.from_numpy(np.array(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (S,) int
    max_new: int
    submitted_at: float = 0.0
    ttft_s: Optional[float] = None
    output: list = dataclasses.field(default_factory=list)
    done: bool = False


def default_buckets(max_len: int, lo: int = 16,
                    multiple: int = 1) -> tuple[int, ...]:
    """Powers of two from ``lo`` up to (and always including) ``max_len``;
    with ``multiple`` (a power of two: the SSD chunk of the ssm and hybrid
    families, whose prefill lengths must be its multiples) the powers from
    ``max(lo, multiple)``, and ``max_len`` cut down to a multiple."""
    lo, top = max(lo, multiple), max_len - max_len % multiple
    out, b = [], lo
    while b < top:
        out.append(b)
        b *= 2
    out.append(top)
    return tuple(out)


class _ServingBase:
    """Shared machinery: queue, buckets, prepared callables, traffic, stats."""

    def __init__(self, bundle, *, max_batch: int = 8, max_len: int = 256,
                 eos_id: int | None = None, pad_id: int = 0,
                 track_traffic: bool = False,
                 buckets: tuple[int, ...] | None = None):
        # the reference's continuous engine refuses encdec here
        # (engine.py:414-416); its engines fail at the first prefill of
        # either family; ``launch/serve.py`` serves both lock-step
        family = bundle.cfg.family
        if family in EMBED_INPUTS:
            raise ValueError(f"the serving engines take token prompts; the "
                             f"{family} family's prefill takes "
                             f"{EMBED_INPUTS[family]}")
        self.bundle = bundle
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.pad_id = pad_id
        mult = lm.seq_multiple(bundle.cfg)
        self.buckets = tuple(sorted(buckets)) if buckets else \
            default_buckets(max_len, multiple=mult)
        if any(b % mult for b in self.buckets):
            raise ValueError(f"buckets {self.buckets}: a {bundle.cfg.family} "
                             f"model prefills multiples of {mult} tokens")
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []
        self.wave_loads: list[dict] = []     # one entry per wave / admission
        self._next_id = 0
        # every prepared callable is counted and its build timed here,
        # never inside a request's TTFT
        self.compile_count = 0
        self.compile_s = 0.0
        self._prefill_exec: dict = {}        # (rows, s) -> callable
        self._decode_exec: dict = {}         # (rows, per_slot) -> callable
        # the micro-batch lanes a data rank's prefill rows split into: a
        # moe_ffn or moe_tx stream's K, whatever the engine; the rows of a
        # prefill come in multiples of K x the data ranks (the reference's
        # engine.py:143-151)
        ctx = bundle.ctx
        self.interleave = (ctx.moe_interleave
                           if ctx.cfg.family in ("moe_ffn", "moe_tx") else 1)
        self._wave_mult = self.interleave * lm.data_size(ctx)
        self.traffic = None
        if track_traffic:
            ctx = bundle.ctx
            if ctx.cfg.moe is None:
                raise ValueError(
                    "track_traffic requires a bundle with MoE layers, got "
                    f"the {ctx.cfg.family!r} family")
            self.traffic = traffic_lib.init_traffic_state(
                ctx.cfg.moe.n_experts, ctx.placement.ep,
                n_layers=ctx.cfg.n_layers, device=ctx.device)

    @property
    def device(self) -> torch.device:
        return self.bundle.ctx.device

    # ------------------------------------------------------------- queue ----

    def submit(self, prompt: np.ndarray, max_new: int = 16) -> int:
        prompt = np.asarray(prompt, np.int64)
        if len(prompt) > self.buckets[-1]:
            raise ValueError(f"prompt length {len(prompt)} exceeds the "
                             f"largest bucket {self.buckets[-1]}")
        rid = self._next_id
        self._next_id += 1
        self.queue.append(Request(rid, prompt, max_new,
                                  submitted_at=time.perf_counter()))
        return rid

    def bucket_of(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds bucket {self.buckets[-1]}")

    def _padded(self, reqs: list[Request], rows: int, s: int):
        """(rows, s) left-padded tokens and the pad mask on the card."""
        toks = np.full((rows, s), self.pad_id, np.int64)
        valid = np.zeros((rows, s), bool)    # False: left-pad slot / pad row
        for i, r in enumerate(reqs):
            toks[i, s - len(r.prompt):] = r.prompt
            valid[i, s - len(r.prompt):] = True
        return _to_device(toks, self.device), _to_device(valid, self.device)

    # --------------------------------------------------- prepared callables -

    def _build(self, fn, *scratch) -> None:
        """Run a new callable once on scratch inputs, untimed by any request,
        and count it."""
        t0 = time.perf_counter()
        with torch.inference_mode():
            fn(*scratch)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.compile_count += 1
        self.compile_s += time.perf_counter() - t0

    def _fresh_traffic(self):
        ctx = self.bundle.ctx
        return traffic_lib.init_traffic_state(
            ctx.cfg.moe.n_experts, ctx.placement.ep, n_layers=ctx.cfg.n_layers,
            device=self.device)

    def _prefill_callable(self) -> Callable:
        # the callables hold the bundle, not the engine: an engine that
        # held itself through its callables would live, with its model's
        # process groups, until a garbage collection, which may come only
        # at interpreter exit, after the groups were destroyed
        bundle, max_len = self.bundle, self.max_len
        if self.traffic is not None:
            return lambda p, toks, tr, m: bundle.prefill(
                p, {"tokens": toks}, max_len, traffic=tr, traffic_mask=m)
        return lambda p, toks: bundle.prefill(p, {"tokens": toks}, max_len)

    def get_prefill(self, params, rows: int, s: int):
        """The prefill callable of a (rows x bucket-s) token batch; built on
        first request for the shape (or by ``warmup``) on a scratch batch of
        pad tokens and a throwaway traffic state."""
        key = (rows, s)
        exe = self._prefill_exec.get(key)
        if exe is None:
            exe = self._prefill_callable()
            toks = torch.full((rows, s), self.pad_id, dtype=torch.int64,
                              device=self.device)
            extra = ()
            if self.traffic is not None:
                extra = (self._fresh_traffic(),
                         torch.ones((rows, s), dtype=torch.bool,
                                    device=self.device))
            self._build(exe, params, toks, *extra)
            self._prefill_exec[key] = exe
        return exe

    def get_decode(self, params, state: lm.DecodeState, rows: int):
        """The one-token decode callable of a state of ``rows`` global rows
        (this rank's of them on a grid; per-row lengths or one for all, as
        ``state``'s); built on a scratch state of that layout, so ``state``
        is not touched."""
        return self._get_decode(params, rows, state.length.dim() == 1)

    def _get_decode(self, params, rows: int, per_slot: bool):
        key = (rows, per_slot)
        exe = self._decode_exec.get(key)
        if exe is None:
            bundle, max_len = self.bundle, self.max_len
            exe = lambda p, st, t: bundle.decode_step(p, st, t, max_len)
            ctx = self.bundle.ctx
            scratch = lm.init_decode_state(ctx.cfg, rows, self.max_len,
                                           ctx.compute_dtype, ctx,
                                           per_slot=per_slot)
            mine = lm.data_rows(ctx, rows)
            toks = torch.full((mine.stop - mine.start,), self.pad_id,
                              dtype=torch.int64, device=self.device)
            self._build(exe, params, scratch, toks)
            self._decode_exec[key] = exe
        return exe

    # ---------------------------------------------------- traffic + stats ---

    def _prefill_and_read(self, exe, params, toks, valid):
        """Run a prefill of the global (rows, s) batch and read its argmax
        to the host (every data rank's rows, gathered first), with traffic
        the admission's counts summed over the layers in the same read.
        Returns (the first token of every row, this rank's new state)."""
        rows, ctx = toks.shape[0], self.bundle.ctx
        if self.traffic is not None:
            logits, state, self.traffic = exe(params, toks, self.traffic, valid)
            read = torch.cat([lm.gather_rows(logits.argmax(-1), ctx),
                              self.traffic.last_expert_count.sum(0).long()])
        else:
            logits, state = exe(params, toks)
            read = lm.gather_rows(logits.argmax(-1), ctx)
        host = read.cpu().numpy()            # the admission's one host read
        if self.traffic is not None:
            self._record_load(host[rows:])
        return host[:rows], state

    def _record_load(self, counts: np.ndarray):
        """Per-admission (continuous) / per-wave (waved) expert-load snapshot
        from the raw (non-EMA) counts of the prefill, summed over layers."""
        counts = counts.astype(np.float32)
        lanes = relayout.lane_loads(counts, self.bundle.ctx.placement)
        tot = max(float(counts.sum()), 1e-9)
        self.wave_loads.append({
            "expert_tokens": counts,
            "max_lane_load": float(lanes.max()),
            "mean_lane_load": float(lanes.mean()),
            "lane_imbalance": float(lanes.max() / max(lanes.mean(), 1e-9)),
            "top_expert_share": float(counts.max() / tot),
        })

    def stats(self) -> dict:
        done = [r for r in self.finished if r.ttft_s is not None]
        if not done:
            return {}
        ttfts = [r.ttft_s for r in done]
        out = {
            "requests": len(done),
            "mean_ttft_s": float(np.mean(ttfts)),
            "p50_ttft_s": float(np.percentile(ttfts, 50)),
            "p95_ttft_s": float(np.percentile(ttfts, 95)),
            "p99_ttft_s": float(np.percentile(ttfts, 99)),
            "mean_tokens": float(np.mean([len(r.output) for r in done])),
            "compile_s": self.compile_s,
            "compile_count": self.compile_count,
        }
        if self.wave_loads:
            out["waves"] = len(self.wave_loads)
            out["mean_lane_imbalance"] = float(
                np.mean([w["lane_imbalance"] for w in self.wave_loads]))
            out["max_lane_imbalance"] = float(
                np.max([w["lane_imbalance"] for w in self.wave_loads]))
            out["mean_top_expert_share"] = float(
                np.mean([w["top_expert_share"] for w in self.wave_loads]))
        if self.traffic is not None:
            ctx = self.bundle.ctx
            host = traffic_lib.TrafficState(
                *(leaf.cpu().numpy() for leaf in self.traffic))
            itemsize = torch.finfo(ctx.compute_dtype).bits // 8
            decisions = commplan.plan_paths(
                host, ctx.placement, row_bytes=ctx.cfg.d_model * itemsize,
                costs=commplan.LinkCosts.from_dcomm(ctx.dcfg),
                dedup=ctx.dcfg.dedup, default=ctx.dcfg.engine)
            out["comm_path"] = commplan.summarize_decisions(decisions)
            out["comm_path"]["dedup"] = commplan.dedup_savings(
                host, ctx.placement)
        return out


class ServingEngine(_ServingBase):
    """Waved (lock-step) admission, the compatibility mode.

    ``run_wave`` drains up to ``max_batch`` queued requests, pads them to a
    common bucketed prompt length and with pad rows up to a multiple of the
    interleave lanes x data ranks, prefills them as one batch (each data
    rank its block of rows) and decodes lock-step until every member
    finishes, each step's tokens gathered over the data group.
    """

    def _rows(self, n: int) -> int:
        """The prefill rows of a wave of ``n`` requests: ``n`` padded up to
        a multiple of the interleave lanes x data ranks."""
        return -(-n // self._wave_mult) * self._wave_mult

    def warmup(self, params) -> float:
        """Build the full-wave prefill callable per bucket and the decode
        step; returns the seconds spent.  Smaller waves build theirs on first
        occurrence (also outside TTFT)."""
        t0 = time.perf_counter()
        rows = self._rows(self.max_batch)
        for s in self.buckets:
            self.get_prefill(params, rows, s)
        self._get_decode(params, rows, per_slot=False)
        return time.perf_counter() - t0

    def _form_wave(self) -> list[Request]:
        wave = []
        while self.queue and len(wave) < self.max_batch:
            wave.append(self.queue.popleft())
        return wave

    def run_wave(self, params) -> list[Request]:
        """Prefill + decode one wave to completion.  Returns finished reqs."""
        wave = self._form_wave()
        if not wave:
            return []
        s = self.bucket_of(max(len(r.prompt) for r in wave))
        # pad rows (all pad tokens, masked out of the traffic) fill the
        # last lane; their tokens are decoded and dropped
        bp = self._rows(len(wave))
        # fetch (and if needed build) the callables BEFORE the timed region
        exe = self.get_prefill(params, bp, s)
        with torch.inference_mode():
            toks, valid = self._padded(wave, bp, s)
            tok_np, state = self._prefill_and_read(exe, params, toks, valid)
            end = time.perf_counter()
            for r in wave:
                r.ttft_s = end - r.submitted_at
            dec = self.get_decode(params, state, bp)
            mine = lm.data_rows(self.bundle.ctx, bp)
            live = np.ones(len(wave), bool)
            steps = max(r.max_new for r in wave)
            for step in range(steps):
                for i, r in enumerate(wave):
                    if not live[i]:
                        continue
                    r.output.append(int(tok_np[i]))
                    if (len(r.output) >= r.max_new or
                            (self.eos_id is not None
                             and tok_np[i] == self.eos_id)):
                        live[i] = False
                        r.done = True
                if not live.any() or step == steps - 1:
                    break
                logits, state = dec(params, state,
                                    _to_device(tok_np[mine], self.device))
                tok_np = lm.gather_rows(logits.argmax(-1),
                                        self.bundle.ctx).cpu().numpy()
        for r in wave:
            r.done = True
        self.finished.extend(wave)
        return wave


class ContinuousServingEngine(_ServingBase):
    """Per-slot continuous admission over a fixed pool of ``max_batch``
    decode slots.

    ``step(params)`` = admit (prefill-insert queued requests into free
    slots) + one decode of the whole pool.  The pool's ``DecodeState``
    carries per-row lengths, so freshly admitted requests decode next to
    slots mid-way through theirs; free slots decode values that are
    dropped.  Retired slots (eos seen or ``max_new`` reached) hand their
    request to the ``emit`` hook at once and are refilled on the next step.
    Admission prefills ``admit_chunk`` rows per call, the interleave lanes
    x data ranks (1 without either), drawn from the queue and left-padded
    to the smallest bucket that fits the chunk; a chunk the queue or the
    free slots cannot fill is padded with pad rows, dropped by the insert.
    Every (chunk x bucket) prefill callable is prepared, so steady-state
    admission builds nothing.  Over a data group each rank holds and
    decodes its block of the slots (``models/lm.data_rows`` of
    ``max_batch``).
    """

    def __init__(self, bundle, *, max_batch: int = 8, max_len: int = 256,
                 eos_id: int | None = None, pad_id: int = 0,
                 track_traffic: bool = False,
                 buckets: tuple[int, ...] | None = None,
                 emit: Callable[[Request], None] | None = None):
        super().__init__(bundle, max_batch=max_batch, max_len=max_len,
                         eos_id=eos_id, pad_id=pad_id,
                         track_traffic=track_traffic, buckets=buckets)
        if max_batch % self._wave_mult:
            raise ValueError(
                f"max_batch={max_batch} must be a multiple of the "
                f"interleave lanes x data shards ({self._wave_mult}) — the "
                "pool decode shards rows over the data axes")
        self.emit = emit
        self.admit_chunk = self._wave_mult
        # this rank's block of the slots (all of them without a data group)
        self._mine = lm.data_rows(bundle.ctx, max_batch)
        self.slots: list[Optional[Request]] = [None] * max_batch
        self.occupancy: list[float] = []     # per-step occupied fraction
        self.decode_steps = 0
        self.decode_tokens = 0
        self.decode_s = 0.0
        self._tok = np.full((max_batch,), pad_id, np.int64)
        self._state = None                   # pool DecodeState, built lazily
        self._insert_exec = None

    # ------------------------------------------------------------- state ----

    def _ensure_pool(self):
        if self._state is None:
            ctx = self.bundle.ctx
            self._state = lm.init_decode_state(
                ctx.cfg, self.max_batch, self.max_len, ctx.compute_dtype,
                ctx, per_slot=True)

    @staticmethod
    def _insert_fn(pool: lm.DecodeState, new: lm.DecodeState, slots,
                   group=None, first: int = 0) -> lm.DecodeState:
        """Copy row j of a freshly prefilled ``new`` state (rows = admit
        chunk, one length for all) into the pool at slot ``slots[j]``, in
        place, the pool holding the slots from ``first`` on (a data rank's
        block); slot ids out of its range (pad lanes, another rank's
        slots) are dropped (the reference's ``mode="drop"``).  Over a data
        ``group`` (None: one data rank) ``new`` holds this rank's rows of
        the chunk, and its KV caches (k and v stacked) and SSM states are
        first all-gathered over it into the whole chunk's, in data order;
        the length is every row's.  ``slots`` is host data, so the copies
        index by Python ints.  A stateless family (moe_ffn, ``kv`` and
        ``ssm`` None) inserts its length alone; the ssm and hybrid families
        insert each row's SSD state and conv inputs (``ssm``) beside its
        cache, as the reference's insert scatters them."""
        if group is not None:
            kv, ssm = new.kv, new.ssm
            if kv is not None:
                both = dcomm.all_gather_dim(torch.stack([kv["k"], kv["v"]]),
                                            2, group)
                kv = {"k": both[0], "v": both[1]}
            if ssm is not None:
                ssm = {k: dcomm.all_gather_dim(v, 1, group)
                       for k, v in ssm.items()}
            new = lm.DecodeState(kv, new.length, ssm)
        n = pool.length.shape[0]
        for j, i in enumerate(int(x) - first for x in slots):
            if not 0 <= i < n:
                continue
            for part, whole in ((pool.kv, new.kv), (pool.ssm, new.ssm)):
                for name in part or ():
                    part[name][:, i].copy_(whole[name][:, j])
            pool.length[i].copy_(new.length)
        return pool

    def _get_insert(self):
        """The slot insert; its shapes depend only on the pool and the admit
        chunk (the KV capacity is fixed by max_len, not by the bucket), so
        one callable covers every admission.  Built on a scratch pool and a
        scratch prefill state (this rank's rows of each)."""
        if self._insert_exec is None:
            ctx = self.bundle.ctx
            mk = lambda rows, per_slot: lm.init_decode_state(
                ctx.cfg, rows, self.max_len, ctx.compute_dtype, ctx,
                per_slot=per_slot)
            # holds the data group and the block, not the engine
            insert = functools.partial(self._insert_fn,
                                       group=lm.data_group(ctx),
                                       first=self._mine.start)
            self._build(insert, mk(self.max_batch, True),
                        mk(self.admit_chunk, False), [0])
            self._insert_exec = insert
        return self._insert_exec

    def warmup(self, params) -> float:
        """Build every (admit-chunk x bucket) prefill callable, the pool
        decode step and the slot insert; returns seconds spent.  After
        warmup, ``compile_count`` stays flat under any admission pattern
        whose prompts fit the buckets."""
        t0 = time.perf_counter()
        self._ensure_pool()
        for s in self.buckets:
            self.get_prefill(params, self.admit_chunk, s)
        self._get_insert()
        self.get_decode(params, self._state, self.max_batch)
        return time.perf_counter() - t0

    # --------------------------------------------------------- scheduling ---

    def pending(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)

    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def _retire_or_keep(self, i: int, tok: int, retired: list):
        """Append ``tok`` to slot i's request; retire the slot on eos or
        max_new (feeding the emit path), else keep the token for the next
        decode step."""
        r = self.slots[i]
        r.output.append(tok)
        if (len(r.output) >= r.max_new or
                (self.eos_id is not None and tok == self.eos_id)):
            r.done = True
            self.slots[i] = None
            self._tok[i] = self.pad_id
            self.finished.append(r)
            if self.emit is not None:
                self.emit(r)
            retired.append(r)
        else:
            self._tok[i] = tok

    def _admit(self, params, retired: list) -> list[Request]:
        """Prefill-insert queued requests into free slots, one admit chunk
        at a time, while the rest of the pool's state sits untouched."""
        admitted = []
        while self.queue and self.free_slots():
            free = self.free_slots()
            take = min(self.admit_chunk, len(self.queue), len(free))
            reqs = [self.queue.popleft() for _ in range(take)]
            s = max(self.bucket_of(len(r.prompt)) for r in reqs)
            exe = self.get_prefill(params, self.admit_chunk, s)  # pre-timed
            self._ensure_pool()
            insert = self._get_insert()
            with torch.inference_mode():
                toks, valid = self._padded(reqs, self.admit_chunk, s)
                first, new_state = self._prefill_and_read(exe, params, toks,
                                                          valid)
                end = time.perf_counter()
                # pad lanes point at slot id max_batch: dropped by the insert
                slot_arr = np.full((self.admit_chunk,), self.max_batch,
                                   np.int64)
                for j, r in enumerate(reqs):
                    i = free[j]
                    slot_arr[j] = i
                    self.slots[i] = r
                    r.ttft_s = end - r.submitted_at
                self._state = insert(self._state, new_state, slot_arr)
            for j, r in enumerate(reqs):
                # the prefill's argmax IS the request's first token (TTFT
                # token); a max_new=1 request retires without ever decoding
                self._retire_or_keep(int(slot_arr[j]), int(first[j]), retired)
            admitted.extend(reqs)
        return admitted

    def step(self, params) -> list[Request]:
        """Admit into free slots, then decode the whole pool one token.
        Returns the requests retired this step."""
        retired: list[Request] = []
        self._admit(params, retired)
        occupied = [i for i, r in enumerate(self.slots) if r is not None]
        self.occupancy.append(len(occupied) / self.max_batch)
        if not occupied:
            return retired
        self._ensure_pool()
        dec = self.get_decode(params, self._state, self.max_batch)
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, self._state = dec(params, self._state, _to_device(
                self._tok[self._mine], self.device))
            # every rank's rows, then the step's one host read
            tok = lm.gather_rows(logits.argmax(-1),
                                 self.bundle.ctx).cpu().numpy()
        self.decode_s += time.perf_counter() - t0
        self.decode_steps += 1
        self.decode_tokens += len(occupied)
        for i in occupied:
            self._retire_or_keep(i, int(tok[i]), retired)
        return retired

    def run(self, params) -> list[Request]:
        """Step until the queue and every slot drain; returns all finished."""
        out: list[Request] = []
        while self.pending():
            out.extend(self.step(params))
        return out

    def stats(self) -> dict:
        out = super().stats()
        if self.occupancy:
            out["mean_slot_occupancy"] = float(np.mean(self.occupancy))
            out["decode_steps"] = self.decode_steps
        if self.decode_s > 0:
            out["decode_tok_s"] = self.decode_tokens / self.decode_s
        return out
