"""The fault-tolerant training loop: step-atomic checkpoints, restart from
the last committed step, failure injection and the straggler monitor (port
of ``repro/runtime/fault_tolerance.py``).

``run_training`` wraps a step function with:
  * periodic step-atomic checkpoints (async, ``checkpoint/checkpointer.py``)
    and one at the last step;
  * a restart from the last committed checkpoint on any step failure, up to
    ``max_restarts``: the data stream is deterministic in the step, so the
    replayed steps see the same batches;
  * the straggler monitor: a step slower than ``straggler_factor`` times
    the rolling median demotes a lane from forwarder duty (logged and
    counted in :class:`RunState`, as the reference's hook);
  * ``inject_failure_at``: one deterministic failure, before the first
    restart only.

A step is waited for by reading its loss to the host, and on the card by
``torch.cuda.synchronize()`` (the reference's ``block_until_ready``).  Over
a group of ranks every rank runs the loop and calls the checkpointer's
collectives in the same order (``layout``, a ``checkpointer.Layout``); an
injected failure strikes every rank at the same step, as in the reference.

The port's step updates params and AdamW state in place, so a failure
inside the step may leave them half updated; only a restore from a
committed step rebuilds them.  Hence two departures from the reference:
``ckpt_dir`` None runs without checkpoints and re-raises every failure, and
before the first commit only an injected failure (raised before the step
touches anything) restarts from step 0 with the parameters kept; any other
failure is re-raised.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint import checkpointer


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class RunConfig:
    total_steps: int
    ckpt_dir: str | None
    ckpt_every: int = 50
    max_restarts: int = 3
    straggler_factor: float = 2.0
    straggler_window: int = 16
    inject_failure_at: int | None = None   # deterministic injection (tests)
    # called as on_restart(step, restored) after every rewind: ``restored``
    # is True when (params, opt) were reloaded from a committed checkpoint
    # (the step function must re-base any state keyed to the step index or
    # to the parameter layout, e.g. the expert placement, whose table must
    # match the restored weights' layout), False when the run restarts from
    # step 0 with the in-memory params kept
    on_restart: Callable[[int, bool], None] | None = None
    # called as on_commit(step) on every rank just before each checkpoint
    # of ``step`` is saved (sidecars that must follow the commit cadence)
    on_commit: Callable[[int], None] | None = None
    layout: checkpointer.Layout = checkpointer.ONE


@dataclasses.dataclass
class RunState:
    restarts: int = 0
    straggler_events: int = 0
    demoted_lanes: tuple = ()
    steps_run: int = 0
    # each save's checkpointer.Pending (host gather ms, write s, bytes) and
    # each restore's seconds
    saves: list = dataclasses.field(default_factory=list)
    restore_s: list = dataclasses.field(default_factory=list)


def _block(metrics: dict) -> None:
    loss = metrics["loss"]
    if isinstance(loss, torch.Tensor) and loss.device.type == "cuda":
        torch.cuda.synchronize(loss.device)
    float(loss)


def run_training(step_fn: Callable, init_state: tuple, batch_at: Callable,
                 cfg: RunConfig, log: Callable = print) -> tuple:
    """step_fn(params, opt, batch) -> (params, opt, metrics).

    Returns ((params, opt), RunState).  Restarts reload the latest committed
    checkpoint and replay the deterministic stream from that step."""
    params, opt = init_state
    run = RunState()
    lay = cfg.layout

    def restore():
        t0 = time.perf_counter()
        state, _ = checkpointer.restore(cfg.ckpt_dir, (params, opt), lay=lay)
        run.restore_s.append(time.perf_counter() - t0)
        return state

    start = checkpointer.latest_step(cfg.ckpt_dir)
    step = 0
    if start is not None:
        params, opt = restore()
        step = start
        log(f"[ft] resumed from committed step {step}")
        if cfg.on_restart is not None:
            cfg.on_restart(step, True)
    pending = None
    times: deque = deque(maxlen=cfg.straggler_window)
    injected = False

    while step < cfg.total_steps:
        try:
            if (cfg.inject_failure_at is not None
                    and step == cfg.inject_failure_at and not injected
                    and run.restarts == 0):
                injected = True
                raise InjectedFailure(f"injected failure at step {step}")
            t0 = time.perf_counter()
            params, opt, metrics = step_fn(params, opt, batch_at(step))
            _block(metrics)
            dt = time.perf_counter() - t0
            # a step may declare itself a timing fence (the first step after
            # the model is rebuilt for a new placement): skip the check and
            # restart the window
            if metrics.pop("straggler_fence", False):
                times.clear()
            else:
                if len(times) >= max(4, cfg.straggler_window // 2):
                    med = float(np.median(times))
                    if dt > cfg.straggler_factor * med:
                        run.straggler_events += 1
                        lane = run.straggler_events % 16
                        run.demoted_lanes = tuple(
                            set(run.demoted_lanes) | {lane})
                        log(f"[ft] straggler: step {step} took {dt:.3f}s "
                            f"(median {med:.3f}s) — demoting lane {lane} "
                            f"from forwarder duty for the next plan")
                times.append(dt)
            step += 1
            run.steps_run += 1
            if cfg.ckpt_dir is not None and (step % cfg.ckpt_every == 0
                                             or step == cfg.total_steps):
                checkpointer.wait(pending)
                if cfg.on_commit is not None:
                    cfg.on_commit(step)
                pending = checkpointer.save(cfg.ckpt_dir, (params, opt), step,
                                            lay=lay)
                run.saves.append(pending)
        except Exception as e:  # noqa: BLE001 — restart on ANY step failure
            if run.restarts >= cfg.max_restarts or cfg.ckpt_dir is None:
                raise
            checkpointer.wait(pending)
            pending = None
            checkpointer.barrier(lay)   # every rank's sidecars are written
            committed = checkpointer.latest_step(cfg.ckpt_dir)
            # a failure inside the step may have left a partial in-place
            # update, and nothing committed to restore it from
            if committed is None and not isinstance(e, InjectedFailure):
                raise
            run.restarts += 1
            log(f"[ft] step {step} failed ({type(e).__name__}: {e}); "
                f"restart {run.restarts}/{cfg.max_restarts}")
            if committed is None:
                step = 0
                log("[ft] no committed checkpoint — restarting from scratch")
                if cfg.on_restart is not None:
                    cfg.on_restart(0, False)
            else:
                params, opt = restore()
                step = committed
                log(f"[ft] restored step {step}")
                if cfg.on_restart is not None:
                    cfg.on_restart(step, True)
    checkpointer.wait(pending)
    return (params, opt), run
