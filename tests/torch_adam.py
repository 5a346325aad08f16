"""The tolerance of AdamW-updated parameters held against the reference's.

An AdamW step moves each element of the f32 master by lr_t·(m̂/(√v̂ + eps)
+ wd·w).  Where an element's gradient is small beside eps (a sum that all
but cancels), the step is nearly lr_t·m̂/eps: two gradients that agree to
float32 rounding (a few 1e-10 apart) move it by a sizeable share of lr_t,
more than a fixed tolerance on the parameters allows, while mu and nu agree
to far better than theirs.  So mu and nu keep the fixed tolerance, and each
element of the params and the master gets, besides it, the slack its own
steps allow (:func:`step_slack`, summed over the steps taken).

The slack of one step: every gradient that reached m̂ and v̂ may differ
from the reference's by ``dg``, ``tol`` times the leaf's largest √v̂ (the
agreement at ``tol`` relative to the leaf's scale that the gradient checks
hold).  m̂ is a mean of those gradients with weights summing to 1, and √v̂
a root mean square with such weights, so each moves by at most ``dg``; the
slack is lr_t times the largest change of m̂/(√v̂ + eps) over that box,
where the step's magnitude is capped by AdamW's own bound (:func:`adam_bound`,
1 at step 1).  Everything is numpy: the JAX subprocesses of the EP tests
import it too.
"""

from __future__ import annotations

import math

import numpy as np

TOL = 1e-5


def adam_bound(step: int, b1: float, b2: float) -> float:
    """The largest |m̂/√v̂| AdamW can reach at ``step`` whatever its
    gradients (Cauchy-Schwarz over the two moving averages)."""
    r = b1 * b1 / b2
    s = sum(r ** j for j in range(step))
    return ((1 - b1) / (1 - b1 ** step) * math.sqrt(s)
            * math.sqrt((1 - b2 ** step) / (1 - b2)))


def step_slack(mu, nu, step: int, lr: float, cfg, tol: float = TOL):
    """lr times the largest change of m̂/(√v̂ + eps) of one AdamW step, per
    element, when each gradient behind the reference's ``mu`` and ``nu``
    (after ``step``, 1-based) moves by ``tol`` times the leaf's largest
    √v̂.  ``cfg`` holds b1, b2 and eps (either side's AdamWConfig)."""
    m = np.asarray(mu, np.float64) / (1 - cfg.b1 ** step)
    s = np.sqrt(np.asarray(nu, np.float64) / (1 - cfg.b2 ** step))
    dg = tol * float(s.max()) if s.size else 0.0
    cap = adam_bound(step, cfg.b1, cfg.b2)
    f = m / (s + cfg.eps)
    worst = np.zeros_like(f)
    for dm in (-dg, dg):
        for ds in (-dg, dg):
            g = np.clip((m + dm) / (np.maximum(s + ds, 0.0) + cfg.eps),
                        -cap, cap)
            worst = np.maximum(worst, np.abs(g - f))
    return lr * worst


def close_updated(got, want, slack, what: str = "", tol: float = TOL):
    """``got`` within ``tol`` of ``want`` relative to max(1, its largest
    magnitude), as the other checks, plus ``slack`` per element (the sum of
    the steps' :func:`step_slack`)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    err = np.abs(got - want)
    room = np.asarray(slack, np.float64) + tol * np.abs(want) + tol * scale
    bad = err > room
    if bad.any():
        i = np.unravel_index(np.argmax(np.where(bad, err - room, -np.inf)),
                             err.shape)
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {err.size} elements outside the "
            f"update's room; worst at {tuple(int(j) for j in i)}: got "
            f"{got[i]!r}, want {want[i]!r}, room {room[i]!r}")


def _flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}{key}/").items()}
    leaf = tree.detach() if hasattr(tree, "detach") else tree
    return {prefix[:-1]: np.asarray(leaf)}


def check_step(params, opt, want: dict, cfg, lr: float, close) -> None:
    """One AdamW step (step 1) against the reference's ``want``
    ({"new_params", "mu", "nu", "master"}, nested dicts of arrays): mu and
    nu by ``close(got, want, what)`` (the file's fixed tolerance), params
    and master by :func:`close_updated` with the step's slack."""
    mu, nu = _flat(want["mu"]), _flat(want["nu"])
    for name, got, ref in (("params", params, want["new_params"]),
                           ("mu", opt.mu, want["mu"]),
                           ("nu", opt.nu, want["nu"]),
                           ("master", opt.master, want["master"])):
        got, ref = _flat(got), _flat(ref)
        assert got.keys() == ref.keys(), name
        for k in ref:
            if name in ("mu", "nu"):
                close(got[k], ref[k], f"{name} {k}")
            else:
                close_updated(got[k], ref[k],
                              step_slack(mu[k], nu[k], 1, lr, cfg),
                              f"{name} {k}")
