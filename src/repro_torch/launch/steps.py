"""The train step (port of ``make_train_step`` in
``repro/launch/steps.py``).

:class:`ModelBundle` stands in for the reference's ``zoo.ModelBundle``: the
model's config, its context and its loss.  ``make_train_step`` takes
gradients of the loss with ``torch.autograd.grad`` and applies one AdamW
step in place.  ``accum > 1`` accumulates micro-batches serially, the
gradients summed in float32 and divided by ``accum``.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.optim import adamw


class ModelBundle(NamedTuple):
    cfg: ArchConfig
    ctx: Any
    loss: Callable       # loss(params, batch) -> (scalar loss, metrics)


def bundle(ctx: lm.ModelContext) -> ModelBundle:
    return ModelBundle(ctx.cfg, ctx, partial(lm.lm_loss, ctx=ctx))


def make_train_step(model: ModelBundle, opt_cfg: adamw.AdamWConfig,
                    accum: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; params and optimizer state are updated in place.  The
    reference's traffic threading is not ported; its fusion of accumulation
    micro-batches into an interleaved ``fused_pipe`` stream cannot arise, as
    the port trains the ``moe`` family only (``lm.forward_hidden`` raises for
    the stream families) and has no ``fused_pipe`` engine."""
    if accum < 1:
        raise ValueError(f"accum {accum} < 1")

    def grads_of(params, batch):
        ps = adamw.leaves(params)
        for p in ps:
            if not p.requires_grad:
                p.requires_grad_(True)
        loss, metrics = model.loss(params, batch)
        return loss, metrics, torch.autograd.grad(loss, ps)

    def train_step(params, opt_state, batch, traffic=None):
        if traffic is not None:
            raise NotImplementedError(
                "traffic statistics threaded through the train step are not "
                "ported yet: ROADMAP queue 1 item 6 (core/traffic.py)")
        if accum == 1:
            loss, metrics, grads = grads_of(params, batch)
            metrics = dict(metrics, loss=loss.detach())
        else:
            b = next(iter(batch.values())).shape[0]
            if b % accum:
                raise ValueError(f"batch {b} does not split into {accum} "
                                 "micro-batches")
            gsum, lsum = None, 0.0
            for i in range(accum):
                mb = {k: v[i * (b // accum):(i + 1) * (b // accum)]
                      for k, v in batch.items()}
                loss, _, grads = grads_of(params, mb)
                if gsum is None:
                    gsum = [g.float() for g in grads]
                else:
                    for a, g in zip(gsum, grads):
                        a.add_(g)
                lsum = lsum + loss.detach()
                del grads
            grads = [g.div_(accum) for g in gsum]
            metrics = {"loss": lsum / accum}
        params, opt_state, opt_metrics = adamw.update(
            adamw.unflatten(params, grads), opt_state, params, opt_cfg)
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step
