"""The train step (port of ``make_train_step`` in
``repro/launch/steps.py``).

``make_train_step`` takes the gradients of a ``models.zoo.ModelBundle``'s
loss with ``torch.autograd.grad`` and applies one AdamW step in place.
``accum > 1`` accumulates micro-batches serially, the gradients summed in
float32 and divided by ``accum``.
"""

from __future__ import annotations

import torch

from repro_torch.models import zoo
from repro_torch.optim import adamw


def make_train_step(model: zoo.ModelBundle, opt_cfg: adamw.AdamWConfig,
                    accum: int = 1):
    """``train_step(params, opt_state, batch, traffic=None) -> (params,
    opt_state, metrics)``; params and optimizer state are updated in place.
    With ``traffic`` (the layer-stacked ``traffic.TrafficState``) the loss
    threads it through the MoE layers and the new state comes back as
    ``metrics["traffic"]``; its counts come from the integer routing
    matrix, so no gradient flows through them.  Serial accumulation does
    not thread a state (``NotImplementedError``, as the reference).  The
    reference's fusion of accumulation micro-batches into an interleaved
    ``fused_pipe`` stream needs ``interleave > 1``, which the port's stream
    does not take yet (ROADMAP queue 1 item 5)."""
    if accum < 1:
        raise ValueError(f"accum {accum} < 1")

    def grads_of(params, batch, traffic=None):
        ps = adamw.leaves(params)
        for p in ps:
            if not p.requires_grad:
                p.requires_grad_(True)
        loss, metrics = model.loss(params, batch, traffic=traffic)
        return loss, metrics, torch.autograd.grad(loss, ps)

    def train_step(params, opt_state, batch, traffic=None):
        if accum == 1:
            loss, metrics, grads = grads_of(params, batch, traffic)
            metrics = dict(metrics, loss=loss.detach())
        else:
            if traffic is not None:
                raise NotImplementedError(
                    "traffic stats + gradient accumulation: thread the state "
                    "through the micro-batch loop first")
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
