"""Model zoo: one interface over the port's LM families (port of the LM part
of ``repro/models/zoo.py``).

A :class:`ModelBundle` holds the config, the context and the model's
``init``, ``loss``, ``prefill`` and ``decode_step`` with the reference's
call signatures: the train step (``launch/steps.py``) takes the loss, the
serving engines (``serving/engine.py``) drive the rest.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.models.lm import ModelContext


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    ctx: ModelContext
    init: Callable[..., Any]          # (generator, dtype=bf16) -> params
    loss: Callable                    # (params, batch, traffic=None) ->
                                      #  (loss, metrics)
    prefill: Callable                 # (params, {"tokens"[, "positions"]},
                                      #  max_len, traffic=, traffic_mask=)
    decode_step: Callable             # (params, state, tokens, max_len)


def build(cfg: ArchConfig, ctx: ModelContext) -> ModelBundle:
    """The bundle of a decoder-only LM of a family ``lm.make_context`` takes
    (``lm.FAMILIES``: dense, moe, moe_tx, moe_ffn, ssm and hybrid), on one
    rank, over an EP group or on a grid (the dense family's too: its loss
    then runs Megatron-SP over the model group, ``lm.tensor_parallel``, and
    its prefill and decode refuse the TP shards; ssm and hybrid on one rank
    or a data group only)."""
    if cfg.family == "encdec":
        raise NotImplementedError(
            "the encoder-decoder family is not ported yet: ROADMAP queue 1 "
            "item 8 (models/encdec_model.py)")

    def prefill(p, batch, max_len, traffic=None, traffic_mask=None):
        toks = batch["tokens"]
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(toks.shape[1], device=toks.device)
        return lm.prefill(p, toks, positions, ctx, max_len, traffic=traffic,
                          traffic_mask=traffic_mask)

    return ModelBundle(
        cfg, ctx,
        init=lambda gen, dtype=torch.bfloat16: lm.init_params(cfg, ctx, gen,
                                                              dtype),
        loss=lambda p, b, traffic=None: lm.lm_loss(p, b, ctx, traffic=traffic),
        prefill=prefill,
        decode_step=lambda p, st, tok, max_len: lm.decode_step(
            p, st, tok, ctx, max_len))
