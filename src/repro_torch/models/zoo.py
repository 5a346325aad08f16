"""Model zoo: one interface over the port's model families (port of
``repro/models/zoo.py``'s ``build`` and ``make_smoke_batch``).

A :class:`ModelBundle` holds the config, the context and the model's
``init``, ``loss``, ``prefill`` and ``decode_step`` with the reference's
call signatures: the train step (``launch/steps.py``) takes the loss, the
serving engines (``serving/engine.py``) and ``launch/serve.py`` drive the
rest.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec_model, lm
from repro_torch.models.lm import ModelContext


# the families whose prompts and batches are embeddings, not token ids, and
# what they take: the engines' token prompts and the token data sources
# cannot feed them (``serving/engine.py``, ``launch/train.py``)
EMBED_INPUTS = {
    "encdec": "frame embeddings (and a first decoder token)",
    "vlm": "patch embeddings at (3, S) M-RoPE positions"}


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    ctx: ModelContext
    init: Callable[..., Any]          # (generator, dtype=bf16) -> params
    loss: Callable                    # (params, batch, traffic=None) ->
                                      #  (loss, metrics)
    prefill: Callable                 # (params, batch, max_len, traffic=,
                                      #  traffic_mask=); batch {"tokens"
                                      #  [, "positions"]}, the vlm's
                                      #  {"embeds", "positions"}, encdec's
                                      #  {"frames", "tokens" (B,)}
    decode_step: Callable             # (params, state, tokens, max_len)


def build(cfg: ArchConfig, ctx: ModelContext) -> ModelBundle:
    """The bundle of a model of a family ``lm.make_context`` takes: a
    decoder-only LM (``lm.FAMILIES``) on one rank, over an EP group or on a
    grid (the dense family's loss then runs Megatron-SP over the model
    group, ``lm.tensor_parallel``, and its prefill and decode refuse the
    TP shards; the ssm and hybrid families' Mamba2 mixers split by SSM
    head over a model group; the vlm's and hybrid's attention over one the
    head-parallel island), or the
    encoder-decoder (``models/encdec_model.py``, on one rank or a grid as
    the vlm), whose prefill takes {"frames" (B, S_enc, d), "tokens" (B,)
    the first decoder token} and takes no traffic, as the reference's.
    On a grid the loss takes this data rank's rows (:func:`data_batch`)
    and the prefill the global batch, of which it runs this rank's rows."""
    if cfg.family == "encdec":
        def encdec_prefill(p, batch, max_len):
            return encdec_model.prefill(p, batch["frames"], batch["tokens"],
                                        ctx, max_len)

        return ModelBundle(
            cfg, ctx,
            init=lambda gen, dtype=torch.bfloat16: encdec_model.init_params(
                cfg, ctx, gen, dtype),
            loss=lambda p, b, traffic=None: encdec_model.encdec_loss(
                p, b, ctx, traffic),
            prefill=encdec_prefill,
            decode_step=lambda p, st, tok, max_len: encdec_model.decode_step(
                p, st, tok, ctx, max_len))

    def prefill(p, batch, max_len, traffic=None, traffic_mask=None):
        inputs = batch["embeds"] if "embeds" in batch else batch["tokens"]
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(inputs.shape[1], device=inputs.device)
        return lm.prefill(p, inputs, positions, ctx, max_len, traffic=traffic,
                          traffic_mask=traffic_mask)

    return ModelBundle(
        cfg, ctx,
        init=lambda gen, dtype=torch.bfloat16: lm.init_params(cfg, ctx, gen,
                                                              dtype),
        loss=lambda p, b, traffic=None: lm.lm_loss(p, b, ctx, traffic=traffic),
        prefill=prefill,
        decode_step=lambda p, st, tok, max_len: lm.decode_step(
            p, st, tok, ctx, max_len))


def make_smoke_batch(cfg: ArchConfig, gen: torch.Generator, batch: int = 4,
                     seq: int = 32) -> dict:
    """A random batch of ``cfg``'s family drawn from ``gen`` on its device
    (the reference's zoo.py:116-130): encdec {"frames" (B, S, d) normal,
    "tokens", "labels" (B, S)}; vlm {"embeds" (B, S, d) normal,
    "positions" 3 x arange(S), "labels"}; every other family {"tokens",
    "labels"}."""
    dev = gen.device
    ints = lambda: torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                                 device=dev)
    normal = lambda: torch.randn((batch, seq, cfg.d_model), generator=gen,
                                 device=dev)
    if cfg.family == "encdec":
        return {"frames": normal(), "tokens": ints(), "labels": ints()}
    if cfg.family == "vlm":
        pos = torch.arange(seq, device=dev)
        return {"embeds": normal(), "positions": torch.stack([pos] * 3),
                "labels": ints()}
    return {"tokens": ints(), "labels": ints()}


def data_batch(batch: dict, ctx: ModelContext) -> dict:
    """This data rank's rows of a global batch of any family
    (``lm.data_rows``: its block of dim 0 of every leaf), the vlm's (3, S)
    ``positions`` whole: what the bundle's loss takes on a grid.  The data
    ranks must divide B, else ValueError."""
    b, n = batch["labels"].shape[0], lm.data_size(ctx)
    if b % n:
        raise ValueError(f"a batch of {b} rows does not split over {n} data "
                         "ranks")
    rows = lm.data_rows(ctx, b)
    return {k: v if k == "positions" else v[rows] for k, v in batch.items()}


def vl_positions(text: int, grid: tuple[int, int], after: int,
                 device=None) -> torch.Tensor:
    """The (3, S) M-RoPE ids of a Qwen2-VL prompt of ``text`` tokens, one
    image frame of grid[0] x grid[1] patches, then ``after`` tokens (the
    layout of Qwen2-VL's position ids, arXiv:2409.12191 section 2.1): a text
    token at t = h = w = its index; the frame's patches at one temporal id
    t = ``text``, h = ``text`` + row, w = ``text`` + column; the text after
    at the image's largest id + 1 onwards.  S = text + grid[0] grid[1] +
    after; the temporal row is non-decreasing, flat across the image."""
    gh, gw = grid
    rows = torch.arange(gh, device=device).repeat_interleave(gw)
    cols = torch.arange(gw, device=device).repeat(gh)
    lead = torch.arange(text, device=device)
    image = torch.stack([torch.full_like(rows, text), text + rows,
                         text + cols])
    start = text + max(gh, gw)
    tail = torch.arange(start, start + after, device=device)
    return torch.cat([torch.stack([lead] * 3), image,
                      torch.stack([tail] * 3)], dim=1)
