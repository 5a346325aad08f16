"""The comm-path policy's per-layer engines (``ModelContext.engines``) and
``train --engine auto`` against the JAX package: reduced
``qwen3-moe-30b-a3b`` (2 layers) in float32 on the CPU.

- ``lm_loss`` and every gradient leaf with a mixed ``engines`` tuple
  (fused_flat, fused_hier) against the reference's same-engine runs
  (``repro/models/lm.py:509-530``) at EP 1, with each layer's engine
  observed; and rank by rank at EP 4 (four gloo ranks against
  ``shard_map`` on 4 forced host devices, ``torch_ep_train``): loss,
  gradients, one train step and the traffic state.
- A tuple of the wrong length raises, as the reference's.
- ``train.run --engine auto --relayout-every 2`` against a hand loop of the
  port's ``plan_paths`` -> ``apply_relayout`` -> ``engines``: the same
  decisions at each boundary and the same losses.
- ``--engine auto`` on the moe_ffn family prints the reference's message
  and runs fused_hier.

Tolerances: 1e-5 relative to each leaf's max(1, |x|) (``torch_ep_train``);
the hand loop's losses equal bit for bit (the same code in the same order).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ep_train as harness
from repro.compat import make_mesh
from repro.configs import get_arch as jget_arch
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core import commplan, dcomm
from repro_torch.data.pipeline import to_device
from repro_torch.launch import steps, train
from repro_torch.models import lm, zoo
from repro_torch.optim import adamw

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

ARCH = "qwen3-moe-30b-a3b"
MIXED = ("fused_flat", "fused_hier")
TRAIN = ["--reduced", "--steps", "4", "--seq", "32", "--batch", "2",
         "--relayout-every", "2"]


def _jax_loss_and_grads(tree: dict, batch: dict, engines) -> tuple:
    cfg = jget_arch(ARCH).reduced()
    mesh = make_mesh((1, 1), ("data", "model"))
    ctx = dataclasses.replace(
        jlm.make_context(cfg, mesh, multi_pod=False, engine="fused_hier",
                         node_size=1),
        compute_dtype=jnp.float32, remat=False, engines=engines)
    params = jax.tree.map(jnp.asarray, tree)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with mesh:
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: jlm.lm_loss(p, jb, ctx), has_aux=True)).lower(
                params).compile(harness.FAST)(params)
    return float(loss), harness.flat(jax.tree.map(np.asarray, grads))


def test_mixed_engines_match_the_reference_at_ep1(monkeypatch):
    cfg = get_arch(ARCH).reduced()
    tree = harness.nest(harness.params(ARCH, ep=1, node=1).items())
    batch = harness.batch(cfg.vocab)
    want_loss, want = _jax_loss_and_grads(tree, batch, MIXED)
    seen = []
    for name in ("flat_dispatch", "hier_dispatch"):
        real = getattr(dcomm, name)
        monkeypatch.setattr(dcomm, name, lambda *a, _f=real, _n=name, **k: (
            seen.append(_n), _f(*a, **k))[1])
    ctx = dataclasses.replace(
        lm.make_context(cfg, "cpu", engine="fused_hier", node_size=1,
                        compute_dtype=torch.float32), engines=MIXED)
    params = convert.params_from_jax(tree, "cpu")
    leaves = adamw.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    loss, _ = lm.lm_loss(params, tb, ctx)
    grads = torch.autograd.grad(loss, leaves)
    assert seen == ["flat_dispatch", "hier_dispatch"]
    harness.close(float(loss.detach()), want_loss, "loss")
    for path, g in zip(adamw.paths(params), grads):
        harness.close(g.numpy(), want[path], f"grad {path}")


def test_engines_of_the_wrong_length_raise():
    cfg = get_arch(ARCH).reduced()
    ctx = dataclasses.replace(lm.make_context(cfg, "cpu"),
                              engines=("fused_flat",) * (cfg.n_layers + 1))
    params = lm.init_params(cfg, ctx, torch.Generator().manual_seed(0))
    tokens = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="engines"):
        lm.forward_hidden(params, tokens, torch.arange(8), ctx)


def test_mixed_engines_rank_by_rank_at_ep4(tmp_path):
    case = ",".join(MIXED)
    want, ranks, _ = harness.run(tmp_path, ARCH, ((case, 0, 0),))
    c = f"{case}/0"
    for r, got in enumerate(ranks):
        harness.check_grads(want, got, c, r)
        harness.check_step(want, got, c, r)


def test_auto_engine_matches_a_hand_loop_of_the_policy(capsys):
    """``train.run --engine auto``: the [commplan] line and the decisions
    at each relayout boundary, and every loss, against the same loop
    written out: plan on the retiring placement, swap, set the engines."""
    args = train.parse_args(TRAIN + ["--engine", "auto"])
    out = train.run(args, device="cpu")
    printed = capsys.readouterr().out
    assert [p["step"] for p in out["plans"]] == [2, 4]
    for p in out["plans"]:
        line = " ".join(f"L{i}:{'F' if e == 'fused_flat' else 'H'}"
                        for i, e in enumerate(p["engines"]))
        assert f"[commplan] step {p['step']}: " in printed and line in printed
    assert out["engines"] == out["plans"][-1]["engines"]

    cfg, ctx, params, source, opt_cfg = train.setup(args, "cpu")
    assert ctx.dcfg.engine == "fused_hier" and ctx.engines is None
    model = zoo.build(cfg, ctx)
    traffic = train.init_traffic(cfg, ctx, 1)
    opt = steps.init_state(model, params)
    losses, plans = [], []
    quiet = lambda *a, **k: None
    for i in range(args.steps):
        batch = to_device(source.batch_at(i), "cpu")
        params, opt, m = steps.make_train_step(model, opt_cfg)(
            params, opt, batch, traffic)
        traffic = m["traffic"]
        losses.append(float(m["loss"]))
        if (i + 1) % 2 == 0:
            host = type(traffic)(*(t.numpy() for t in traffic))
            decisions = commplan.plan_paths(
                host, ctx.placement, row_bytes=cfg.d_model * 2,
                costs=commplan.LinkCosts.from_dcomm(ctx.dcfg),
                default="fused_hier")
            plans.append(tuple(d.engine for d in decisions))
            params, opt, ctx, _ = train.apply_relayout(params, opt, traffic,
                                                       ctx, log=quiet)
            ctx = dataclasses.replace(ctx, engines=plans[-1])
            traffic = train.cold_lane_stats(traffic)
            model = zoo.build(cfg, ctx)
    assert plans == [p["engines"] for p in out["plans"]]
    assert losses == out["losses"]


def test_auto_engine_falls_back_outside_the_moe_family(capsys):
    args = train.parse_args(["--arch", "moe-ffn-stream", "--reduced",
                             "--engine", "auto", "--steps", "3", "--seq", "32",
                             "--batch", "2"])
    out = train.run(args, device="cpu")
    assert ("[commplan] --engine auto needs per-layer MoE islands (family "
            "'moe_ffn'); falling back to fused_hier") in capsys.readouterr().out
    assert out["engines"] == ("fused_hier",) * out["cfg"].n_layers
    assert out["plans"] == []
    assert len(out["losses"]) == 3
