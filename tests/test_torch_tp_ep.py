"""Megatron-SP tensor parallelism over a model group of four, a (1, 4)
(data, model) grid of four gloo ranks: one query head a rank of 4, fewer
than the group size 2, so each rank's head reads one kv head (group size
1 at the flash call).  The reduced ``qwen3-1.7b`` (dense) and the reduced
``qwen3-moe-30b-a3b`` (TP attention beside EP 4 through ``fused_flat`` and
``fused_hier``, nodes of two lanes), float32, against the reference's
``make_train_step`` and ``jax.value_and_grad(lm.lm_loss)`` with its
default ``explicit_tp=True`` on a (1, 4) mesh
(``torch_ep_train.run_grid(tp=True)``).

Rank by rank, at ``torch_ep_train``'s tolerances: the loss, every gradient
leaf (a TP leaf's and ``embed``'s and ``lm_head``'s this rank's quarter,
an expert leaf's its lane), the
traffic state, the clip norm with clipping binding, after one step the
params, mu, nu and master.  On the same ranks
(``torch_ep_train.tp_probe``): ``explicit_tp=False`` gives the same loss,
clip norm and gradients within 1e-6 of max(1, |x|); one forward launches
per TP sub-block one sequence all-gather and one reduce-scatter, one
all-gather into the head (``embed`` and ``lm_head`` split over the group)
and no gather of the MoE output; h enters each layer as (B, S / 4, d) and q
reaches the flash call with 1 head beside 1 kv head.  ``train.run`` of
the dense family over the grid (bf16) follows the one-rank run's losses
within bf16's rounding.  Over the EP group alone, with no grid, a context
takes the same TP layout by default: the grid's loss and gradients and
``train.run(ep_group=)``'s losses, bit for bit.  In process: ``tp_blocks.kv_heads`` picks the
reference's kv head of every local query head at every group size.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_ep_train as h
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core import traffic
from repro_torch.launch import steps, train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lm, zoo
from repro_torch.optim import adamw
from repro_torch.parallel import tp_blocks

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

SHAPE, NODE = (1, 4), 2
DENSE, MOE = "qwen3-1.7b", "qwen3-moe-30b-a3b"
ARCHS = ((DENSE, (("dense", 0, 0),)),
         (MOE, (("fused_flat", 0, 0), ("fused_hier", 0, 0))))
CASES = [f"{e}/{s}" for _, cases in ARCHS for e, _, s in cases]
LAYERS = 2
TOL_OFF = 1e-6
RUN = ["--arch", DENSE, "--reduced", "--steps", "3", "--seq", "16",
       "--batch", "2"]
BF16 = 2e-2               # bf16 params and products summed in another order


def _alone(rank) -> dict:
    """On the EP group alone (no grid): the dense train run's losses, and
    each case's loss and gradients from the harness's parameters and
    batch; every context takes TP by default."""
    group = dist.group.WORLD
    out = {"alone/run/losses": np.array(train.run(
        train.parse_args(RUN), "cpu", ep_group=group)["losses"])}
    for arch, cases in ARCHS:
        cfg = get_arch(arch).reduced()
        tree = h.nest(h.params(arch, ep=SHAPE[1], node=NODE).items())
        bt = {k: torch.from_numpy(v).long()
              for k, v in h.batch(cfg.vocab).items()}
        for engine, _, slices in cases:
            ctx = lm.make_context(cfg, "cpu", ep_group=group, engine=engine,
                                  node_size=NODE, compute_dtype=torch.float32)
            assert ctx.mesh is None and lm.tensor_parallel(ctx)
            p = convert.params_from_jax(tree, "cpu", lane=rank,
                                        model=(SHAPE[1], rank))
            cold = None if cfg.moe is None else traffic.init_traffic_state(
                cfg.moe.n_experts, SHAPE[1], n_layers=cfg.n_layers)
            loss, _, grads = steps.value_and_grad(zoo.build(cfg, ctx))(
                p, bt, cold)
            c = f"alone/{engine}/{slices}"
            out[f"{c}/loss"] = loss.numpy()
            for k, g in zip(adamw.paths(p), grads):
                out[f"{c}/g/{k}"] = g.numpy().copy()
    return out


def _extra(rank, world):
    mesh = make_host_mesh(*SHAPE)
    out = train.run(train.parse_args(RUN), "cpu", mesh=mesh)
    return {**h.tp_probe(SHAPE, NODE, ARCHS, rank, world),
            "run/losses": np.array(out["losses"]), **_alone(rank)}


@pytest.fixture(scope="module")
def grid_run(tmp_path_factory):
    return h.run_grid(tmp_path_factory.mktemp("tp_ep"), ARCHS, _extra,
                      shape=SHAPE, node=NODE, tp=True)


@pytest.mark.parametrize("case", CASES)
def test_tp4_loss_grads_and_traffic_match_shard_map_rank_by_rank(grid_run,
                                                                 case):
    want, ranks, _ = grid_run
    for r, got in enumerate(ranks):
        h.check_grads(want, got, case, r, SHAPE, tp=True)


@pytest.mark.parametrize("case", CASES)
def test_tp4_train_step_matches_rank_by_rank(grid_run, case):
    want, ranks, _ = grid_run
    for r, got in enumerate(ranks):
        h.check_step(want, got, case, r, SHAPE, tp=True)


@pytest.mark.parametrize("case", CASES)
def test_tp4_off_is_the_same_function_in_another_layout(grid_run, case):
    _, ranks, _ = grid_run
    c = f"{case}/tp"
    for r, got in enumerate(ranks):
        for what in ("loss", "grad_norm"):
            on, off = got[f"{c}/on/{what}"], got[f"{c}/off/{what}"]
            assert abs(float(on) - float(off)) <= TOL_OFF * max(
                1.0, abs(float(off))), (r, what, on, off)
        assert float(got[f"{c}/err"]) <= TOL_OFF, (r, got[f"{c}/err"])


@pytest.mark.parametrize("case", CASES)
def test_tp4_collectives_and_shapes_per_layer(grid_run, case):
    _, ranks, _ = grid_run
    c = f"{case}/tp"
    blocks = 2 if case.startswith("dense") else 1
    d = get_arch(DENSE).reduced().d_model
    for r, got in enumerate(ranks):
        log = list(got[f"{c}/on/log"])
        # the blocks' pairs, and the final stripes gathered into the head
        assert log.count("all_gather_seq") == blocks * LAYERS + 1, (r, log)
        assert log.count("reduce_scatter_seq") == blocks * LAYERS, (r, log)
        assert "moe_gather" not in log, (r, log)
        if blocks == 2:
            # the vocab-parallel embed's reduce-scatter (an all-reduce on
            # gloo), the blocks', the head's gather, the CE's two
            assert list(got[f"{c}/on/calls"]) == ["all_reduce"] + [
                "all_gather_into_tensor", "all_reduce"] * (
                    blocks * LAYERS) + ["all_gather_into_tensor",
                                        "all_reduce", "all_reduce"], r
        assert got[f"{c}/on/h"].tolist() == [[h.B, h.S // 4, d]] * LAYERS
        assert got[f"{c}/on/heads"].tolist() == [[1, 1]] * LAYERS


def test_dense_train_run_over_the_grid_follows_one_rank(grid_run):
    _, ranks, _ = grid_run
    one = train.run(train.parse_args(RUN), "cpu")["losses"]
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["run/losses"],
                                      ranks[0]["run/losses"])
        np.testing.assert_allclose(got["run/losses"], one, rtol=BF16)


@pytest.mark.parametrize("case", CASES)
def test_tp4_over_the_ep_group_alone_is_the_grid_layout(grid_run, case):
    """A context over the EP group alone, with no grid, takes TP by
    default (``lm.tensor_parallel`` reads the model group only): the (1,
    4) grid's loss and every gradient leaf, and ``train.run(ep_group=)``
    the grid run's losses, bit for bit."""
    _, ranks, _ = grid_run
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got[f"alone/{case}/loss"],
                                      got[f"{case}/loss"])
        keys = [k for k in got if k.startswith(f"{case}/g/")]
        assert keys and sorted(keys) == sorted(
            k[len("alone/"):] for k in got if k.startswith(f"alone/{case}/g/"))
        for k in keys:
            np.testing.assert_array_equal(got["alone/" + k], got[k],
                                          err_msg=f"rank {r} {k}")
        np.testing.assert_array_equal(got["alone/run/losses"],
                                      got["run/losses"])


# (n_heads, n_kv, m): whole groups, heads sharing one kv head, and heads
# and groups that do not divide each other (12 / 3 = 4 heads of groups of
# 3; 48 / 12 = 4 of 6), where the kv heads are repeated
KV_CASES = [(4, 2, 1), (4, 2, 2), (4, 2, 4), (16, 8, 2), (16, 8, 8),
            (32, 4, 2), (32, 4, 4), (32, 4, 8), (8, 8, 4), (12, 4, 2),
            (12, 4, 3), (12, 4, 4), (48, 8, 8), (48, 8, 12), (48, 8, 16)]


@pytest.mark.parametrize("n_heads,n_kv,m", KV_CASES)
def test_kv_heads_pair_each_local_head_with_the_reference_kv_head(
        n_heads, n_kv, m):
    """The kv heads model rank r reads: where they come back whole (no
    index), local head j reads the range's kv head ``j // G`` with G =
    min(g, hl), the flash kernel's group mapping; otherwise the index
    repeats them one a head.  Either way it is the reference's ``jnp.take``
    pairing, ``(r * hl + j) // g``."""
    hl, g = n_heads // m, n_heads // n_kv
    for r in range(m):
        kv, idx = tp_blocks.kv_heads(n_heads, n_kv, m, r)
        want = [(r * hl + j) // g for j in range(hl)]
        if idx is None:
            G = min(g, hl)
            assert len(kv) * G == hl
            got = [kv.start + j // G for j in range(hl)]
        else:
            assert len(idx) == hl
            got = [kv.start + i for i in idx]
        assert got == want, (r, kv, idx)
