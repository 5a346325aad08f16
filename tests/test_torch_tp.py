"""Megatron-SP tensor parallelism on a (2, 2) (data, model) grid of four
gloo ranks: the reduced ``qwen3-1.7b`` (dense: attention and MLP TP, 2
heads a rank of 4, group size 2) and the reduced ``qwen3-moe-30b-a3b`` (TP
attention beside EP 2 through ``fused_flat`` and ``fused_hier``, nodes of
one lane), float32, against the reference's ``make_train_step`` and
``jax.value_and_grad(lm.lm_loss)`` with its default ``explicit_tp=True`` on
a (2, 2) mesh (``torch_ep_train.run_grid(tp=True)``).

Rank by rank, at ``torch_ep_train``'s tolerances: the loss, every gradient
leaf (a TP leaf's this rank's shard, an expert leaf's its lane), the
traffic state, the clip norm with clipping binding, after one step the
params and the ZeRO-1 slices of mu, nu and master of the rank's shards,
after two steps the params; the replicated leaves hold the same bits on
all four ranks, each TP shard and expert lane on both data ranks.  On the
same ranks (``torch_ep_train.tp_probe``): ``explicit_tp=False`` gives the
same loss, clip norm and gradients within 1e-6 of max(1, |x|); one forward
launches per TP sub-block one sequence all-gather and one reduce-scatter
(gloo runs it as an all-reduce) and, in a moe layer, no gather of the MoE
output; h enters each layer as (B / 2, S / 2, d) and q reaches the flash
call with 2 heads.  FSDP of the experts beside TP: rank by rank against
the reference under ``fsdp_experts`` (``run_grid(fsdp=True, tp=True)``,
fused_flat): the loss, every gradient leaf, the clip norm, after one step
the params, mu, nu and master, after two the params; and the clip norm
and loss of the ZeRO-1 grid.  A checkpoint of the TP grid's train state holds
the whole leaves in the reference's layout, bit for bit (the reference's
``checkpointer.restore`` reads each rank's shards and slices back); restored
onto (2, 2) it is the same bits, and onto two (1, 2) grids and one rank it
gives the same loss.  In process: ``convert.params_from_jax(..., model=(m,
r))`` is the reference's shard r of each TP leaf, and prefill refuses a TP
context.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_ep_train as h
from torch_adam import close_updated
from repro.checkpoint import checkpointer as jckpt
from repro.optim import adamw as jadamw
from repro.parallel.sharding import param_specs as jparam_specs
from repro_torch import convert
from repro_torch.checkpoint import checkpointer
from repro_torch.configs import get_arch
from repro_torch.core import traffic
from repro_torch.launch import steps
from repro_torch.launch.mesh import HostMesh, make_host_mesh
from repro_torch.launch.train import data_rows
from repro_torch.models import lm, zoo
from repro_torch.optim import adamw
from repro_torch.parallel import sharding
from repro_torch.runtime import elastic

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

SHAPE, NODE = (2, 2), 1
DENSE, MOE = "qwen3-1.7b", "qwen3-moe-30b-a3b"
# (arch, ((engine, moe_stream, pipe_slices), ...)); the dense family has no
# engine, "dense" names its case
ARCHS = ((DENSE, (("dense", 0, 0),)),
         (MOE, (("fused_flat", 0, 0), ("fused_hier", 0, 0))))
CASES = [f"{e}/{s}" for _, cases in ARCHS for e, _, s in cases]
LAYERS = 2
CAPACITY = 8.0            # the checkpoint's grids: no drops at EP 1 or 2,
                          # whatever each rank's token count
TOL_OFF = 1e-6            # TP off against on: the same function
# FSDP of the experts beside TP: the moe arch through fused_flat
FSDP_ARCHS = ((MOE, (("fused_flat", 0, 0),)),)
FSDP_CASE = "fused_flat/0"


def _cold(cfg, ep):
    return traffic.init_traffic_state(cfg.moe.n_experts, ep,
                                      n_layers=cfg.n_layers)


def _ckpt(ckpt: str, rank: int) -> dict:
    """The moe arch's TP grid trained one step through fused_flat and
    saved (``checkpointer.context_layout``); each rank's held state, the
    global loss at those params, the (2, 2) restore's bits and loss, and
    the loss of a (1, 2) grid (ranks {0, 1} and {2, 3}) restored from
    it on the whole batch."""
    mesh = make_host_mesh(*SHAPE)
    cfg = get_arch(MOE).reduced()
    tree = h.nest(h.params(MOE, ep=SHAPE[1], node=NODE).items())
    lane = rank % SHAPE[1]
    whole = {k: torch.from_numpy(v).long()
             for k, v in h.batch(cfg.vocab).items()}
    rows = data_rows(h.B, mesh.data, mesh.data_index)
    bt = {k: v[rows] for k, v in whole.items()}
    ctx = lm.make_context(cfg, "cpu", mesh=mesh, engine="fused_flat",
                          node_size=NODE, compute_dtype=torch.float32,
                          capacity_factor=CAPACITY)
    model = zoo.build(cfg, ctx)
    p = convert.params_from_jax(tree, "cpu", lane=lane,
                                model=(SHAPE[1], lane))
    step = steps.make_train_step(model, adamw.AdamWConfig(**h.OPT))
    p, opt, _ = step(p, steps.init_state(model, p), bt, _cold(cfg, 2))
    lay = checkpointer.context_layout(ctx)
    assert lay.tp and lay.dp == 2 and lay.ep == 2
    assert lay.vocab == (cfg.vocab, cfg.d_model)
    checkpointer.wait(checkpointer.save(ckpt, (p, opt), 1, lay=lay))
    out = {}
    for path, t in checkpointer._flatten((p, opt)):
        out["held/" + "/".join(map(str, path))] = (
            t.detach().numpy().copy() if isinstance(t, torch.Tensor)
            else np.asarray(t, np.int32))
    out["ck/loss22"] = steps.value_and_grad(model)(p, bt,
                                                   _cold(cfg, 2))[0].numpy()
    gen = torch.Generator().manual_seed(1)
    like = lm.init_params(cfg, ctx, gen, dtype=torch.float32)
    got, _ = elastic.remesh_restore(
        ckpt, (like, steps.init_state(model, like)), mesh, tp=True,
        vocab=lay.vocab)
    out["ck/same22"] = np.array(all(
        torch.equal(a, b) for (_, a), (_, b) in zip(
            checkpointer._flatten(got[0]), checkpointer._flatten(p))) and all(
        torch.equal(a, b) for a, b in zip(
            adamw.leaves(got[1].master) + adamw.leaves(got[1].mu),
            adamw.leaves(opt.master) + adamw.leaves(opt.mu))))
    out["ck/loss22r"] = steps.value_and_grad(model)(
        got[0], bt, _cold(cfg, 2))[0].numpy()
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    pair = pairs[rank // 2]
    m12 = HostMesh(1, 2, None, pair, pair)
    ctx12 = lm.make_context(cfg, "cpu", mesh=m12, engine="fused_flat",
                            node_size=NODE, compute_dtype=torch.float32,
                            capacity_factor=CAPACITY)
    assert lm.tensor_parallel(ctx12)
    model12 = zoo.build(cfg, ctx12)
    like = lm.init_params(cfg, ctx12, gen, dtype=torch.float32)
    got, _ = elastic.remesh_restore(
        ckpt, (like, steps.init_state(model12, like)), m12, tp=True,
        vocab=(cfg.vocab, cfg.d_model))
    out["ck/loss12"] = model12.loss(got[0], whole,
                                    traffic=_cold(cfg, 2))[0].detach().numpy()
    return out


def _fsdp(rank: int) -> dict:
    """One step of the moe arch's TP grid with FSDP of the experts on and
    off: the clip norm and the loss."""
    mesh = make_host_mesh(*SHAPE)
    cfg = get_arch(MOE).reduced()
    tree = h.nest(h.params(MOE, ep=SHAPE[1], node=NODE).items())
    lane = rank % SHAPE[1]
    rows = data_rows(h.B, mesh.data, mesh.data_index)
    bt = {k: torch.from_numpy(v[rows]).long()
          for k, v in h.batch(cfg.vocab).items()}
    out = {}
    for fsdp in (True, False):
        ctx = lm.make_context(cfg, "cpu", mesh=mesh, engine="fused_hier",
                              node_size=NODE, compute_dtype=torch.float32,
                              fsdp_experts=fsdp)
        assert lm.tensor_parallel(ctx)
        model = zoo.build(cfg, ctx)
        p = convert.params_from_jax(
            tree, "cpu", lane=lane, model=(SHAPE[1], lane),
            data=(mesh.data, mesh.data_index) if fsdp else None)
        step = steps.make_train_step(model, adamw.AdamWConfig(**h.OPT))
        _, _, m = step(p, steps.init_state(model, p), bt, _cold(cfg, 2))
        out[f"fsdp/{fsdp}/norm"] = m["grad_norm"].numpy()
        out[f"fsdp/{fsdp}/loss"] = m["loss"].numpy()
    return out


def _extra(ckpt, rank, world):
    return {**h.tp_probe(SHAPE, NODE, ARCHS, rank, world),
            **_ckpt(ckpt, rank), **_fsdp(rank)}


@pytest.fixture(scope="module")
def grid_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    ckpt = str(tmp / "ckpt")
    want, ranks, ps = h.run_grid(tmp, ARCHS, functools.partial(_extra, ckpt),
                                 shape=SHAPE, node=NODE, tp=True)
    return want, ranks, ps, ckpt


@pytest.mark.parametrize("case", CASES)
def test_tp_grid_loss_grads_and_traffic_match_shard_map_rank_by_rank(
        grid_run, case):
    want, ranks, _, _ = grid_run
    for r, got in enumerate(ranks):
        h.check_grads(want, got, case, r, SHAPE, tp=True)


@pytest.mark.parametrize("case", CASES)
def test_tp_grid_train_step_and_zero1_slices_match_rank_by_rank(grid_run,
                                                                case):
    want, ranks, _, _ = grid_run
    for r, got in enumerate(ranks):
        h.check_step(want, got, case, r, SHAPE, tp=True)
        # a TP rank holds half of each TP leaf
        for path in sharding.TP_DIM:
            key = f"{case}/p/{path}"
            if key in got:
                assert 2 * got[key].size == want[key].size, (r, path)


@pytest.mark.parametrize("case", CASES)
def test_tp_grid_params_after_two_steps_match_and_keep_their_bits(grid_run,
                                                                  case):
    """After two steps: each rank's params are the reference's (its TP
    shards and expert lane); the replicated leaves hold the same bits on
    all four ranks, each TP shard and lane on the two data ranks that hold
    it."""
    want, ranks, _, _ = grid_run
    pre = f"{case}/p2/"
    for r, got in enumerate(ranks):
        keys = [k for k in want if k.startswith(pre)]
        assert keys and sorted(keys) == sorted(k for k in got
                                               if k.startswith(pre))
        for k in keys:
            path = k[len(pre):]
            close_updated(got[k], h.lane_of(want[k], path, r, SHAPE, tp=True),
                          h.lane_of(h.update_room(want, case, path, 2), path,
                                    r, SHAPE, tp=True), f"{case} rank {r} {k}")
    assert h.replicated_bits_differ(ranks, case, tp=True) == []
    model = SHAPE[1]
    for k in ranks[0]:
        path = k[len(pre):]
        if k.startswith(pre) and (lm.lane_sharded(path)
                                  or sharding.tp_sharded(path)):
            for lane in range(model):
                assert np.array_equal(ranks[lane][k],
                                      ranks[lane + model][k]), (k, lane)
                assert not np.array_equal(ranks[0][k], ranks[1][k]), k


@pytest.mark.parametrize("case", CASES)
def test_tp_off_is_the_same_function_in_another_layout(grid_run, case):
    """``explicit_tp=False`` on the same ranks: the same loss, clip norm
    and gradients (each TP shard against its cut of the replicated
    layout's) within 1e-6 of max(1, |x|)."""
    _, ranks, _, _ = grid_run
    c = f"{case}/tp"
    for r, got in enumerate(ranks):
        for what in ("loss", "grad_norm"):
            on, off = got[f"{c}/on/{what}"], got[f"{c}/off/{what}"]
            assert abs(float(on) - float(off)) <= TOL_OFF * max(
                1.0, abs(float(off))), (r, what, on, off)
        assert float(got[f"{c}/err"]) <= TOL_OFF, (r, got[f"{c}/err"])


@pytest.mark.parametrize("case", CASES)
def test_tp_collectives_and_shapes_per_layer(grid_run, case):
    """One forward of the loss under TP: per layer one sequence all-gather
    and one reduce-scatter per TP sub-block (two in a dense layer, one in a
    moe layer, whose MoE output is not gathered), and one all-gather of
    the final stripes into the head; at the dist level the dense family
    launches nothing else but the vocab-parallel embed's reduce-scatter
    and the CE's two all-reduces (its max, then Σ exp with the gold logit;
    gloo runs a reduce-scatter as an all-reduce); h enters each layer as
    this rank's (B / 2, S / 2, d) and q reaches the flash call with 2 of 4
    heads beside 1 kv head.  Off: no TP block, the MoE output gathered
    once a layer; the dense family's embed all-reduce and the CE's two."""
    _, ranks, _, _ = grid_run
    c = f"{case}/tp"
    dense = case.startswith("dense")
    blocks = 2 if dense else 1
    d = get_arch(MOE).reduced().d_model
    for r, got in enumerate(ranks):
        log = list(got[f"{c}/on/log"])
        assert log.count("all_gather_seq") == blocks * LAYERS + 1, (r, log)
        assert log.count("reduce_scatter_seq") == blocks * LAYERS, (r, log)
        assert "moe_gather" not in log, (r, log)
        assert list(got[f"{c}/off/log"]) == ([] if dense else
                                             ["moe_gather"] * LAYERS)
        if dense:
            calls = list(got[f"{c}/on/calls"])
            assert calls == ["all_reduce"] + [
                "all_gather_into_tensor", "all_reduce"] * (
                blocks * LAYERS) + ["all_gather_into_tensor", "all_reduce",
                                    "all_reduce"], (r, calls)
            assert list(got[f"{c}/off/calls"]) == ["all_reduce"] * 3
        assert got[f"{c}/on/h"].tolist() == [[h.B // 2, h.S // 2, d]] * LAYERS
        assert got[f"{c}/on/heads"].tolist() == [[2, 1]] * LAYERS
        assert got[f"{c}/off/h"].size == 0


@pytest.fixture(scope="module")
def fsdp_run(tmp_path_factory):
    """The moe arch through fused_flat on the (2, 2) grid with FSDP of the
    experts beside Megatron TP, the port's ranks and the reference's
    ``make_train_step`` (its default explicit TP) both under
    ``fsdp_experts``."""
    tmp = tmp_path_factory.mktemp("tp_fsdp")
    want, ranks, _ = h.run_grid(tmp, FSDP_ARCHS, shape=SHAPE, node=NODE,
                                fsdp=True, tp=True)
    return want, ranks


def test_tp_with_fsdp_experts_grads_match_rank_by_rank(fsdp_run):
    """FSDP of the experts beside TP against the reference: on each rank
    the loss, every gradient leaf (a TP leaf's shard, summed over the data
    group; an expert leaf's f-slice of its lane, reduce-scattered) and the
    traffic state."""
    want, ranks = fsdp_run
    for r, got in enumerate(ranks):
        h.check_grads(want, got, FSDP_CASE, r, SHAPE, fsdp=True, tp=True)


def test_tp_with_fsdp_experts_step_matches_rank_by_rank(fsdp_run):
    """The clip norm (each TP shard's squares counted once over the grid,
    binding), the step's loss, and after one step the params, mu, nu and
    master each rank holds; after two, the params."""
    want, ranks = fsdp_run
    pre = f"{FSDP_CASE}/p2/"
    for r, got in enumerate(ranks):
        h.check_step(want, got, FSDP_CASE, r, SHAPE, fsdp=True, tp=True)
        keys = [k for k in want if k.startswith(pre)]
        assert keys and sorted(keys) == sorted(k for k in got
                                               if k.startswith(pre))
        for k in keys:
            path = k[len(pre):]
            cut = functools.partial(h.lane_of, path=path, rank=r, shape=SHAPE,
                                    fsdp=True, tp=True)
            close_updated(got[k], cut(want[k]),
                          cut(h.update_room(want, FSDP_CASE, path, 2)),
                          f"rank {r} {k}")


def test_tp_with_fsdp_experts_keeps_the_clip_norm(grid_run):
    """FSDP of the experts beside TP: each TP shard's squares counted once
    over the grid (``adamw.global_norm``'s 1/DP weight): the ZeRO-1 grid's
    clip norm and loss within 1e-6."""
    _, ranks, _, _ = grid_run
    for r, got in enumerate(ranks):
        for what in ("norm", "loss"):
            on, off = float(got[f"fsdp/True/{what}"]), float(
                got[f"fsdp/False/{what}"])
            assert abs(on - off) <= TOL_OFF * max(1.0, abs(off)), (r, what)


def test_tp_checkpoint_is_the_reference_layout_and_restores_anywhere(
        grid_run):
    _, ranks, _, ckpt = grid_run
    cfg = get_arch(MOE).reduced()
    like = lm.init_params(cfg, _two_lanes(cfg),
                          torch.Generator().manual_seed(2),
                          dtype=torch.float32)
    (params, opt), step = elastic.remesh_restore(ckpt, (like,
                                                        adamw.init(like)))
    assert step == 1
    whole = {"0/" + "/".join(p): t.numpy()
             for p, t in checkpointer._flatten(params)}
    for kind, tree in (("mu", opt.mu), ("nu", opt.nu),
                       ("master", opt.master)):
        whole.update({f"1/{kind}/" + "/".join(p): t.numpy()
                      for p, t in checkpointer._flatten(tree)})
    # the reference reads the same whole leaves
    zeros = lambda t: adamw.tree_map(
        lambda x: jnp.zeros(tuple(x.shape), jnp.float32), t)
    ref, _ = jckpt.restore(ckpt, (zeros(like), jadamw.AdamWState(
        jnp.int32(0), zeros(like), zeros(like), zeros(like))))
    got_ref = [np.asarray(x) for x in
               [a for _, a in checkpointer._flatten(
                   (ref[0], (ref[1].mu, ref[1].nu, ref[1].master)))]]
    mine = [a.numpy() for _, a in checkpointer._flatten(
        (params, (opt.mu, opt.nu, opt.master)))]
    assert len(got_ref) == len(mine)
    for a, b in zip(got_ref, mine):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # each rank's held shards and slices are cuts of the file's leaves
    for r, got in enumerate(ranks):
        for key, w in whole.items():
            params_leaf = key.startswith("0/")
            path = key.split("/", 1 if params_leaf else 2)[-1]
            cut = h.lane_of if params_leaf else h.state_of_rank
            np.testing.assert_array_equal(
                got[f"held/{key}"], cut(w, path, r, SHAPE, tp=True),
                err_msg=f"rank {r} {key}")
        assert bool(got["ck/same22"]), r
        loss = float(got["ck/loss22"])
        assert float(got["ck/loss22r"]) == loss, r
        assert abs(float(got["ck/loss12"]) - loss) <= TOL_OFF * loss, r
    # one rank: the experts regrouped into its one lane
    batch = {k: torch.from_numpy(v).long()
             for k, v in h.batch(cfg.vocab).items()}
    one = lm.make_context(cfg, "cpu", compute_dtype=torch.float32,
                          capacity_factor=CAPACITY)
    loss1 = float(lm.lm_loss(lm.shard_params(params, one), batch, one,
                             traffic=_cold(cfg, 1))[0])
    assert abs(loss1 - float(ranks[0]["ck/loss22"])) <= TOL_OFF * loss1


def _two_lanes(cfg):
    """A one-rank context whose placement is the grid's (2 lanes, nodes of
    one): the whole tree's shapes."""
    ctx = lm.make_context(cfg, "cpu", compute_dtype=torch.float32)
    return dataclasses.replace(ctx, placement=dataclasses.replace(
        ctx.placement, ep=SHAPE[1], node_size=NODE))


@pytest.mark.parametrize("m", (2, 4))
def test_convert_cuts_the_reference_tp_shard(m):
    """``convert.params_from_jax(..., model=(m, r))`` holds, of each leaf
    the reference's ``param_specs`` puts on "model" and the port splits by
    TP or by the vocab split of training (``embed``, ``lm_head``), the
    r-th of m equal blocks on that dim: the reference's shard r; every
    other leaf whole.  A TP context refuses to prefill."""
    for arch in (DENSE, MOE):
        flat = h.params(arch, ep=1, node=1)
        tree = h.nest(flat.items())
        specs = h.flat(jparam_specs(
            h.nest((k, jnp.zeros(v.shape)) for k, v in flat.items()),
            multi_pod=False, model_size=m))
        for r in range(m):
            got = h.flat(convert.params_from_jax(tree, "cpu",
                                                 model=(m, r)))
            for path, a in flat.items():
                split = (sharding.tp_dim(path) if sharding.tp_sharded(path)
                         else sharding.vocab_dim(path, a.shape, m))
                if split is None:
                    np.testing.assert_array_equal(got[path].numpy(), a)
                    continue
                dims = tuple(specs[path]) + (None,) * a.ndim
                dim = [i for i, x in enumerate(dims[:a.ndim])
                       if x in ("model", ("model",))]
                assert dim == [split % a.ndim], path
                shard = np.split(a, m, axis=dim[0])[r]
                np.testing.assert_array_equal(got[path].numpy(), shard)


class _Grid:
    """A stand-in (data, model) grid: a model group of ``model`` ranks."""
    data, data_group, grid = 1, None, None

    def __init__(self, model):
        self.model, self.ep_group = model, "model"


def test_prefill_refuses_a_tp_context(monkeypatch):
    cfg = get_arch(DENSE).reduced()
    monkeypatch.setattr(lm, "group_size", lambda g: 2 if g == "model" else 1)
    ctx = lm.make_context(cfg, "cpu", mesh=_Grid(2))
    assert lm.tensor_parallel(ctx)
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="explicit_tp=False"):
        lm.prefill({}, tokens, torch.arange(4), ctx, 8)
