"""Training over a (data, model) grid: the reduced ``qwen3-moe-30b-a3b``
through ``fused_hier`` (nodes of one lane, so stage 1 crosses nodes) and
``fused_flat``, and the reduced ``moe-tx-stream`` through the streamed
``fused_pipe`` (one block of both layers, 2 slices), in float32 on four gloo
ranks of a (2, 2) grid (``launch.mesh.make_host_mesh(2, 2)``: two data ranks
of an EP group of two), against the reference's ``make_train_step`` and
``jax.value_and_grad(lm.lm_loss)`` on a (2, 2) mesh (``torch_ep_train``).

Rank by rank: the loss (the whole batch's token-mean: the two data ranks'
rows hold different counts of labels), every gradient leaf, the traffic
state, the grad norm with clipping binding, after one step the params and
the rank's ZeRO-1 slices of mu, nu and master, and after two steps the
params; the replicated leaves hold the same bits on all four ranks and each
expert leaf on the two data ranks of its lane.  Each of three mutations of
the data sync misses the reference: the per-rank mean in place of the
global denominator, no data all-reduce of the expert gradients, and the
clip norm summed over the data ranks too.  Then: ``adamw.update`` at DP 2
on a tree with leaves no dim divides is the unsharded update; serial
accumulation over the grid syncs once a step; ``train.run`` over the grid
with ``--seq-migrate`` follows a hand loop; an eight-rank (2, 4) grid with
nodes of two builds every group and a ``fused_hier`` context in bounded
time.  Pure: ``host_mesh_shape`` is the reference's rule and
``adamw.zero_dim`` the reference's ``zero1_specs``.
Tolerance 1e-5 relative to each leaf's max(1, |x|); counts exactly.
"""

import datetime
import multiprocessing
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_ep_train as h
from torch_adam import close_updated
from repro_torch.configs import get_arch
from repro_torch.core import commplan, traffic
from repro_torch.data.pipeline import ZipfNgramLM, to_device
from repro_torch.launch import steps, train
from repro_torch.launch.mesh import host_mesh_shape, make_host_mesh
from repro_torch.launch.train import data_rows
from repro_torch.models import lm, zoo
from repro_torch.optim import adamw

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

SHAPE, NODE = (2, 2), 1
ARCH = "qwen3-moe-30b-a3b"
# (arch, ((engine, moe_stream, pipe_slices), ...))
ARCHS = ((ARCH, (("fused_hier", 0, 0), ("fused_flat", 0, 0))),
         ("moe-tx-stream", (("fused_pipe", 2, 2),)))
NAMES = [f"{e}/{s}" for _, cases in ARCHS for e, _, s in cases]
RUN = ["--reduced", "--steps", "3", "--seq", "16", "--batch", "8",
       "--seq-migrate"]
# a tree for ZeRO-1: leaves whose ZeRO dim at DP 2 is 0, 1, 2 (a
# lane-sharded leaf, its lane dim skipped) and none
ODD = {"a": (3, 5), "b": (3, 4), "c": (2, 3), "d": (1,),
       "layers": {"moe": {"w1": (1, 1, 4, 6)}}}


def _odd_update(mesh) -> dict:
    """Two AdamW steps of the ``ODD`` tree at DP 2 and without a data
    group, from the same seeded params and gradients: whether params,
    mu, nu and master (the rank's slice of the unsharded run's) hold the
    same bits."""
    gen = torch.Generator().manual_seed(1)
    rand = lambda shape: torch.randn(shape, generator=gen)
    base = adamw.tree_map(rand, ODD)
    grads = [adamw.tree_map(rand, ODD) for _ in range(2)]
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4,
                            clip_norm=0.5)
    runs = []
    for group in (mesh.data_group, None):
        p = adamw.tree_map(lambda t: t.clone(), base)
        opt = adamw.init(p, group, lm.lane_sharded)
        for g in grads:
            p, opt, _ = adamw.update(g, opt, p, cfg, sharded=lm.lane_sharded,
                                     data_group=group)
        runs.append((p, opt))
    (p, opt), (p1, opt1) = runs
    same = all(torch.equal(a, b) for a, b in zip(adamw.leaves(p),
                                                 adamw.leaves(p1)))
    for tree, whole in ((opt.mu, opt1.mu), (opt.nu, opt1.nu),
                        (opt.master, opt1.master)):
        for path, t, w in zip(adamw.paths(tree), adamw.leaves(tree),
                              adamw.leaves(whole)):
            dim = adamw.zero_dim(w.shape, 2, lm.lane_sharded(path))
            if dim is not None:
                n = w.shape[dim] // 2
                w = w.narrow(dim, mesh.data_index * n, n)
            same = same and torch.equal(t, w)
    sliced = [adamw.zero_dim(t.shape, 2, lm.lane_sharded(path))
              for path, t in zip(adamw.paths(p), adamw.leaves(p))]
    return {"extra/odd_same": np.array(same),
            "extra/odd_dims": np.array([-1 if d is None else d
                                        for d in sliced])}


def _accumulated(mesh) -> dict:
    """Serial accumulation (``accum=2``) of a batch of four over the grid:
    the data and lane reductions one call makes, and how far its gradients
    are from the mean of the two global micro-batches' (each synced), relative
    to max(1, |x|) of each leaf."""
    cfg = get_arch(ARCH).reduced()
    ctx = lm.make_context(cfg, "cpu", mesh=mesh, engine="fused_flat",
                          compute_dtype=torch.float32)
    model = zoo.build(cfg, ctx)
    p = lm.shard_params(lm.init_params(
        cfg, lm.make_context(cfg, "cpu"), torch.Generator().manual_seed(0),
        dtype=torch.float32), ctx)
    host = ZipfNgramLM(cfg.vocab, 16, 4, seed=0).batch_at(0)
    cut = lambda rows: to_device({k: v[rows] for k, v in host.items()}, "cpu")
    calls = []
    saved = steps.reduce_replicated, steps.reduce_lanes
    steps.reduce_replicated = lambda g, paths, group, *held: (
        calls.append("replicated"), saved[0](g, paths, group, *held))[1]
    steps.reduce_lanes = lambda g, paths, group, *held: (
        calls.append("lanes"), saved[1](g, paths, group, *held))[1]
    try:
        _, _, acc = steps.value_and_grad(model, accum=2)(
            p, cut(data_rows(4, 2, mesh.data_index, 2)))
    finally:
        steps.reduce_replicated, steps.reduce_lanes = saved
    micro = [steps.value_and_grad(model)(
        p, cut(2 * j + data_rows(2, 2, mesh.data_index)))[2]
        for j in range(2)]
    err = max(float((a - (g0 + g1) / 2).abs().max())
              / max(1.0, float(a.abs().max()))
              for a, g0, g1 in zip(acc, *micro, strict=True))
    return {"extra/accum_calls": np.array(calls, dtype=str),
            "extra/accum_err": np.array(err)}


def _seq_migrate_run(mesh) -> dict:
    """``train.run`` over the grid with ``--seq-migrate``, and a hand loop
    of the train step over the same setup: each global batch permuted by
    ``commplan.plan_sequence_migration`` of its rows' distinct-token
    counts, then cut to the data rank's rows."""
    args = train.parse_args(RUN)
    out = train.run(args, "cpu", mesh=mesh)
    s = train.setup(args, "cpu", mesh=mesh)
    model = zoo.build(s.cfg, s.ctx)
    step = steps.make_train_step(model, s.opt_cfg)
    params, opt = s.params, steps.init_state(model, s.params)
    state = train.init_traffic(s.cfg, s.ctx, 1)
    losses, moved, q = [], 0, args.batch // mesh.data
    for i in range(args.steps):
        host = s.source.batch_at(i)
        loads = np.array([len(np.unique(r)) for r in host["tokens"]], float)
        perm, stats = commplan.plan_sequence_migration(loads, mesh.data)
        moved += stats["rows_moved"]
        rows = perm[mesh.data_index * q:(mesh.data_index + 1) * q]
        batch = to_device({k: v[rows] for k, v in host.items()}, "cpu")
        params, opt, m = step(params, opt, batch, state)
        state = m["traffic"]
        losses.append(float(m["loss"]))
    res = {"extra/run_losses": np.array(out["losses"]),
           "extra/hand_losses": np.array(losses),
           "extra/run_moved": np.array(out["seq_migrate"]["rows_moved"]),
           "extra/hand_moved": np.array(moved)}
    for f in traffic.TrafficState._fields:
        res[f"extra/run/{f}"] = getattr(out["traffic"], f).numpy()
        res[f"extra/hand/{f}"] = getattr(state, f).numpy()
    return res


def _extra(rank, world):
    mesh = make_host_mesh(*SHAPE)
    return {**_odd_update(mesh), **_accumulated(mesh),
            **_seq_migrate_run(mesh)}


@pytest.fixture(scope="module")
def grid_run(tmp_path_factory):
    return h.run_grid(tmp_path_factory.mktemp("train_dp"), ARCHS, _extra,
                      shape=SHAPE, node=NODE)


@pytest.mark.parametrize("case", NAMES)
def test_grid_loss_grads_and_traffic_match_shard_map_rank_by_rank(grid_run,
                                                                  case):
    want, ranks, _ = grid_run
    for r, got in enumerate(ranks):
        h.check_grads(want, got, case, r, SHAPE)


@pytest.mark.parametrize("case", NAMES)
def test_grid_train_step_and_zero1_slices_match_rank_by_rank(grid_run, case):
    want, ranks, _ = grid_run
    for r, got in enumerate(ranks):
        h.check_step(want, got, case, r, SHAPE)
        # every leaf of the reduced models has a ZeRO dim at DP 2: each
        # rank holds half of the state
        held = sum(v.size for k, v in got.items()
                   if k.startswith(f"{case}/p/"))
        state = sum(v.size for k, v in got.items()
                    if k.startswith(f"{case}/master/"))
        assert 2 * state == held, (r, state, held)


@pytest.mark.parametrize("case", NAMES)
def test_grid_params_after_two_steps_match_and_keep_their_bits(grid_run,
                                                               case):
    """After two steps: each rank's params are the reference's (its lane of
    the expert leaves); the replicated leaves hold the same bits on all
    four ranks, and each expert leaf on the two data ranks of its lane."""
    want, ranks, _ = grid_run
    pre = f"{case}/p2/"
    for r, got in enumerate(ranks):
        keys = [k for k in want if k.startswith(pre)]
        assert keys and sorted(keys) == sorted(k for k in got
                                               if k.startswith(pre))
        for k in keys:
            path = k[len(pre):]
            close_updated(got[k], h.lane_of(want[k], path, r, SHAPE),
                          h.lane_of(h.update_room(want, case, path, 2), path,
                                    r, SHAPE), f"{case} rank {r} {k}")
    assert h.replicated_bits_differ(ranks, case) == []
    model = SHAPE[1]
    for k in ranks[0]:
        if k.startswith(pre) and lm.lane_sharded(k[len(pre):]):
            for lane in range(model):
                assert np.array_equal(ranks[lane][k],
                                      ranks[lane + model][k]), (k, lane)


# (mutation, what it must get wrong on every rank)
MISSES = {"permean": "loss", "nolanes": "g layers/moe/w1",
          "gridnorm": "grad_norm"}


@pytest.mark.parametrize("mutation", sorted(MISSES))
@pytest.mark.parametrize("case", NAMES)
def test_grid_sync_mutations_miss_the_reference(grid_run, case, mutation):
    """The per-rank mean in place of the global denominator misses the
    loss; no data all-reduce of the expert gradients misses them; the clip
    norm summed over the data ranks too misses the norm (AdamW's first
    step is blind to the gradients' scale)."""
    want, ranks, _ = grid_run
    for r, got in enumerate(ranks):
        missed = h.mutation_misses(want, got, case, r, mutation, SHAPE)
        assert MISSES[mutation] in missed, (r, missed)


def test_zero1_update_of_leaves_no_dim_divides_is_the_unsharded_update(
        grid_run):
    _, ranks, _ = grid_run
    for got in ranks:
        assert got["extra/odd_dims"].tolist() == [-1, 1, 0, -1, 2]
        assert bool(got["extra/odd_same"])


def test_serial_accumulation_over_the_grid_syncs_once_a_step(grid_run):
    """``accum=2`` over the grid: one reduction of the replicated leaves
    over the grid and one of the expert leaves over the data group, on the
    summed micro-batches; the gradients are the mean of the two global
    micro-batches' within 1e-5 of max(1, |x|)."""
    _, ranks, _ = grid_run
    for got in ranks:
        assert got["extra/accum_calls"].tolist() == ["replicated", "lanes"]
        assert float(got["extra/accum_err"]) <= h.TOL


def test_train_run_over_the_grid_with_seq_migrate_follows_a_hand_loop(
        grid_run):
    _, ranks, _ = grid_run
    for got in ranks:
        assert int(got["extra/run_moved"]) == int(got["extra/hand_moved"]) > 0
        np.testing.assert_array_equal(got["extra/run_losses"],
                                      got["extra/hand_losses"])
        np.testing.assert_array_equal(got["extra/run_losses"],
                                      ranks[0]["extra/run_losses"])
        for f in traffic.TrafficState._fields:
            np.testing.assert_array_equal(got[f"extra/run/{f}"],
                                          got[f"extra/hand/{f}"])


def _grid8_rank(rank, init_file, out_dir):
    """One rank of an eight-rank world: the default mesh, a fused_hier
    context with nodes of two, and one all-reduce of [rank, 1] on every
    group."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=8,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_host_mesh()
        cfg = get_arch(ARCH).reduced()
        ctx = lm.make_context(cfg, "cpu", mesh=mesh, engine="fused_hier",
                              node_size=2)
        out = {"shape": np.array([mesh.data, mesh.model])}
        for name, g in (("grid", mesh.grid), ("data", mesh.data_group),
                        ("ep", mesh.ep_group), ("node", ctx.ep_group.node)):
            t = torch.tensor([float(rank), 1.0])
            dist.all_reduce(t, group=g)
            out[name] = t.numpy()
        np.savez(f"{out_dir}/grid8-{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def test_grid_of_eight_builds_every_group_in_bounded_time(tmp_path):
    """(2, 4) from eight ranks, as the reference's host mesh; fused_hier's
    node groups of both EP domains made on every rank in one order: each
    group's all-reduce sums exactly its ranks.  A rank that is not done in
    120 s fails the test."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_grid8_rank,
                         args=(r, str(tmp_path / "rdv"), str(tmp_path)))
             for r in range(8)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 120
    for p in procs:
        p.join(timeout=max(0.0, deadline - time.monotonic()))
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not any(alive), alive
    assert [p.exitcode for p in procs] == [0] * 8
    for r in range(8):
        got = np.load(tmp_path / f"grid8-{r}.npz")
        d, m = divmod(r, 4)
        node = 4 * d + 2 * (m // 2)
        assert got["shape"].tolist() == [2, 4]
        assert got["grid"].tolist() == [28, 8]
        assert got["data"].tolist() == [2 * m + 4, 2]
        assert got["ep"].tolist() == [16 * d + 6, 4]
        assert got["node"].tolist() == [2 * node + 1, 2]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_host_mesh_shape_is_the_reference_rule(n, monkeypatch):
    """The reference's ``make_host_mesh`` over ``n`` devices (its device
    list and mesh constructor stubbed, so the rule alone runs)."""
    from repro.launch import mesh as ref
    monkeypatch.setattr(ref.jax, "devices", lambda: list(range(n)))
    monkeypatch.setattr(ref, "make_mesh", lambda shape, axes: tuple(shape))
    assert host_mesh_shape(n) == ref.make_host_mesh()
    assert host_mesh_shape(n, 1, n) == ref.make_host_mesh(1, n)


def test_host_mesh_shape_refuses_a_grid_the_world_does_not_fill():
    with pytest.raises(ValueError):
        host_mesh_shape(8, 2, 2)


@pytest.mark.parametrize("dp", [2, 4])
def test_zero_dim_is_the_reference_zero1_specs(dp):
    """The port's ZeRO dim of every leaf of the reduced and full models'
    trees (their lanes cut to one, as a rank of an EP group holds them) and
    of odd shapes, against ``repro.optim.adamw.zero1_specs`` fed the port's
    layout: ``P(None, "model", ...)`` for the expert leaves, replicated
    otherwise."""
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.optim.adamw import zero1_specs
    shapes = {}
    for arch in (ARCH, "moe-tx-stream"):
        for cfg in (get_arch(arch).reduced(), get_arch(arch)):
            for L in sorted({1, 2, cfg.n_layers}):
                d, f = cfg.d_model, cfg.moe.d_ff_expert
                e = cfg.moe.n_experts // 4
                shapes.update({
                    f"{cfg.name}{L}/embed": (cfg.vocab, d),
                    f"{cfg.name}{L}/ln1": (L, d),
                    f"{cfg.name}{L}/q_norm": (L, cfg.hd),
                    f"{cfg.name}{L}/router": (L, d, cfg.moe.n_experts),
                    f"{cfg.name}{L}/layers/moe/w1": (L, 1, e, d, f),
                    f"{cfg.name}{L}/layers/moe/w2": (L, 1, e, f, d)})
    shapes.update({"odd/a": (3, 5), "odd/b": (3, 4), "odd/c": (1,),
                   "odd/d": (), "odd/layers/moe/w1": (1, 1, 3, 6),
                   "odd/layers/moe/w3": (1, 1, 1, 5)})
    lane = lambda k: lm.lane_sharded(k.split("/", 1)[1])
    specs = {k: P(None, "model", *([None] * (len(s) - 2))) if lane(k)
             else P(*([None] * len(s))) for k, s in shapes.items()}
    structs = {k: jax.ShapeDtypeStruct(s, np.float32)
               for k, s in shapes.items()}
    ref = zero1_specs(specs, structs, dp)
    for k, s in shapes.items():
        want = [i for i, a in enumerate(ref[k]) if a == "data"]
        got = adamw.zero_dim(s, dp, lane(k))
        assert ([] if got is None else [got]) == want, (k, s, ref[k], got)
