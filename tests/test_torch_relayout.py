"""The load-adaptive re-layout of the port against the JAX package:
``core/relayout.py`` (the table placement, its maps, the solver copied from
the reference, the migration) and ``launch/train.apply_relayout`` /
``--relayout-every`` at EP = 1.

Integer outputs (tables, maps, replica choices, plans, gather indices)
agree exactly.  Migrations that gather one copy are exact; the float32
replica mean to 1e-6 relative (the replicas are summed in another order),
the bfloat16 one to one bfloat16 rounding.  The loss at fixed parameters and
batch before and after a migration agrees to 1e-5 relative in float32: a
relayout only moves which slot hosts which expert.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import make_mesh
from repro.configs import get_arch as jget_arch
from repro.core import planner as jplanner
from repro.core import relayout as jrelayout
from repro.core import routing as jrouting
from repro.core import traffic as jtraffic
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core import fusco, planner, relayout, routing
from repro_torch.core.dcomm import DcommConfig
from repro_torch.data import pipeline
from repro_torch.launch import steps, train
from repro_torch.models import lm, zoo
from repro_torch.optim import adamw

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

# (ep, node_size, slots_per_lane, n_experts): replicated and permutation
# tables, one node and several
GRIDS = [(4, 2, 4, 12), (8, 4, 2, 12), (8, 2, 3, 16), (2, 1, 5, 8),
         (4, 4, 2, 8), (1, 1, 8, 8)]


def _loads(kind: str, n: int, seed: int = 0) -> np.ndarray:
    if kind == "zipf":
        return 1.0 / np.arange(1, n + 1)
    if kind == "uniform":
        return np.random.default_rng(seed).random(n) + 0.1
    loads = np.ones(n)                                   # single hot expert
    loads[seed % n] = 100.0
    return loads


def _pair(kind, ep, ns, spl, e):
    """The port's and the reference's solver on the same loads."""
    loads = _loads(kind, e, seed=ep + spl)
    return (relayout.solve_placement(loads, ep=ep, node_size=ns,
                                     slots_per_lane=spl),
            jrelayout.solve_placement(loads, ep=ep, node_size=ns,
                                      slots_per_lane=spl))


@pytest.mark.parametrize("kind", ["zipf", "uniform", "hot"])
@pytest.mark.parametrize("ep,ns,spl,e", GRIDS)
def test_solver_tables_are_the_references(kind, ep, ns, spl, e):
    mine, ref = _pair(kind, ep, ns, spl, e)
    np.testing.assert_array_equal(mine.lane_expert, np.asarray(ref.lane_expert))
    for name in ("n_replicas", "replica_lanes", "replica_slots"):
        np.testing.assert_array_equal(getattr(mine, name),
                                      np.asarray(getattr(ref, name)), name)
    assert (mine.ep, mine.n_nodes, mine.experts_per_lane, mine.max_replicas) \
        == (ref.ep, ref.n_nodes, ref.experts_per_lane, ref.max_replicas)
    loads = _loads(kind, e)
    np.testing.assert_allclose(relayout.lane_loads(loads, mine),
                               jrelayout.lane_loads(loads, ref), rtol=1e-12)


@pytest.mark.parametrize("table,n_experts,node_size", [
    ([[0, 1], [2, 0]], 4, 1),        # expert 3 hosted nowhere
    ([[0, 0], [1, 2]], 3, 1),        # a duplicate on one lane
    ([[0, 1], [2, 5]], 4, 1),        # an id out of range
    ([[0, 1], [2, 3]], 4, 3),        # ep not divisible by the node size
])
def test_invalid_tables_raise_as_the_references(table, n_experts, node_size):
    for cls in (relayout.TablePlacement, jrelayout.TablePlacement):
        with pytest.raises(ValueError):
            cls(np.array(table), node_size=node_size, n_experts=n_experts)
    for solve in (relayout.solve_placement, jrelayout.solve_placement):
        with pytest.raises(ValueError):        # slots > experts, too few slots
            solve(np.ones(2), ep=2, node_size=1, slots_per_lane=3)
        with pytest.raises(ValueError):
            solve(np.ones(9), ep=2, node_size=1, slots_per_lane=4)


@pytest.mark.parametrize("ep,ns,spl,e", GRIDS[:4])
def test_table_maps_match_the_references_under_every_choice(ep, ns, spl, e):
    mine, ref = _pair("zipf", ep, ns, spl, e)
    rng = np.random.default_rng(ep * spl)
    A = rng.integers(0, e, (40, 3)).astype(np.int32)
    At, Aj = torch.from_numpy(A), jnp.asarray(A)
    rep_t = routing.balanced_replica_choice(At, mine)
    rep_j = jrouting.balanced_replica_choice(Aj, ref)
    np.testing.assert_array_equal(rep_t.numpy(), np.asarray(rep_j))
    rnd = rng.integers(0, 64, A.shape).astype(np.int32)
    for ct, cj in ((None, None), (rep_t, rep_j),
                   (torch.from_numpy(rnd), jnp.asarray(rnd))):
        lane = mine.lane_of_expert(At, ct)
        slot = mine.local_expert_index(At, ct)
        np.testing.assert_array_equal(lane.numpy(),
                                      np.asarray(ref.lane_of_expert(Aj, cj)))
        np.testing.assert_array_equal(slot.numpy(), np.asarray(
            ref.local_expert_index(Aj, cj)))
        # the (lane, slot) pair addresses the expert under any choice
        np.testing.assert_array_equal(mine.lane_expert[lane, slot], A)
        np.testing.assert_array_equal(
            mine.node_of_lane(lane).numpy(), np.asarray(ref.node_of_lane(
                jnp.asarray(lane.numpy()))))
    np.testing.assert_array_equal(mine.replica_count(At).numpy(),
                                  np.asarray(ref.replica_count(Aj)))
    # the index tensors are built once per device and reused
    assert mine._tables(At.device) is mine._tables(At.device)
    assert mine != relayout.TablePlacement(mine.lane_expert, node_size=ns,
                                           n_experts=e)   # identity equality


@pytest.mark.parametrize("e,ep,ns", [(16, 8, 4), (2, 8, 4), (8, 1, 1)])
def test_placement_views_of_both_classes_match_the_references(e, ep, ns):
    arith = routing.ExpertPlacement(e, ep, ns)
    jarith = jrouting.ExpertPlacement(e, ep, ns)
    np.testing.assert_array_equal(relayout.placement_table(arith),
                                  jrelayout.placement_table(jarith))
    np.testing.assert_array_equal(relayout.replica_counts(arith),
                                  jrelayout.replica_counts(jarith))
    loads = _loads("uniform", e)
    np.testing.assert_allclose(relayout.lane_loads(loads, arith),
                               jrelayout.lane_loads(loads, jarith))
    # the arithmetic table as a TablePlacement gives the arithmetic maps
    tbl = relayout.TablePlacement(relayout.placement_table(arith),
                                  node_size=ns, n_experts=e)
    A = torch.from_numpy(np.random.default_rng(e).integers(
        0, e, (24, 2)).astype(np.int32))
    for p in (arith, tbl):
        rep = routing.balanced_replica_choice(A, p)
        lane, slot = p.lane_of_expert(A, rep), p.local_expert_index(A, rep)
        np.testing.assert_array_equal(
            relayout.placement_table(arith)[lane, slot], A.numpy())
    np.testing.assert_array_equal(
        routing.balanced_replica_choice(A, tbl).numpy(),
        routing.balanced_replica_choice(A, arith).numpy())


def _flat_j(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_j(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ep,ns,spl,e", [(4, 2, 4, 12), (8, 2, 3, 16)])
def test_migration_matches_the_reference(dtype, ep, ns, spl, e):
    """From a replicated table onto another (the mean of drifted replicas),
    from the arithmetic placement (a gather), and the gather index and
    stats; ``lane_axis`` 1 as train's leaves (L, ep, spl, d, f)."""
    old, jold = _pair("zipf", ep, ns, spl, e)
    new, jnew = _pair("hot", ep, ns, spl, e)
    assert old.max_replicas > 1
    rng = np.random.default_rng(1)
    w = rng.standard_normal((2, ep, spl, 3, 5)).astype(np.float32)
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    wt = torch.from_numpy(w).to(tdt)
    wj = jnp.asarray(w).astype(jdt)
    got = relayout.migrate_lane_major(wt, old, new, lane_axis=1)
    want = np.asarray(jrelayout.migrate_lane_major(wj, jold, jnew,
                                                   lane_axis=1), np.float32)
    assert got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    else:       # one bfloat16 rounding of float32 means within 1e-6
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8,
                                   atol=1e-6)
    flat = wt[0].reshape(ep * spl, 3, 5)
    canon = relayout.replica_mean_canonical(flat, old)
    jcanon = jrelayout.replica_mean_canonical(
        wj[0].reshape(ep * spl, 3, 5), jold)
    np.testing.assert_allclose(canon.float().numpy(),
                               np.asarray(jcanon, np.float32),
                               rtol=1e-6 if dtype == "float32" else 2 ** -8,
                               atol=1e-6)
    # from the arithmetic placement (no replicas): an exact gather
    if e % ep == 0:
        arith = routing.ExpertPlacement(e, ep, ns)
        warith = torch.from_numpy(rng.standard_normal(
            (2, ep, e // ep, 3)).astype(np.float32)).to(tdt)
        table = relayout.solve_placement(_loads("hot", e), ep=ep, node_size=ns,
                                         slots_per_lane=e // ep)
        got = relayout.migrate_lane_major(warith, arith, table, lane_axis=1)
        idx = relayout.migration_gather_index(arith, table).long()
        np.testing.assert_array_equal(
            got.reshape(2, e, 3).float().numpy(),
            warith.reshape(2, e, 3)[:, idx].float().numpy())
    np.testing.assert_array_equal(
        relayout.migration_gather_index(old, new).numpy(),
        np.asarray(jrelayout.migration_gather_index(jold, jnew)))
    assert relayout.migration_stats(old, new, row_bytes=7) == \
        jrelayout.migration_stats(jold, jnew, row_bytes=7)


@pytest.mark.parametrize("my_lane", [0, 3])
def test_plans_under_a_replicated_table_match_jax(my_lane):
    """The flat, hierarchical and condensed plans of one shard under the
    reference's zipf table (12 experts on 4 lanes x 4 slots, replicas of
    non-uniform counts): every integer field and the gates exactly."""
    table, jtable = _pair("zipf", 4, 2, 4, 12)
    rng = np.random.default_rng(my_lane)
    A = rng.integers(0, 12, (24, 2)).astype(np.int32)
    g = rng.random((24, 2)).astype(np.float32)
    At, gt, Aj, gj = (torch.from_numpy(A), torch.from_numpy(g), jnp.asarray(A),
                      jnp.asarray(g))
    pairs = [(planner.build_flat_plan(At, gt, table, 6),
              jplanner.build_flat_plan(Aj, gj, jtable, 6)),
             (planner.build_hier_plan(At, gt, table, 12, my_lane),
              jplanner.build_hier_plan(Aj, gj, jtable, 12, my_lane)),
             (planner.build_condensed_plan(At, gt, table, 10),
              jplanner.build_condensed_plan(Aj, gj, jtable, 10))]
    for mine, ref in pairs:
        for name in mine._fields:
            a, b = getattr(mine, name), getattr(ref, name)
            if name == "slots":
                for f in ("slot", "counts"):
                    np.testing.assert_array_equal(
                        getattr(a, f).numpy(), np.asarray(getattr(b, f)), f)
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)


ENGINES = [("fused_flat", {}), ("fused_flat", {"dedup": True}),
           ("fused_pipe", {"pipe_slices": 2}), ("fused_hier", {}),
           ("ragged", {}), ("disagg", {})]


@pytest.mark.parametrize("engine,kw", ENGINES)
def test_engines_under_a_permuted_table_at_ep1(engine, kw):
    """At one lane a table is a permutation of the slots: every engine with
    the weights laid out by it gives the dense oracle's output and, scattered
    back to the canonical experts, its weight gradients."""
    table = relayout.solve_placement(_loads("uniform", 8), ep=1, node_size=1)
    assert not np.array_equal(table.lane_expert, np.arange(8)[None])
    g = torch.Generator().manual_seed(0)
    x = torch.randn(32, 16, generator=g)
    wr = torch.randn(16, 8, generator=g) * 0.5
    w = [torch.randn(8, *s, generator=g) * 0.1
         for s in ((16, 24), (16, 24), (24, 16))]
    cot = torch.randn(32, 16, generator=g)
    slots = relayout.slot_table(table)
    laid = [t[slots].requires_grad_(True) for t in w]
    cfg = DcommConfig(engine=engine, capacity_factor=8.0, **kw)
    y = fusco.moe_shuffle_ffn(x, wr, *laid, table, cfg, 2)
    canon = [t.clone().requires_grad_(True) for t in w]
    want = fusco.dense_moe_reference(x, wr, *canon, 2)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    got_g = torch.autograd.grad((y * cot).sum(), laid)
    want_g = torch.autograd.grad((want * cot).sum(), canon)
    for a, b in zip(got_g, want_g):
        back = torch.zeros_like(b).index_add_(0, slots, a)
        torch.testing.assert_close(back, b, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------ apply_relayout, EP 1

ARCH = "qwen3-moe-30b-a3b"


def _traffic_j(cfg, seed=2):
    rng = np.random.default_rng(seed)
    st = jtraffic.init_traffic_state(cfg.moe.n_experts, 1,
                                     n_layers=cfg.n_layers)
    return st._replace(expert_ema=jnp.asarray(
        rng.random((cfg.n_layers, cfg.moe.n_experts)).astype(np.float32)
        * np.array([8.0] + [1.0] * (cfg.moe.n_experts - 1), np.float32)))


def test_apply_relayout_matches_the_reference_at_ep1():
    """The same params, AdamW state and traffic: the table, the migrated
    params, mu, nu and master; and the loss at the same parameters and batch
    before and after, in float32."""
    cfg = jget_arch(ARCH).reduced()
    mesh = make_mesh((1, 1), ("data", "model"))
    jctx = dataclasses.replace(
        jlm.make_context(cfg, mesh, multi_pod=False, engine="fused_flat"),
        compute_dtype=jnp.float32)
    jparams = jlm.init_params(cfg, jax.random.PRNGKey(0), jctx,
                              dtype=jnp.float32)
    rng = np.random.default_rng(5)
    state = {k: jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(
        a.shape).astype(np.float32)), jparams) for k in ("mu", "nu", "master")}
    jopt = jadamw.AdamWState(jnp.int32(1), state["mu"], state["nu"],
                             state["master"])
    st = _traffic_j(cfg)
    jp2, jopt2, jctx2, jstats = jtrain.apply_relayout(
        jparams, jopt, st, jctx, log=lambda *a, **k: None)

    tcfg = get_arch(ARCH).reduced()
    ctx = lm.make_context(tcfg, "cpu", engine="fused_flat",
                          compute_dtype=torch.float32)
    to_t = lambda tree: convert.params_from_jax(
        jax.tree.map(np.asarray, tree), device="cpu")
    params = to_t(jparams)
    opt = adamw.AdamWState(1, to_t(state["mu"]), to_t(state["nu"]),
                           to_t(state["master"]))
    traffic = train.init_traffic(tcfg, ctx, 1)._replace(
        expert_ema=torch.from_numpy(np.array(st.expert_ema)))
    batch = pipeline.to_device(pipeline.ZipfNgramLM(
        tcfg.vocab, 16, 2, seed=0).batch_at(0), "cpu")
    with torch.no_grad():
        before = float(lm.lm_loss(params, batch, ctx)[0])
    w1 = params["layers"]["moe"]["w1"]
    p2, opt2, ctx2, stats = train.apply_relayout(params, opt, traffic, ctx,
                                                 log=lambda *a, **k: None)
    assert p2 is params and opt2 is opt and p2["layers"]["moe"]["w1"] is w1
    np.testing.assert_array_equal(ctx2.placement.lane_expert,
                                  np.asarray(jctx2.placement.lane_expert))
    assert {k: stats[k] for k in jstats} == jstats
    for got, want in ((p2, jp2), (opt2.mu, jopt2.mu), (opt2.nu, jopt2.nu),
                      (opt2.master, jopt2.master)):
        want = _flat_j(jax.tree.map(np.asarray, want))
        for k, v in _flat_j(got).items():
            np.testing.assert_array_equal(v.numpy(), want[k], k)
    with torch.no_grad():
        after = float(lm.lm_loss(p2, batch, ctx2)[0])
    np.testing.assert_allclose(after, before, rtol=1e-5)


def _family_ctx(arch: str, device="cpu", **kw):
    cfg = get_arch(arch).reduced()
    stream = {} if cfg.family == "moe" else dict(
        engine="fused_pipe", moe_stream=cfg.n_layers, pipe_slices=2)
    return cfg, lm.make_context(cfg, device, compute_dtype=torch.float32,
                                **{"engine": "fused_flat", **stream, **kw})


@pytest.mark.parametrize("arch", [ARCH, "moe-tx-stream", "moe-ffn-stream"])
def test_relayout_keeps_the_loss_and_migrates_every_family(arch):
    """Each MoE family through its engine (moe fused_flat, the streams
    fused_pipe): the loss at fixed parameters is unchanged by a relayout
    from the arithmetic placement and by a second one from the table; the
    placement's slots carry the same experts' weights and state."""
    cfg, ctx = _family_ctx(arch)
    params = lm.init_params(cfg, ctx, torch.Generator().manual_seed(0),
                            dtype=torch.float32)
    model = zoo.build(cfg, ctx)
    batch = pipeline.to_device(pipeline.ZipfNgramLM(cfg.vocab, 16, 2,
                                                    seed=0).batch_at(0), "cpu")
    traffic = train.init_traffic(cfg, ctx, 1)
    params, opt, m = steps.make_train_step(model, adamw.AdamWConfig(lr=1e-3))(
        params, steps.init_state(model, params), batch, traffic)
    traffic = m["traffic"]
    canon = lambda tree, p: {n: relayout.replica_mean_canonical(
        tree["layers"]["moe"][n].reshape(cfg.n_layers, -1, *tree["layers"][
            "moe"][n].shape[3:]).transpose(0, 1), p).transpose(0, 1)
        for n in train.MOE_WEIGHTS}
    for _ in range(2):
        with torch.no_grad():
            before = float(model.loss(params, batch)[0])
        want = [canon(t, ctx.placement) for t in (params, opt.mu, opt.master)]
        params, opt, ctx, stats = train.apply_relayout(
            params, opt, traffic, ctx, log=lambda *a, **k: None)
        assert isinstance(ctx.placement, relayout.TablePlacement)
        model = zoo.build(cfg, ctx)
        with torch.no_grad():
            after = float(model.loss(params, batch)[0])
        np.testing.assert_allclose(after, before, rtol=1e-5)
        for w, t in zip(want, (params, opt.mu, opt.master)):
            got = canon(t, ctx.placement)
            for n in w:
                torch.testing.assert_close(got[n], w[n], rtol=0, atol=0)
        assert stats["rewritten_bytes"] == 4 * sum(
            params["layers"]["moe"][n].numel() * 4 for n in train.MOE_WEIGHTS)


@pytest.mark.parametrize("arch", [ARCH, "moe-tx-stream", "moe-ffn-stream"])
def test_prefill_and_decode_under_a_table_are_the_arithmetic_ones(arch):
    """The serve path (``lm.prefill`` through the family's engine, then
    ``decode_step``'s replicated-token MoE) under a permuted table, with the
    expert leaves migrated onto it: the logits of the arithmetic placement."""
    cfg, ctx = _family_ctx(arch)
    params = lm.init_params(cfg, ctx, torch.Generator().manual_seed(1),
                            dtype=torch.float32)
    table = relayout.solve_placement(_loads("uniform", cfg.moe.n_experts),
                                     ep=1, node_size=1)
    moved = adamw.tree_map(lambda t: t, params)
    moved["layers"] = dict(params["layers"], moe={
        k: (relayout.migrate_lane_major(v, ctx.placement, table, lane_axis=1)
            if k in train.MOE_WEIGHTS else v)
        for k, v in params["layers"]["moe"].items()})
    tctx = dataclasses.replace(ctx, placement=table)
    tokens = torch.randint(0, cfg.vocab, (2, 8),
                           generator=torch.Generator().manual_seed(2))
    outs = []
    with torch.no_grad():
        for p, c in ((params, ctx), (moved, tctx)):
            logits, state = lm.prefill(p, tokens, torch.arange(8), c, 12)
            nxt, _ = lm.decode_step(p, state, logits.argmax(-1), c, 12)
            outs.append((logits, nxt))
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch,engine", [(ARCH, "fused_hier"),
                                         ("moe-tx-stream", "fused_pipe"),
                                         ("moe-ffn-stream", "fused_pipe")])
def test_train_run_relayout_every_follows_a_hand_loop(arch, engine, capsys):
    """``train.run --relayout-every 2`` against the same steps taken by hand
    with :func:`train.apply_relayout` after the second and the fourth, the
    lane EMAs restarted cold and the step rebuilt: the same losses, tables
    and final traffic state."""
    argv = ["--arch", arch, "--reduced", "--steps", "5", "--seq", "16",
            "--batch", "2", "--engine", engine, "--pipe-slices", "2",
            "--relayout-every", "2"]
    if engine == "fused_pipe":
        argv += ["--moe-stream", "2"]
    args = train.parse_args(argv)
    out = train.run(args, device="cpu")
    assert [r["step"] for r in out["relayouts"]] == [2, 4]
    assert capsys.readouterr().out.count("relayout: max-lane load") == 2
    cfg, ctx, params, source, opt_cfg = train.setup(args, "cpu")
    model = zoo.build(cfg, ctx)
    step = steps.make_train_step(model, opt_cfg)
    traffic = train.init_traffic(cfg, ctx, 1)
    opt = steps.init_state(model, params)
    losses, tables = [], []
    for i in range(args.steps):
        batch = pipeline.to_device(source.batch_at(i), "cpu")
        params, opt, m = step(params, opt, batch, traffic)
        traffic = m.pop("traffic")
        losses.append(float(m["loss"]))
        if (i + 1) % 2 == 0:
            params, opt, ctx, _ = train.apply_relayout(
                params, opt, traffic, ctx, log=lambda *a, **k: None)
            traffic = train.cold_lane_stats(traffic)
            tables.append(ctx.placement.lane_expert)
            step = steps.make_train_step(zoo.build(cfg, ctx), opt_cfg)
    assert out["losses"] == losses
    np.testing.assert_array_equal(out["placement"].lane_expert, tables[-1])
    for a, b in zip(out["traffic"], traffic):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_relayout_every_under_serial_accumulation_stays_static(capsys):
    out = train.run(train.parse_args(
        ["--reduced", "--steps", "3", "--seq", "16", "--batch", "2",
         "--engine", "fused_flat", "--accum", "2", "--relayout-every", "1"]),
        device="cpu")
    said = capsys.readouterr().out
    assert out["relayouts"] == [] and out["traffic"] is None
    assert "the placement stays static" in said
    assert isinstance(out["placement"], routing.ExpertPlacement)
