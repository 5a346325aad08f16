"""Training the moe family over an EP group: reduced ``qwen3-moe-30b-a3b`` in
float32 on four gloo ranks, each holding its lane of the expert weights,
against the reference's ``make_train_step`` under ``shard_map`` on a (1, 4)
mesh (``torch_ep_train``), through ``fused_flat``, ``fused_hier`` (nodes of
2, Algorithm 1 on the traffic state) and ``fused_pipe`` at 2 slices.

Rank by rank: the loss, every gradient leaf (a replicated leaf's is the
reference's whole gradient, an expert leaf's its lane of it) and the traffic
state; the grad norm with clipping binding, and after one step the params,
mu, nu, master and the state.  Without the replicated leaves' reduction the
gradients miss the reference's; after two steps the replicated leaves hold
the same bits on every rank.  Then: one rank alone gives the bits of no
group and launches no collective; ``init_params`` at EP 4 is the shard of
the EP 1 tree; a world the EP group does not cover is refused; serial
accumulation syncs once a step; ``train.main`` under torchrun's
environment trains over the world.
Tolerance 1e-5 relative to each leaf's max(1, |x|); counts exactly.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_ep_train as h
from repro_torch.configs import get_arch
from repro_torch.core import dcomm, traffic
from repro_torch.data.pipeline import ZipfNgramLM, to_device
from repro_torch.launch import steps
from repro_torch.models import lm, zoo
from repro_torch.optim import adamw

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

ARCH = "qwen3-moe-30b-a3b"
# (engine, moe_stream, pipe_slices)
CASES = (("fused_flat", 0, 0), ("fused_hier", 0, 0), ("fused_pipe", 0, 2))
NAMES = [f"{e}/{s}" for e, _, s in CASES]


def _accumulated(cfg, gen):
    """Serial accumulation over the group: the reductions one call makes,
    and how far its gradients are from the mean of the two micro-batches'
    (each synced), relative to max(1, |x|) of each leaf."""
    ctx = lm.make_context(cfg, "cpu", ep_group=dist.group.WORLD,
                          engine="fused_flat", compute_dtype=torch.float32,
                          explicit_tp=False)     # the replicated layout
    model = zoo.build(cfg, ctx)
    p = lm.shard_params(lm.init_params(cfg, lm.make_context(cfg, "cpu"),
                                       gen(), dtype=torch.float32), ctx)
    bt = to_device(ZipfNgramLM(cfg.vocab, 16, 2, seed=0).batch_at(0), "cpu")
    calls, sync = [], steps.reduce_replicated
    steps.reduce_replicated = lambda g, paths, group, *held: (
        calls.append(1), sync(g, paths, group, *held))[1]
    try:
        _, _, acc = steps.value_and_grad(model, accum=2)(p, bt)
    finally:
        steps.reduce_replicated = sync
    halves = [steps.value_and_grad(model)(
        p, {k: v[i:i + 1] for k, v in bt.items()})[2] for i in range(2)]
    err = max(float((a - (g0 + g1) / 2).abs().max())
              / max(1.0, float(a.abs().max()))
              for a, g0, g1 in zip(acc, *halves, strict=True))
    return len(calls), err


def _extra(rank, world):
    """On each rank: ``init_params`` at EP 4 against ``shard_params`` of the
    EP 1 tree (the paths that differ), whether a step of a model with no
    group is refused in this world of four, and serial accumulation over
    the group (:func:`_accumulated`)."""
    cfg = get_arch(ARCH).reduced()
    gen = lambda: torch.Generator().manual_seed(0)
    ctx = lm.make_context(cfg, "cpu", ep_group=dist.group.WORLD,
                          engine="fused_flat", explicit_tp=False)
    mine = h.flat(lm.init_params(cfg, ctx, gen()))
    whole = lm.init_params(cfg, lm.make_context(cfg, "cpu"), gen())
    cut = h.flat(lm.shard_params(whole, ctx))
    differ = [k for k in cut if not (mine[k].shape == cut[k].shape
                                     and torch.equal(mine[k], cut[k]))]
    shapes = {k: tuple(v.shape) for k, v in mine.items()}
    try:
        steps.make_train_step(zoo.build(cfg, lm.make_context(cfg, "cpu")),
                              adamw.AdamWConfig())
        refused = ""
    except NotImplementedError as e:
        refused = str(e)
    syncs, err = _accumulated(cfg, gen)
    return {"extra/differ": np.array(differ, dtype=str),
            "extra/w1_shape": np.array(shapes["layers/moe/w1"]),
            "extra/refused": np.array(refused),
            "extra/accum_syncs": np.array(syncs),
            "extra/accum_err": np.array(err)}


@pytest.fixture(scope="module")
def ep_run(tmp_path_factory):
    return h.run(tmp_path_factory.mktemp("train_ep"), ARCH, CASES, _extra)


@pytest.mark.parametrize("case", NAMES)
def test_ep4_loss_grads_and_traffic_match_shard_map_rank_by_rank(ep_run, case):
    want, ranks, _ = ep_run
    for r, got in enumerate(ranks):
        h.check_grads(want, got, case, r)


@pytest.mark.parametrize("case", NAMES)
def test_ep4_train_step_matches_shard_map_rank_by_rank(ep_run, case):
    want, ranks, _ = ep_run
    for r, got in enumerate(ranks):
        h.check_step(want, got, case, r)


@pytest.mark.parametrize("case", NAMES)
def test_ep4_grads_without_the_sync_miss_the_reference(ep_run, case):
    """The replicated leaves' gradients with ``steps.reduce_replicated``
    switched off: every rank misses the reference on the router (its
    stripe's share) and on the final norm (1/EP of it); ``embed`` and
    ``lm_head``, split over the group, are out of the replicated bucket and
    get their whole gradients without it (``h.unsynced_misses``)."""
    want, ranks, _ = ep_run
    for r, got in enumerate(ranks):
        missed = h.unsynced_misses(want, got, case, r)
        assert {"layers/moe/router", "final_norm"} <= set(missed), (r, missed)
        assert not {"embed", "lm_head"} & set(missed), (r, missed)


@pytest.mark.parametrize("case", NAMES)
def test_ep4_replicated_leaves_stay_bit_equal_after_two_steps(ep_run, case):
    _, ranks, _ = ep_run
    assert h.replicated_bits_differ(ranks, case) == []


def test_init_params_at_ep4_is_the_shard_of_the_ep1_tree(ep_run):
    _, ranks, _ = ep_run
    cfg = get_arch(ARCH).reduced()
    for r, got in enumerate(ranks):
        assert got["extra/differ"].tolist() == [], r
        assert got["extra/w1_shape"].tolist() == [
            cfg.n_layers, 1, cfg.moe.n_experts // h.EP, cfg.d_model,
            cfg.moe.d_ff_expert]


def test_a_world_the_ep_group_does_not_cover_is_refused(ep_run):
    _, ranks, _ = ep_run
    for got in ranks:
        msg = str(got["extra/refused"])
        assert "ROADMAP queue 1 item 3 part 2" in msg, msg


def test_serial_accumulation_over_the_group_syncs_once_a_step(ep_run):
    """``accum=2`` over the group of four: one reduction of the summed
    micro-batch gradients, which equal the mean of the micro-batches'
    synced gradients within 1e-5 of max(1, |x|)."""
    _, ranks, _ = ep_run
    for got in ranks:
        assert int(got["extra/accum_syncs"]) == 1
        assert float(got["extra/accum_err"]) <= h.TOL


@pytest.mark.parametrize("engine", ["fused_flat", "fused_hier"])
def test_one_rank_group_gives_the_bits_of_no_group_and_no_collective(
        tmp_path, engine):
    """The reduced moe step from the same params, batch and state with
    ``ep_group=None`` and with a one-rank gloo group, two steps each: the
    same bits in params, mu, nu, master, loss, grad norm and traffic; and
    ``adamw.update`` given the one-rank group the bits it gives with none.
    No ``torch.distributed`` collective is called."""
    cfg = get_arch(ARCH).reduced()
    host = ZipfNgramLM(cfg.vocab, 16, 2, seed=0).batch_at(0)
    base = lm.init_params(cfg, lm.make_context(cfg, "cpu"),
                          torch.Generator().manual_seed(0),
                          dtype=torch.float32)
    opt_cfg = adamw.AdamWConfig(**h.OPT)
    outs, updates = [], []
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}",
                            rank=0, world_size=1)
    try:
        with dcomm.collective_calls() as calls:
            for group in (None, dist.group.WORLD):
                ctx = lm.make_context(cfg, "cpu", ep_group=group,
                                      engine=engine,
                                      compute_dtype=torch.float32)
                p = adamw.tree_map(lambda t: t.clone(), base)
                step = steps.make_train_step(zoo.build(cfg, ctx), opt_cfg)
                state = traffic.init_traffic_state(cfg.moe.n_experts, 1,
                                                   n_layers=cfg.n_layers)
                opt = adamw.init(p)
                for _ in range(2):
                    p, opt, m = step(p, opt, to_device(host, "cpu"), state)
                    state = m["traffic"]
                outs.append([t.detach() for t in (
                    adamw.leaves(p) + adamw.leaves(opt.mu)
                    + adamw.leaves(opt.nu) + adamw.leaves(opt.master)
                    + list(state)
                    + [m["loss"], m["grad_norm"]])])
                p = adamw.tree_map(lambda t: t.clone(), base)
                grads = adamw.tree_map(lambda t: t * 0.5 - 0.25, base)
                p, opt, m = adamw.update(grads, adamw.init(p), p, opt_cfg,
                                         group=group, sharded=lm.lane_sharded)
                updates.append(adamw.leaves(p) + adamw.leaves(opt.master)
                               + [m["grad_norm"]])
    finally:
        dist.destroy_process_group()
    assert calls == []
    for a, b in zip(*outs, strict=True):
        assert torch.equal(a, b)
    for a, b in zip(*updates, strict=True):
        assert torch.equal(a, b)


def test_reckoned_state_counts_the_model_s_parameters():
    """The per-rank state reckoning (``torch_ep_train.state_gib_per_rank``,
    which ``PERF.md`` quotes for the full model) counts, for the reduced
    model, the replicated and expert parameters ``init_params`` builds, and
    its bytes at EP 4 are those of ``shard_params``' rank (its lane of the
    experts, its quarter of ``embed`` and ``lm_head``) plus the bucket of
    the rest; at EP 4 and DP 2 its mu, nu and master are the rank's ZeRO-1
    shares (``adamw.zero_dim``, ``embed``'s on d)."""
    cfg = get_arch(ARCH).reduced()
    tree = lm.init_params(cfg, lm.make_context(cfg, "cpu"),
                          torch.Generator().manual_seed(0))
    rep = sum(t.numel() for p, t in zip(adamw.paths(tree), adamw.leaves(tree))
              if not lm.lane_sharded(p))
    exp = sum(t.numel() for p, t in zip(adamw.paths(tree), adamw.leaves(tree))
              if lm.lane_sharded(p))
    mem = h.state_gib_per_rank(cfg=cfg, eps=(4,), dps=(1, 2))
    assert (mem["replicated_params"], mem["expert_params"]) == (rep, exp)
    rank = [lm.tp_cut(p, lm.lane_cut(p, t, 4, range(1, 2)), 4, 1, tp=False)
            for p, t in zip(adamw.paths(tree), adamw.leaves(tree))]
    held = sum(t.numel() for t in rank)
    bucket = rep - lm.vocab_param_count(cfg, 4)
    assert held == bucket + lm.vocab_param_count(cfg, 4) // 4 + exp // 4
    assert mem["gib_per_rank"][4] * 2**30 == 16 * held + 2 * bucket
    # ZeRO-1 over two data ranks: every leaf of the rank's tree has a ZeRO
    # dim (adamw.zero_dim), so mu, nu and master hold half of it
    shares = sum(
        t.numel() // (1 if adamw.zero_dim(
            t.shape, 2, lm.lane_sharded(p),
            h.split_dim(p, w.shape, 4)) is None else 2)
        for p, t, w in zip(adamw.paths(tree), rank, adamw.leaves(tree)))
    assert shares * 2 == held
    assert mem["gib_per_rank_dp"][4, 2] * 2**30 == (
        12 * shares + 4 * held + 2 * bucket)


def _torchrun_rank(rank, world, port, out_dir):
    """One process as ``torchrun`` starts it: the environment, then
    ``train.main`` on the CPU (gloo), its printing captured."""
    import contextlib
    import io
    import os
    from repro_torch.launch import train
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        out = train.main(["--reduced", "--engine", "fused_hier", "--steps",
                          "3", "--seq", "16", "--batch", "2"], device="cpu")
    np.savez(f"{out_dir}/main{rank}.npz", losses=np.array(out["losses"]),
             printed=np.array(printed.getvalue()),
             ema=out["traffic"].expert_ema.numpy())


def test_train_main_under_torchrun_trains_over_the_world(tmp_path):
    """``train.main`` in two processes with torchrun's environment: one EP
    group of the whole world (gloo on the CPU), the same losses and traffic
    on both ranks, and only rank 0 prints, the peak memory of every rank."""
    import socket
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(_torchrun_rank, args=(2, port, str(tmp_path)), nprocs=2,
             join=True)
    got = [np.load(tmp_path / f"main{r}.npz") for r in range(2)]
    assert np.isfinite(got[0]["losses"]).all() and len(got[0]["losses"]) == 3
    np.testing.assert_array_equal(got[0]["losses"], got[1]["losses"])
    np.testing.assert_array_equal(got[0]["ema"], got[1]["ema"])
    assert "loss per step:" in str(got[0]["printed"])
    assert "peak memory per rank n/a n/a GiB" in str(got[0]["printed"])
    assert str(got[1]["printed"]) == ""
