"""FSDP of the expert weights (ZeRO-3 over the data group, the reference's
``fsdp_experts``) on a (2, 2) (data, model) grid of four gloo ranks: the
reduced ``qwen3-moe-30b-a3b`` through ``fused_hier`` (nodes of one lane),
the reduced ``moe-tx-stream`` through the streamed ``fused_pipe`` (one
block of both layers, 2 slices) and the reduced ``moe-ffn-stream`` through
``fused_flat``, float32, against the reference's ``make_train_step`` and
``jax.value_and_grad(lm.lm_loss)`` with ``fsdp_experts=True`` on a (2, 2)
mesh (``torch_ep_train.run_grid(fsdp=True)``).

Rank by rank: the loss, every gradient leaf (an expert leaf's this rank's
f-slice of its lane), the traffic state, the grad norm with clipping
binding, after one step the params and mu, nu and master (an expert leaf's
its own f-slice, the other leaves' ZeRO-1 slices), at ``torch_ep_train``'s
tolerances (1e-5 of each leaf's max(1, |x|); updated params within
``torch_adam``'s room).  On the same ranks the grid with FSDP off gives the
same loss, grad norm, gradients and stepped params within 1e-6 relative;
the two data ranks of a lane hold complementary halves of its f dim.  A
checkpoint of the FSDP state restored as ZeRO-1 and saved again is the
same files, and restored as FSDP again is the same bits; a relayout of the
FSDP state saves the same whole leaves as that of the ZeRO-1 state.  In
process: over one data rank FSDP is the identity (no gather, no copy, no
collective).
"""

import functools
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_ep_train as h
from repro_torch import convert
from repro_torch.checkpoint import checkpointer
from repro_torch.configs import get_arch
from repro_torch.core import dcomm, traffic
from repro_torch.launch import steps, train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.layers import moe
from repro_torch.models import lm, zoo
from repro_torch.optim import adamw
from repro_torch.parallel import sharding

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

SHAPE, NODE = (2, 2), 1
# (arch, ((engine, moe_stream, pipe_slices), ...)): every MoE family
ARCHS = (("qwen3-moe-30b-a3b", (("fused_hier", 0, 0),)),
         ("moe-tx-stream", (("fused_pipe", 2, 2),)),
         ("moe-ffn-stream", (("fused_flat", 0, 0),)))
CASES = [f"{e}/{s}" for _, cases in ARCHS for e, _, s in cases]
TOL_OFF = 1e-6            # FSDP off against on: the same function, the
                          # clip norm's squares summed in another order
CKPT_ARCH, CKPT_CASE = ARCHS[0][0], ARCHS[0][1][0]


def _ctx(cfg, mesh, case, fsdp):
    engine, stream, slices = case
    return lm.make_context(cfg, "cpu", mesh=mesh, engine=engine,
                           node_size=NODE, moe_stream=stream,
                           pipe_slices=slices, compute_dtype=torch.float32,
                           fsdp_experts=fsdp, explicit_tp=False)


def _save(out: dict, key: str, tree) -> None:
    for k, v in h.flat(tree).items():
        out[f"{key}/{k}"] = v.detach().numpy().copy()


def _whole_files(path: str, step: int) -> list:
    d = os.path.join(path, f"step_{step}")
    n = len([f for f in os.listdir(d) if f.startswith("arr_")])
    return [np.load(os.path.join(d, f"arr_{i}.npy")) for i in range(n)]


def _extra(tmp, rank, world):
    """On each rank, beside the FSDP run of ``run_grid``: every case with
    FSDP off (loss, gradients, one step); then, for the first case, the
    checkpoint round trip FSDP -> ZeRO-1 -> FSDP and a relayout of both
    states after their step, each saved whole and compared on rank 0."""
    mesh = make_host_mesh(*SHAPE)
    out, quiet = {}, lambda *a, **k: None
    for arch, cases in ARCHS:
        d = np.load(f"{tmp}/data-{arch}.npz")
        tree = h.nest((k[2:], d[k]) for k in d.files if k.startswith("p/"))
        rows = train.data_rows(h.B, mesh.data, mesh.data_index)
        bt = {k: torch.from_numpy(d[k][rows]).long()
              for k in ("tokens", "labels")}
        cfg = get_arch(arch).reduced()
        cold = lambda: traffic.init_traffic_state(
            cfg.moe.n_experts, mesh.model, n_layers=cfg.n_layers)
        for case in cases:
            c = f"{case[0]}/{case[2]}"
            runs = {}
            for fsdp in (False, True):
                ctx = _ctx(cfg, mesh, case, fsdp)
                model = zoo.build(cfg, ctx)
                p = convert.params_from_jax(
                    tree, "cpu", lane=rank % mesh.model,
                    data=(mesh.data, mesh.data_index) if fsdp else None,
                    model=(mesh.model, rank % mesh.model), tp=False)
                if not fsdp:
                    loss, _, grads = steps.value_and_grad(model)(p, bt, cold())
                    out[f"off/{c}/loss"] = loss.numpy()
                    for k, g in zip(adamw.paths(p), grads):
                        out[f"off/{c}/g/{k}"] = g.numpy().copy()
                step = steps.make_train_step(model,
                                             adamw.AdamWConfig(**h.OPT))
                p, opt, m = step(p, steps.init_state(model, p), bt, cold())
                if not fsdp:
                    out[f"off/{c}/grad_norm"] = m["grad_norm"].numpy()
                    _save(out, f"off/{c}/p", p)
                runs[fsdp] = (ctx, p, opt, m["traffic"])
            if (arch, case) == (CKPT_ARCH, CKPT_CASE):
                out.update(_ckpt_and_relayout(tmp, rank, mesh, runs, quiet))
    return out


def _ckpt_and_relayout(tmp, rank, mesh, runs, quiet) -> dict:
    (ctx_off, p_off, opt_off, tr), (ctx_on, p_on, opt_on, _) = (
        runs[False], runs[True])
    # the pair split over the model group in both (lm.vocab_parallel)
    lay = {f: checkpointer.context_layout(c)
           for f, c in ((False, ctx_off), (True, ctx_on))}
    save = lambda path, state, f: checkpointer.wait(
        checkpointer.save(path, state, 1, lay=lay[f]))

    def like(state):
        zeros = lambda t: adamw.tree_map(torch.zeros_like, t)
        return zeros(state[0]), adamw.AdamWState(
            0, *(zeros(t) for t in state[1][1:]))

    a, b = f"{tmp}/ck-fsdp", f"{tmp}/ck-zero1"
    save(a, (p_on, opt_on), True)
    as_zero1, _ = checkpointer.restore(a, like((p_off, opt_off)), lay=lay[False])
    save(b, as_zero1, False)
    back, _ = checkpointer.restore(b, like((p_on, opt_on)), lay=lay[True])
    out = {"ckpt/back_bits": np.array(all(
        torch.equal(x, y) for x, y in zip(
            adamw.leaves(back[0]) + [t for s in back[1][1:]
                                     for t in adamw.leaves(s)],
            adamw.leaves(p_on) + [t for s in opt_on[1:]
                                  for t in adamw.leaves(s)],
            strict=True)))}
    # restored as ZeRO-1 against the FSDP-off run's own state after its step
    out["ckpt/zero1_rel"] = np.array(max(
        (x - y).abs().max().item() / max(1.0, y.abs().max().item())
        for x, y in zip(adamw.leaves(as_zero1[0]) + [
            t for s in as_zero1[1][1:] for t in adamw.leaves(s)],
            adamw.leaves(p_off) + [t for s in opt_off[1:]
                                   for t in adamw.leaves(s)], strict=True)))
    # the relayout of each state, saved whole
    for f, (ctx, p, opt) in ((False, (ctx_off, p_off, opt_off)),
                             (True, (ctx_on, p_on, opt_on))):
        p, opt, _, stats = train.apply_relayout(p, opt, tr, ctx, log=quiet)
        save(f"{tmp}/relayout-{int(f)}", (p, opt), f)
        out[f"relayout/{int(f)}/moved"] = np.array(stats["rows_moved"])
    if rank == 0:
        files = [_whole_files(x, 1) for x in (a, b)]
        out["ckpt/files_equal"] = np.array(all(
            np.array_equal(x, y) for x, y in zip(*files, strict=True)))
        rel = [_whole_files(f"{tmp}/relayout-{f}", 1) for f in (0, 1)]
        out["relayout/rel"] = np.array(max(
            np.abs(x.astype(np.float64) - y).max() / max(1.0, np.abs(y).max())
            for x, y in zip(*rel, strict=True)))
    dist.barrier()
    return out


@pytest.fixture(scope="module")
def grid_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    return h.run_grid(tmp, ARCHS, functools.partial(_extra, str(tmp)),
                      shape=SHAPE, node=NODE, fsdp=True)


@pytest.mark.parametrize("case", CASES)
def test_fsdp_grid_matches_the_reference_rank_by_rank(grid_run, case):
    want, ranks, _ = grid_run
    for r, got in enumerate(ranks):
        h.check_grads(want, got, case, r, SHAPE, fsdp=True)
        h.check_step(want, got, case, r, SHAPE, fsdp=True)


def _close_off(got, want, what):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL_OFF, atol=TOL_OFF * scale,
                               err_msg=what)


@pytest.mark.parametrize("case", CASES)
def test_fsdp_off_gives_the_same_numbers(grid_run, case):
    """Loss, grad norm, every gradient and the stepped params of the FSDP
    run against the same ranks' run with FSDP off, an expert leaf cut to
    the rank's f-slice."""
    _, ranks, _ = grid_run
    for r, got in enumerate(ranks):
        _close_off(got[f"{case}/loss"], got[f"off/{case}/loss"], f"{r} loss")
        _close_off(got[f"{case}/grad_norm"], got[f"off/{case}/grad_norm"],
                   f"{r} grad norm")
        for kind, pre in (("g", "g"), ("p", "p")):
            keys = [k[len(f"off/{case}/{pre}/"):] for k in got
                    if k.startswith(f"off/{case}/{pre}/")]
            assert keys
            for path in keys:
                off = got[f"off/{case}/{pre}/{path}"]
                if sharding.fsdp_sharded(path):
                    off = sharding.data_cut(off, sharding.fsdp_dim(path),
                                            SHAPE[0], r // SHAPE[1])
                _close_off(got[f"{case}/{kind}/{path}"], off,
                           f"rank {r} {kind} {path}")


@pytest.mark.parametrize("case", CASES)
def test_fsdp_data_ranks_hold_complementary_f_slices(grid_run, case):
    """Each expert leaf on the two data ranks of a lane: half its f dim
    each, joined in data order the lane's whole leaf (FSDP off); mu, nu and
    master the slice's shape."""
    _, ranks, _ = grid_run
    model = SHAPE[1]
    for path in lm.EXPERT_LEAVES:
        dim = sharding.fsdp_dim(path)
        for lane in range(model):
            parts = [ranks[d * model + lane][f"{case}/p/{path}"]
                     for d in range(SHAPE[0])]
            whole = ranks[lane][f"off/{case}/p/{path}"]
            assert all(p.shape[dim] * SHAPE[0] == whole.shape[dim]
                       for p in parts), path
            _close_off(np.concatenate(parts, axis=dim), whole, path)
            for kind in ("mu", "nu", "master"):
                assert ranks[lane][f"{case}/{kind}/{path}"].shape == \
                    parts[0].shape, (path, kind)


def test_fsdp_checkpoint_round_trip_to_zero1_and_back(grid_run):
    """The FSDP state after one step saved whole, restored as ZeRO-1 (within
    1e-6 of the FSDP-off run's own state) and saved again: the same files;
    restored as FSDP from those: every rank's bits."""
    _, ranks, _ = grid_run
    assert bool(ranks[0]["ckpt/files_equal"])
    for r, got in enumerate(ranks):
        assert bool(got["ckpt/back_bits"]), r
        assert float(got["ckpt/zero1_rel"]) <= TOL_OFF, r


def test_fsdp_relayout_moves_f_slices_as_zero1_moves_whole_leaves(grid_run):
    """``train.apply_relayout`` of the FSDP state (each data rank moving its
    f-slices over its EP group) and of the ZeRO-1 state, both saved whole:
    every leaf within 1e-6 of max(1, |x|), and the same blocks moved."""
    _, ranks, _ = grid_run
    assert float(ranks[0]["relayout/rel"]) <= TOL_OFF
    for got in ranks:
        assert got["relayout/0/moved"] == got["relayout/1/moved"]


def test_fsdp_over_one_data_rank_is_the_identity(monkeypatch):
    """No data group, or one of one rank: ``lm.fsdp_group`` is None and the
    MoE layers' gather yields the leaves themselves, with no collective."""
    cfg = get_arch("qwen3-moe-30b-a3b").reduced()
    ctx = lm.make_context(cfg, "cpu", fsdp_experts=True)
    assert ctx.fsdp_experts and lm.fsdp_group(ctx) is None
    assert not lm.fsdp_sharded(ctx)("layers/moe/w1")
    leaves = {w: torch.ones(1, 1, 2, 4) for w in ("router", "w1", "w3", "w2")}
    one = object()
    monkeypatch.setattr(dist, "get_world_size",
                        lambda group=None: 1 if group is one else 4)
    with dcomm.collective_calls() as calls:
        for group in (None, one):
            with moe._fsdp_gathered(leaves, group) as got:
                assert got is leaves
    assert calls == []


def test_fsdp_gathers_each_leaf_once_a_forward_and_once_a_backward(
        monkeypatch):
    """``moe_block`` at EP 1 over a stand-in data group of two ranks whose
    other rank holds the same slice (the gather joins the slice with
    itself; the reduce-scatter sums the two halves, the transpose of that
    join): each expert leaf is gathered once in the forward and once more in
    the backward, for all the views autograd saved of it, and the output
    and the slices' gradients are those of the joined weights held
    whole."""
    from repro_torch.core.dcomm import DcommConfig
    from repro_torch.core.routing import ExpertPlacement
    rng = np.random.default_rng(4)
    e, d, f, t = 4, 16, 8, 24
    dims = {"w1": -1, "w3": -1, "w2": -2}
    slices = {w: torch.from_numpy(rng.standard_normal(
        (1, e, f // 2, d) if w == "w2" else (1, e, d, f // 2),
        np.float32) * 0.3).requires_grad_() for w in dims}
    router = torch.from_numpy(rng.standard_normal((d, e), np.float32))
    x = torch.from_numpy(rng.standard_normal((1, t, d), np.float32))
    kw = dict(placement=ExpertPlacement(n_experts=e, ep=1, node_size=1),
              dcfg=DcommConfig(capacity_factor=8.0), top_k=2)
    whole = {w: torch.cat([s, s], dims[w]) for w, s in slices.items()}
    want = moe.moe_block(x, {"router": router, **whole}, **kw)
    want_g = torch.autograd.grad(want.square().sum(), list(slices.values()))

    two, calls = object(), []

    def gather(t_, dim, group):
        calls.append("gather")
        return torch.cat([t_, t_], dim).contiguous()

    def scatter(g, dim, group):
        calls.append("reduce_scatter")
        h_ = g.shape[dim] // 2
        return g.narrow(dim, 0, h_) + g.narrow(dim, h_, h_)

    monkeypatch.setattr(dist, "get_world_size",
                        lambda group=None: 2 if group is two else 1)
    monkeypatch.setattr(dcomm, "all_gather_dim", gather)
    monkeypatch.setattr(dcomm, "reduce_scatter_dim", scatter)
    got = moe.moe_block(x, {"router": router, **slices}, fsdp=two, **kw)
    assert calls == ["gather"] * 3
    got_g = torch.autograd.grad(got.square().sum(), list(slices.values()))
    assert sorted(calls[3:]) == ["gather"] * 3 + ["reduce_scatter"] * 3
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    for a, b in zip(got_g, want_g, strict=True):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
