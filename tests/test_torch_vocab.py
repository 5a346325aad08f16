"""``embed`` and ``lm_head`` split over the model group in training
(``models/lm.vocab_parallel``, the reference's training specs,
``repro/parallel/sharding.py:34-42``): reduced configs in float32 on four
gloo ranks against the reference's ``jax.value_and_grad(lm.lm_loss)`` and
``make_train_step`` on four forced host devices (``torch_ep_train``).

The settings: a (2, 2) grid under Megatron TP, dense and moe; a (1, 4) grid
with the moe family under TP (``fused_flat`` then ``fused_hier`` a layer)
and without (``explicit_tp=False``, ``fused_hier``), moe_tx (streamed
``fused_pipe``) and moe_ffn (``fused_flat``) over the EP group of four, and
the fallback at a vocab of 250, which four does not divide (``embed`` and
``lm_head`` split on d): the moe family without TP, the dense family under
it.  In each, rank by rank: the loss, every gradient leaf (the split
leaves' the reference's whole gradient cut to the rank's shard), the
step's grad norm and ZeRO-1 slices (``embed``'s on d where the vocab is
split) and the params after two steps.  Then on the (2, 2) grid: a
checkpoint saved from the split leaves holds the reference's whole leaves
(its ``checkpointer.restore`` reads them bit for bit, and each rank's held
part is their cut), and restores onto the (2, 2) grid, a (1, 2) grid and
one rank with the same loss; on the (1, 4) grid the replicated bucket
(``steps.reduce_replicated``) holds neither leaf.  In process: ``convert``
cuts the pair as the reference's specs shard it, and ``prefill`` refuses a
split context.  Tolerance 1e-5 relative to each leaf's max(1, |x|)."""

import functools

import jax
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
from repro_torch.launch import steps
from repro_torch.launch.mesh import HostMesh, make_host_mesh
from repro_torch.models import lm, zoo
from repro_torch.optim import adamw
from repro_torch.parallel import sharding
from repro_torch.runtime import elastic

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

DENSE, MOE = "qwen3-1.7b", "qwen3-moe-30b-a3b"
TX, FFN = "moe-tx-stream", "moe-ffn-stream"
ODD = 250           # a vocab four does not divide: the pair splits on d
GRID, TP4 = (2, 2), (1, 4)
NODE = 2
CAPACITY = 8.0      # the checkpoint's layouts: no drops at EP 1 or 2
# (2, 2): both families under TP
GRID_ARCHS = ((DENSE, (("dense", 0, 0),)), (MOE, (("fused_flat", 0, 0),)))
# (1, 4): (arch, cases); the case names of TP4_TP run Megatron TP, the
# others explicit_tp=False (moe_tx and moe_ffn have no TP)
TP4_ARCHS = ((MOE, (("fused_flat,fused_hier", 0, 0), ("fused_hier", 0, 0))),
             (TX, (("fused_pipe", 2, 2),)),
             (FFN, (("fused_flat", 0, 0),)),
             (f"{MOE}@{ODD}", (("fused_hier,fused_flat", 0, 0),)),
             (f"{DENSE}@{ODD}", (("dense", 0, 0),)))
TP4_TP = ("fused_flat,fused_hier/0", "dense/0")
CASES = ([(GRID, f"{e}/{s}") for _, cases in GRID_ARCHS for e, _, s in cases]
         + [(TP4, f"{e}/{s}") for _, cases in TP4_ARCHS for e, _, s in cases])
ARCH_OF = {**{(GRID, f"{e}/{s}"): a for a, cases in GRID_ARCHS
              for e, _, s in cases},
           **{(TP4, f"{e}/{s}"): a for a, cases in TP4_ARCHS
              for e, _, s in cases}}


def _tp(shape, case) -> bool:
    return shape == GRID or case in TP4_TP


def _ckpt_extra(ckpt, rank, world) -> dict:
    """On each rank of the (2, 2) grid: the moe arch under TP (the pair
    split on the vocab) from the seed's params, one step, saved through
    ``checkpointer.context_layout``; its held state; then restored onto the
    (2, 2) grid, onto a (1, 2) grid of ranks 0 and 1 and onto rank 0 alone,
    each layout's loss of the whole batch (``lm.lm_loss``) from the restored
    params, and rank 0's whole restore."""
    cfg = h.reduced(MOE)
    tree = h.nest(h.params(MOE, ep=GRID[1], node=NODE).items())
    bt = {k: torch.from_numpy(v).long() for k, v in h.batch(cfg.vocab).items()}
    mesh = make_host_mesh(*GRID)
    lane = rank % mesh.model
    ctx = lm.make_context(cfg, "cpu", mesh=mesh, engine="fused_flat",
                          node_size=NODE, compute_dtype=torch.float32,
                          capacity_factor=CAPACITY)
    assert lm.vocab_parallel(ctx) and lm.tensor_parallel(ctx)
    model = zoo.build(cfg, ctx)
    params = convert.params_from_jax(tree, "cpu", lane=lane,
                                     model=(mesh.model, lane))
    rows = h.data_rows(h.B, mesh.data, mesh.data_index)
    step = steps.make_train_step(model, adamw.AdamWConfig(**h.OPT))
    params, opt, _ = step(params, steps.init_state(model, params),
                          {k: v[rows] for k, v in bt.items()})
    lay = checkpointer.context_layout(ctx)
    assert lay.vocab == (cfg.vocab, cfg.d_model) and lay.tp
    checkpointer.wait(checkpointer.save(ckpt, (params, opt), 1, lay=lay))
    out = {}
    for k, t in h.flat(params).items():
        out[f"ckpt/held/{k}"] = t.detach().numpy().copy()
    for kind, tr in (("mu", opt.mu), ("nu", opt.nu), ("master", opt.master)):
        for k, t in h.flat(tr).items():
            out[f"ckpt/held_{kind}/{k}"] = t.numpy().copy()
    loss = lambda c, p: float(lm.lm_loss(p, bt, c)[0])
    like = convert.params_from_jax(tree, "cpu", lane=lane,
                                   model=(mesh.model, lane))
    got, _ = elastic.remesh_restore(ckpt, (like, steps.init_state(model, like)),
                                    mesh, tp=True, vocab=lay.vocab)
    out["ckpt/loss22"] = np.array(loss(ctx, got[0]))
    pair = dist.new_group([0, 1])
    if rank < 2:
        two = HostMesh(1, 2, None, pair, pair)
        c12 = lm.make_context(cfg, "cpu", mesh=two, engine="fused_flat",
                              node_size=1, compute_dtype=torch.float32,
                              capacity_factor=CAPACITY)
        like = convert.params_from_jax(tree, "cpu", lane=rank, model=(2, rank))
        got, _ = elastic.remesh_restore(
            ckpt, (like, adamw.init(like, None, lm.lane_sharded)), two,
            tp=True, vocab=(cfg.vocab, cfg.d_model))
        out["ckpt/loss12"] = np.array(loss(c12, got[0]))
        out["ckpt/embed12"] = got[0]["embed"].numpy().copy()
    if rank == 0:
        whole = convert.params_from_jax(tree, "cpu")
        (got, st), _ = elastic.remesh_restore(ckpt, (whole,
                                                     adamw.init(whole)))
        one = lm.make_context(cfg, "cpu", compute_dtype=torch.float32,
                              capacity_factor=CAPACITY)
        # the experts regrouped into the one lane
        out["ckpt/loss1"] = np.array(loss(one, lm.shard_params(got, one)))
        for kind, tr in (("p", got), ("mu", st.mu), ("nu", st.nu),
                         ("master", st.master)):
            for k, t in h.flat(tr).items():
                out[f"ckpt/one/{kind}/{k}"] = t.numpy().copy()
    return out


def _bucket_extra(rank, world) -> dict:
    """On each rank of the (1, 4) grid: the leaves ``steps.value_and_grad``
    hands ``reduce_replicated`` to sum (the replicated bucket), for the moe
    arch without TP and under it."""
    cfg = h.reduced(MOE)
    tree = h.nest(h.params(MOE, ep=TP4[1], node=NODE).items())
    bt = {k: torch.from_numpy(v).long() for k, v in h.batch(cfg.vocab).items()}
    mesh = make_host_mesh(*TP4)
    out, sync = {}, steps.reduce_replicated
    for tp in (False, True):
        ctx = lm.make_context(cfg, "cpu", mesh=mesh, engine="fused_flat",
                              node_size=NODE, compute_dtype=torch.float32,
                              explicit_tp=tp)
        bucket = []

        def recording(grads, paths, group, sharded=lm.lane_sharded):
            bucket.extend(p for p in paths if not sharded(p))
            return sync(grads, paths, group, sharded)

        steps.reduce_replicated = recording
        try:
            steps.value_and_grad(zoo.build(cfg, ctx))(
                convert.params_from_jax(tree, "cpu", lane=rank,
                                        model=(TP4[1], rank), tp=tp), bt)
        finally:
            steps.reduce_replicated = sync
        out[f"bucket/{tp}"] = np.array(bucket, dtype=str)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The (2, 2) and (1, 4) runs: (shape -> (the reference's arrays, each
    rank's))."""
    out = {}
    for shape, archs, tp, extra in (
            (GRID, GRID_ARCHS, True, None),
            (TP4, TP4_ARCHS, TP4_TP, _bucket_extra)):
        tmp = tmp_path_factory.mktemp(f"vocab{shape[0]}x{shape[1]}")
        if extra is None:
            extra = functools.partial(_ckpt_extra, str(tmp / "ckpt"))
        want, ranks, _ = h.run_grid(tmp, archs, extra, shape=shape,
                                    node=NODE, tp=tp, two=True)
        out[shape] = (want, ranks, str(tmp / "ckpt"))
    return out


@pytest.mark.parametrize("shape,case", CASES)
def test_split_grads_match_the_reference_rank_by_rank(runs, shape, case):
    """The loss, every gradient leaf (``embed`` and ``lm_head`` the rank's
    shard of the reference's whole gradient) and the traffic state."""
    want, ranks, _ = runs[shape]
    for r, got in enumerate(ranks):
        h.check_grads(want, got, case, r, shape, tp=_tp(shape, case))
        cfg = h.reduced(ARCH_OF[shape, case])
        dim = sharding.vocab_dim("embed", (cfg.vocab, cfg.d_model), shape[1])
        assert got[f"{case}/g/embed"].shape[dim] * shape[1] == (
            want[f"{case}/g/embed"].shape[dim]), (r, dim)


@pytest.mark.parametrize("shape,case", CASES)
def test_split_step_and_zero1_slices_match_rank_by_rank(runs, shape, case):
    """The grad norm (clipping binding), the step's loss, the updated
    params and the rank's mu, nu and master: on the (2, 2) grid its ZeRO-1
    slices, a vocab-split ``embed``'s cut on d (``adamw.zero_dim`` skips
    the vocab dim, as the reference's ``zero1_specs``)."""
    want, ranks, _ = runs[shape]
    cfg = h.reduced(ARCH_OF[shape, case])
    for r, got in enumerate(ranks):
        h.check_step(want, got, case, r, shape, tp=_tp(shape, case))
        if shape == GRID and cfg.vocab % shape[1] == 0:
            assert got[f"{case}/mu/embed"].shape == (
                cfg.vocab // 2, cfg.d_model // 2), r


@pytest.mark.parametrize("shape,case", CASES)
def test_split_params_after_two_steps_match(runs, shape, case):
    """After two steps each rank's params are the reference's, cut to its
    shards and lane; the replicated leaves hold the same bits on every
    rank, each shard of the pair on the data ranks that hold it."""
    want, ranks, _ = runs[shape]
    tp = _tp(shape, case)
    pre = f"{case}/p2/"
    for r, got in enumerate(ranks):
        keys = [k for k in want if k.startswith(pre)]
        assert keys and sorted(keys) == sorted(k for k in got
                                               if k.startswith(pre))
        for k in keys:
            path = k[len(pre):]
            close_updated(got[k], h.lane_of(want[k], path, r, shape, tp=tp),
                          h.lane_of(h.update_room(want, case, path, 2), path,
                                    r, shape, tp=tp), f"{case} rank {r} {k}")
    assert h.replicated_bits_differ(ranks, case, tp=tp) == []
    for path in sharding.VOCAB_DIM:
        k = pre + path
        for lane in range(shape[1]):
            for d in range(1, shape[0]):
                assert np.array_equal(ranks[lane][k],
                                      ranks[lane + d * shape[1]][k]), k
        assert not np.array_equal(ranks[0][k], ranks[1][k]), k


def test_checkpoint_is_the_reference_layout_and_restores_anywhere(runs):
    """The (2, 2) grid's checkpoint of split leaves: the reference's
    ``checkpointer.restore`` reads it as the one-rank restore does, bit for
    bit; each rank's held params and ZeRO-1 state are the whole leaves'
    cut; the restores onto the (2, 2) grid, a (1, 2) grid and one rank give
    one loss."""
    _, ranks, ckpt = runs[GRID]
    one = {k[len("ckpt/one/"):]: v for k, v in ranks[0].items()
           if k.startswith("ckpt/one/")}
    p = h.nest((k[2:], v) for k, v in one.items() if k.startswith("p/"))
    tree = {kind: h.nest((k[len(kind) + 1:], v) for k, v in one.items()
                         if k.startswith(kind + "/"))
            for kind in ("mu", "nu", "master")}
    zeros = lambda t: jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), t)
    ref, step = jckpt.restore(ckpt, (zeros(p), jadamw.AdamWState(
        jnp.int32(0), zeros(tree["mu"]), zeros(tree["nu"]),
        zeros(tree["master"]))))
    assert step == 1
    mine = jax.tree.leaves((p, tree["mu"], tree["nu"], tree["master"]))
    theirs = [np.asarray(x) for x in jax.tree.leaves(
        (ref[0], ref[1].mu, ref[1].nu, ref[1].master))]
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert a.shape == b.shape and np.array_equal(a, b)
    for r, got in enumerate(ranks):
        for k, w in one.items():
            kind, path = k.split("/", 1)
            held = got[f"ckpt/held/{path}" if kind == "p"
                       else f"ckpt/held_{kind}/{path}"]
            cut = h.lane_of if kind == "p" else h.state_of_rank
            np.testing.assert_array_equal(held, cut(w, path, r, GRID,
                                                    tp=True), err_msg=k)
        for pair in ("loss22", "loss12"):
            if f"ckpt/{pair}" in got:
                h.close(got[f"ckpt/{pair}"], ranks[0]["ckpt/loss1"], pair)
    for r in range(2):
        np.testing.assert_array_equal(ranks[r]["ckpt/embed12"],
                                      np.split(one["p/embed"], 2)[r])


def test_replicated_bucket_no_longer_holds_the_pair(runs):
    """On every rank of the (1, 4) grid, with and without TP, the leaves
    summed over the group as replicated are neither ``embed`` nor
    ``lm_head`` (split, their gradients whole on each rank), and still the
    final norm and the router."""
    _, ranks, _ = runs[TP4]
    for r, got in enumerate(ranks):
        for tp in (False, True):
            bucket = set(got[f"bucket/{tp}"].tolist())
            assert not bucket & set(sharding.VOCAB_DIM), (r, tp, bucket)
            assert {"final_norm", "layers/moe/router"} <= bucket, (r, tp)


@pytest.mark.parametrize("m", (2, 4))
@pytest.mark.parametrize("vocab", (256, ODD))
def test_convert_cuts_the_pair_as_the_reference_shards_it(m, vocab):
    """``convert.params_from_jax(..., model=(m, r), tp=False)`` holds, of
    ``embed`` and ``lm_head``, the r-th of m equal blocks on the dim the
    reference's ``param_specs`` puts on "model" (the vocab, or d where m
    does not divide it); every other leaf whole.  ``sharding.param_spec``
    names that dim."""
    arch = f"{MOE}@{vocab}"
    flat = h.params(arch, ep=1, node=1)
    specs = h.flat(jparam_specs(
        h.nest((k, jnp.zeros(v.shape)) for k, v in flat.items()),
        multi_pod=False, model_size=m))
    for r in range(m):
        got = h.flat(convert.params_from_jax(h.nest(flat.items()), "cpu",
                                             model=(m, r), tp=False))
        for path, a in flat.items():
            if path not in sharding.VOCAB_DIM:
                np.testing.assert_array_equal(got[path].numpy(), a)
                continue
            dims = tuple(specs[path]) + (None,) * a.ndim
            dim = [i for i, x in enumerate(dims[:a.ndim])
                   if x in ("model", ("model",))]
            assert len(dim) == 1, (path, specs[path])
            spec = sharding.param_spec(path, a.shape, model_size=m)
            assert spec.model % a.ndim == dim[0], path
            np.testing.assert_array_equal(got[path].numpy(),
                                          np.split(a, m, axis=dim[0])[r])


class _Grid:
    """A stand-in (data, model) grid: a model group of ``model`` ranks."""
    data, data_group, grid = 1, None, None

    def __init__(self, model):
        self.model, self.ep_group = model, "model"


@pytest.mark.parametrize("arch", (FFN, MOE))
def test_prefill_refuses_a_vocab_split_context(monkeypatch, arch):
    """A training context over a model group (the pair split, with or
    without TP) refuses to prefill or decode; a serving context
    (``split_vocab=False``, ``explicit_tp=False``) over the same group
    does not split the pair, and a split context refuses a whole leaf."""
    cfg = h.reduced(arch)
    monkeypatch.setattr(lm, "group_size", lambda g: 2 if g == "model" else 1)
    ctx = lm.make_context(cfg, "cpu", mesh=_Grid(2), explicit_tp=False)
    assert lm.vocab_parallel(ctx) and not lm.tensor_parallel(ctx)
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="split_vocab=False"):
        lm.prefill({}, tokens, torch.arange(4), ctx, 8)
    serving = lm.make_context(cfg, "cpu", mesh=_Grid(2), explicit_tp=False,
                              split_vocab=False)
    assert not lm.vocab_parallel(serving)
    assert lm.model_dim(serving)("embed") is None
    whole = torch.zeros((cfg.vocab, cfg.d_model))
    with pytest.raises(ValueError, match="shard_params"):
        lm._embed(whole, tokens, ctx)
