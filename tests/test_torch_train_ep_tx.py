"""Training the moe_tx family over an EP group: reduced ``moe-tx-stream`` in
float32 on four gloo ranks, each holding its lane of the expert weights,
against the reference's ``make_train_step`` under ``shard_map`` on a (1, 4)
mesh (``torch_ep_train``), through the per-layer barriers of ``fused_flat``
and ``fused_hier`` (nodes of 2) and the streamed ``fused_pipe`` (one block
of both layers, ``--moe-stream 2``, at 2 slices).

Rank by rank: the loss, every gradient leaf, the traffic state, the grad
norm with clipping binding, and after one step the params, mu, nu, master
and the state; without the replicated leaves' reduction the gradients miss
the reference's; after two steps the replicated leaves hold the same bits on
every rank.  Then ``train.run`` over the group of four gives, on every rank,
the losses and the final traffic state of a hand loop of the train step.
Tolerance 1e-5 relative to each leaf's max(1, |x|); counts exactly.
"""

import numpy as np
import pytest
import torch.distributed as dist

import torch_ep_train as h
from repro_torch.core import traffic
from repro_torch.data.pipeline import to_device
from repro_torch.launch import steps, train
from repro_torch.models import zoo
from repro_torch.optim import adamw

ARCH = "moe-tx-stream"
# (engine, moe_stream, pipe_slices)
CASES = (("fused_flat", 0, 0), ("fused_hier", 0, 0), ("fused_pipe", 2, 2))
NAMES = [f"{e}/{s}" for e, _, s in CASES]
RUN = ["--arch", ARCH, "--reduced", "--engine", "fused_pipe", "--moe-stream",
       "2", "--steps", "3", "--seq", "16", "--batch", "2"]


def _extra(rank, world):
    """On each rank: ``train.run`` over the group, and a hand loop of the
    train step over the same setup and batches."""
    args = train.parse_args(RUN)
    out = train.run(args, "cpu", ep_group=dist.group.WORLD)
    s = train.setup(args, "cpu", dist.group.WORLD)
    step = steps.make_train_step(zoo.build(s.cfg, s.ctx), s.opt_cfg)
    params, opt = s.params, adamw.init(s.params)
    state = train.init_traffic(s.cfg, s.ctx, 1)
    losses = []
    for i in range(args.steps):
        batch = to_device(s.source.batch_at(i), "cpu")
        params, opt, m = step(params, opt, batch, state)
        state = m["traffic"]
        losses.append(float(m["loss"]))
    res = {"extra/run_losses": np.array(out["losses"]),
           "extra/hand_losses": np.array(losses)}
    for f in traffic.TrafficState._fields:
        res[f"extra/run/{f}"] = getattr(out["traffic"], f).numpy()
        res[f"extra/hand/{f}"] = getattr(state, f).numpy()
    return res


@pytest.fixture(scope="module")
def ep_run(tmp_path_factory):
    return h.run(tmp_path_factory.mktemp("train_ep_tx"), ARCH, CASES, _extra)


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


def test_train_run_over_the_group_follows_a_hand_loop(ep_run):
    """``train.run(args, "cpu", ep_group=WORLD)`` streaming moe-tx through
    fused_pipe on four ranks: on every rank the losses and the final traffic
    state (three steps counted) of a hand loop of ``make_train_step``, and
    the same on every rank."""
    _, ranks, _ = ep_run
    for r, got in enumerate(ranks):
        assert np.isfinite(got["extra/run_losses"]).all()
        np.testing.assert_array_equal(got["extra/run_losses"],
                                      got["extra/hand_losses"], err_msg=str(r))
        np.testing.assert_array_equal(got["extra/run_losses"],
                                      ranks[0]["extra/run_losses"])
        for f in traffic.TrafficState._fields:
            np.testing.assert_array_equal(got[f"extra/run/{f}"],
                                          got[f"extra/hand/{f}"], err_msg=f)
            np.testing.assert_array_equal(got[f"extra/run/{f}"],
                                          ranks[0][f"extra/run/{f}"])
        assert got["extra/run/steps"].tolist() == [3, 3]
