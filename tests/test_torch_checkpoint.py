"""Checkpoints, the fault-tolerant loop and the elastic restore of the port
against the JAX package, on the CPU.

- The on-disk layout: the port's save of a reduced qwen3-moe train state
  (bf16 params, ``AdamWState``) restored by the reference's
  ``checkpointer.restore``, and the reference's save restored by the
  port's, every leaf equal bit for bit; ``LATEST`` names a step only once
  its files are whole (a failing write leaves the last committed step).
- ``run_training``: the reference's ``test_fault_tolerant_restart`` case
  and its ``on_restart`` hook case (``tests/test_traffic.py``).
- The placement-history and traffic-EMA sidecars written by either side
  and read by the other, an old sidecar's missing fields zero-filled.
- ``train.main --relayout-every 2 --ckpt-every 2 --inject-failure-at 3``:
  the run restarts once, from step 2, and its losses equal the
  uninterrupted run's (1e-6 relative); a fresh run resumed from a copy
  committed at step 4 takes the placement of the history and the same
  losses.
- ``elastic.relayout_expert_weights`` and ``accumulation_factor`` against
  the reference's.
- Four gloo ranks (``file://`` rendezvous) on a (2, 2) grid with ZeRO-1
  save one train state; the whole leaves are each rank's lane, its shard
  of ``embed`` and ``lm_head`` (split over the model group) and slice,
  and ``elastic.remesh_restore`` onto a (1, 2) grid and onto one rank cuts
  them as the new layout holds them, bit for bit.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_ep_train as harness
from repro.checkpoint import checkpointer as jckpt
from repro.core import relayout as jrelayout
from repro.core import traffic as jtraffic
from repro.core.routing import ExpertPlacement as JPlacement
from repro.launch import train as jtrain
from repro.optim import adamw as jadamw
from repro.runtime import elastic as jelastic
from repro_torch import convert
from repro_torch.checkpoint import checkpointer
from repro_torch.configs import get_arch
from repro_torch.core import relayout, traffic
from repro_torch.core.routing import ExpertPlacement
from repro_torch.launch import steps, train
from repro_torch.launch.mesh import HostMesh, make_host_mesh
from repro_torch.models import lm, zoo
from repro_torch.optim import adamw
from repro_torch.runtime import elastic
from repro_torch.runtime.fault_tolerance import RunConfig, run_training

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

ARCH = "qwen3-moe-30b-a3b"
TRAIN = ["--reduced", "--steps", "6", "--seq", "32", "--batch", "2",
         "--engine", "fused_flat", "--relayout-every", "2", "--log-every",
         "0"]
GRID = (2, 2)
quiet = lambda *a, **k: None


def _state_arrays(seed: int = 0) -> tuple[dict, dict]:
    """A reduced qwen3-moe train state as numpy: bf16 params (ml_dtypes)
    and f32 mu, nu and master, all seeded, and the step."""
    rng = np.random.default_rng(seed)
    f32 = harness.params(ARCH, ep=1, node=1)
    params = {k: v.astype(ml_dtypes.bfloat16) for k, v in f32.items()}
    state = {kind: {k: rng.standard_normal(v.shape).astype(np.float32)
                    for k, v in f32.items()}
             for kind in ("mu", "nu", "master")}
    return params, state


def _port_tree(params: dict, state: dict, step: int):
    to = lambda flat: harness.nest((k, convert._tensor(v, "cpu"))
                                   for k, v in flat.items())
    return to(params), adamw.AdamWState(step, to(state["mu"]),
                                        to(state["nu"]), to(state["master"]))


def _jax_tree(params: dict, state: dict, step: int):
    to = lambda flat: harness.nest((k, jnp.asarray(v)) for k, v in flat.items())
    return to(params), jadamw.AdamWState(jnp.int32(step), to(state["mu"]),
                                         to(state["nu"]), to(state["master"]))


def _bits(t) -> np.ndarray:
    """A leaf's bits: bf16 as int16, anything else as it is."""
    if isinstance(t, torch.Tensor):
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t
                ).numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def _same_bits(a_leaves, b_leaves) -> None:
    assert len(a_leaves) == len(b_leaves)
    for i, (a, b) in enumerate(zip(a_leaves, b_leaves)):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f"leaf {i}")


def test_port_save_restores_in_the_reference_and_back(tmp_path):
    params, state = _state_arrays()
    port = _port_tree(params, state, 3)
    jax_state = _jax_tree(params, state, 3)
    checkpointer.wait(checkpointer.save(str(tmp_path / "port"), port, 3))
    assert jckpt.latest_step(str(tmp_path / "port")) == 3
    like = jax.tree.map(jnp.zeros_like, jax_state)
    got, step = jckpt.restore(str(tmp_path / "port"), like)
    assert step == 3 and int(got[1].step) == 3
    assert got[0]["embed"].dtype == jnp.bfloat16
    _same_bits(jax.tree.leaves(got), jax.tree.leaves(jax_state))

    jckpt.wait(jckpt.save(str(tmp_path / "ref"), jax_state, 5))
    like = jax.tree.map(torch.zeros_like, port[0]), adamw.AdamWState(
        0, *(adamw.tree_map(torch.zeros_like, t) for t in port[1][1:]))
    got, step = checkpointer.restore(str(tmp_path / "ref"), like)
    assert step == 5 and got[1].step == 3
    assert got[0]["embed"].dtype == torch.bfloat16
    flat = lambda tree: [t for _, t in checkpointer._flatten(tree)]
    _same_bits(flat(got), jax.tree.leaves(jax_state))
    # the port's leaf order is jax's: the same manifests
    def manifest(d, n):
        with open(tmp_path / d / n / "manifest.json") as f:
            return json.load(f)

    assert (manifest("port", "step_3")["leaves"]
            == manifest("ref", "step_5")["leaves"])


def test_latest_names_a_step_only_once_its_files_are_whole(tmp_path,
                                                           monkeypatch):
    params, state = _state_arrays()
    tree = _port_tree(params, state, 1)
    checkpointer.wait(checkpointer.save(str(tmp_path), tree, 2, async_=False))
    real, calls = np.save, []

    def failing(path, a):
        calls.append(path)
        if len(calls) == 3:
            raise OSError("disk full")
        real(path, a)

    monkeypatch.setattr(np, "save", failing)
    bumped = adamw.tree_map(lambda t: t + 1, tree[0]), tree[1]
    pending = checkpointer.save(str(tmp_path), bumped, 4)
    with pytest.raises(OSError, match="disk full"):
        checkpointer.wait(pending)
    monkeypatch.setattr(np, "save", real)
    assert checkpointer.latest_step(str(tmp_path)) == 2
    assert jckpt.latest_step(str(tmp_path)) == 2
    assert not os.path.exists(tmp_path / "step_4")
    assert os.path.exists(tmp_path / "step_4.tmp")
    got, step = checkpointer.restore(str(tmp_path), tree)
    assert step == 2
    _same_bits([t for _, t in checkpointer._flatten(got)],
               [t for _, t in checkpointer._flatten(tree)])
    checkpointer.wait(checkpointer.save(str(tmp_path), bumped, 4))
    assert checkpointer.latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_2", "step_4"]


def test_fault_tolerant_restart(tmp_path):
    """The reference's case: a failure at step 5 restarts from step 4 and
    replays to 10."""
    def step_fn(params, opt, batch):
        return params + 1, opt, {"loss": torch.tensor(1.0)}

    cfg = RunConfig(total_steps=10, ckpt_dir=str(tmp_path), ckpt_every=2,
                    inject_failure_at=5)
    zero = lambda: torch.zeros((), dtype=torch.int32)
    (params, opt), run = run_training(step_fn, (zero(), zero()),
                                      lambda s: None, cfg, log=quiet)
    assert run.restarts == 1
    assert int(params) == 10
    assert len(run.restore_s) == 1 and len(run.saves) == 5


def test_run_training_on_restart_hook(tmp_path):
    calls = []

    def step_fn(p, o, batch):
        return p, o, {"loss": torch.zeros(())}

    cfg = RunConfig(total_steps=6, ckpt_dir=str(tmp_path), ckpt_every=2,
                    inject_failure_at=3,
                    on_restart=lambda s, restored: calls.append((s, restored)))
    run_training(step_fn, ({"w": torch.zeros(2)}, {"m": torch.zeros(2)}),
                 lambda s: None, cfg, log=quiet)
    assert calls == [(2, True)]          # failure at 3 -> committed step 2
    calls.clear()
    # nothing committed yet: a fresh directory, the failure before step 2
    cfg = dataclasses.replace(cfg, ckpt_dir=str(tmp_path / "fresh"),
                              inject_failure_at=1)
    run_training(step_fn, ({"w": torch.zeros(2)}, {"m": torch.zeros(2)}),
                 lambda s: None, cfg, log=quiet)
    assert calls == [(0, False)]


def test_run_training_reraises_what_it_cannot_restore(tmp_path):
    """Without a checkpoint directory every failure is raised, and before
    the first commit so is one inside the step (its in-place update may be
    partial); after a commit the same failure restores."""
    def failing_at(bad):
        def step_fn(p, o, batch):
            if batch == bad and not seen:
                seen.append(batch)
                raise RuntimeError("launch failed")
            return p + 1, o, {"loss": torch.zeros(())}
        return step_fn

    zero = lambda: torch.zeros((), dtype=torch.int32)
    for ckpt, bad in ((None, 3), (None, None), (str(tmp_path / "a"), 1)):
        seen = []
        cfg = RunConfig(total_steps=4, ckpt_dir=ckpt, ckpt_every=2,
                        inject_failure_at=3 if bad is None else None)
        with pytest.raises(RuntimeError):
            run_training(failing_at(bad), (zero(), zero()), lambda s: s, cfg,
                         log=quiet)
    seen = []
    cfg = RunConfig(total_steps=4, ckpt_dir=str(tmp_path / "b"), ckpt_every=2)
    (params, _), run = run_training(failing_at(3), (zero(), zero()),
                                    lambda s: s, cfg, log=quiet)
    assert run.restarts == 1 and int(params) == 4


def _observed_traffic():
    E, EP, L = 8, 4, 3
    rng = np.random.default_rng(0)
    st = jtraffic.init_traffic_state(E, EP, n_layers=L)
    return jtraffic.TrafficState(*(
        jnp.asarray(rng.integers(0, 9, np.shape(x)).astype(np.asarray(x).dtype))
        for x in st))


def test_sidecars_round_trip_through_either_side(tmp_path):
    st = _observed_traffic()
    port_st = traffic.TrafficState(*(torch.from_numpy(np.array(x))
                                     for x in st))
    like_j = jtraffic.init_traffic_state(8, 4, n_layers=3)
    like_t = traffic.init_traffic_state(8, 4, n_layers=3)
    train.save_traffic_state(str(tmp_path / "a"), port_st, 7)
    got, step = jtrain.load_traffic_state(str(tmp_path / "a"), like_j)
    assert step == 7
    _same_bits(list(got), list(st))
    jtrain.save_traffic_state(str(tmp_path / "b"), st, 9)
    got, step = train.load_traffic_state(str(tmp_path / "b"), like_t)
    assert step == 9 and got.steps.dtype == torch.int32
    _same_bits(list(got), list(st))
    # an old sidecar, written before the commplan fields: zero-filled
    path = tmp_path / "a" / "traffic_ema.npz"
    z = dict(np.load(path))
    del z["lane_node_ema"], z["lane_cond_ema"]
    np.savez(path, **z)
    for load, like in ((train.load_traffic_state, like_t),
                       (jtrain.load_traffic_state, like_j)):
        got, step = load(str(tmp_path / "a"), like)
        assert step == 7
        _same_bits([got.expert_ema, got.steps], [st.expert_ema, st.steps])
        assert float(got.lane_node_ema.sum()) == 0.0
        assert float(got.lane_cond_ema.sum()) == 0.0
    other = traffic.init_traffic_state(16, 4, n_layers=3)
    assert train.load_traffic_state(str(tmp_path / "a"), other) is None
    assert train.load_traffic_state(str(tmp_path / "none"), like_t) is None

    E, EP, NS = 16, 4, 2
    p0 = ExpertPlacement(n_experts=E, ep=EP, node_size=NS)
    rng = np.random.default_rng(1)
    pa = relayout.solve_placement(rng.random(E), ep=EP, node_size=NS,
                                  slots_per_lane=4)
    history = [(0, p0), (4, pa)]
    train.save_placement_history(str(tmp_path / "h"), history, NS)
    for load, table in ((train.load_placement_history,
                         relayout.placement_table),
                        (jtrain.load_placement_history,
                         jrelayout.placement_table)):
        loaded = load(str(tmp_path / "h"), E)
        assert [s for s, _ in loaded] == [0, 4]
        for (_, want), (_, got) in zip(history, loaded):
            np.testing.assert_array_equal(table(got),
                                          relayout.placement_table(want))
    jtrain.save_placement_history(str(tmp_path / "j"), [
        (0, JPlacement(n_experts=E, ep=EP, node_size=NS)),
        (4, jrelayout.TablePlacement(pa.lane_expert, node_size=NS,
                                     n_experts=E))], NS)
    loaded = train.load_placement_history(str(tmp_path / "j"), E)
    for step, want in ((0, p0), (3, p0), (4, pa), (99, pa)):
        np.testing.assert_array_equal(
            relayout.placement_table(train.placement_at_step(loaded, step)),
            relayout.placement_table(want))
    assert train.load_placement_history(str(tmp_path / "none"), E) is None


def test_injected_failure_resumes_with_the_uninterrupted_losses(tmp_path,
                                                                capsys):
    plain = train.main(TRAIN, device="cpu")
    ckpt = str(tmp_path / "ckpt")
    # main's run at one rank, with the final state kept
    out = train.run(train.parse_args(TRAIN + [
        "--ckpt-dir", ckpt, "--ckpt-every", "2", "--inject-failure-at", "3"]),
        device="cpu", keep_state=True)
    printed = capsys.readouterr().out
    assert "[ft] step 3 failed (InjectedFailure" in printed
    assert "[ft] restored step 2" in printed
    assert out["run"].restarts == 1 and out["first_step"] == 0
    np.testing.assert_allclose(out["losses"], plain["losses"], rtol=1e-6)
    assert len(out["relayouts"]) == 3
    np.testing.assert_array_equal(relayout.placement_table(out["placement"]),
                                  relayout.placement_table(plain["placement"]))
    history = train.load_placement_history(ckpt, 8)
    assert [s for s, _ in history] == [0, 2, 4, 6]
    # the saved state is the run's last, bit for bit
    got, step = checkpointer.restore(ckpt, out["state"])
    assert step == 6
    leaves = lambda tree: [t.detach() if isinstance(t, torch.Tensor) else t
                           for _, t in checkpointer._flatten(tree)]
    _same_bits(leaves(got), leaves(out["state"]))

    # a fresh run on a copy committed at step 4: the history's placement
    copy = str(tmp_path / "copy")
    shutil.copytree(ckpt, copy)
    shutil.rmtree(os.path.join(copy, "step_6"))
    with open(os.path.join(copy, "LATEST"), "w") as f:
        f.write("4")
    resumed = train.main(TRAIN + ["--ckpt-dir", copy, "--ckpt-every", "2"],
                         device="cpu")
    printed = capsys.readouterr().out
    assert "[relayout] resuming with the placement active at committed " \
           "step 4" in printed and "[ft] resumed from committed step 4" \
           in printed
    assert resumed["first_step"] == 4 and resumed["run"].restarts == 0
    np.testing.assert_allclose(resumed["losses"], plain["losses"][4:],
                               rtol=1e-6)


@pytest.mark.parametrize("old, new", [((8, 4), (8, 8)), ((8, 8), (8, 4)),
                                      ((4, 8), (4, 2)), ((4, 2), (4, 8))])
def test_relayout_expert_weights_matches_the_reference(old, new):
    w = np.random.default_rng(0).standard_normal(
        (old[1], max(1, old[0] // old[1]), 3, 5)).astype(np.float32)
    got = elastic.relayout_expert_weights(
        w, ExpertPlacement(n_experts=old[0], ep=old[1], node_size=2),
        ExpertPlacement(n_experts=new[0], ep=new[1], node_size=2))
    want = jelastic.relayout_expert_weights(
        w, JPlacement(n_experts=old[0], ep=old[1], node_size=2),
        JPlacement(n_experts=new[0], ep=new[1], node_size=2))
    np.testing.assert_array_equal(got, want)
    assert elastic.accumulation_factor(4, 2) == jelastic.accumulation_factor(
        4, 2) == 2
    with pytest.raises(ValueError):
        elastic.accumulation_factor(4, 3)


def _save_tree(out: dict, key: str, tree) -> None:
    for path, t in checkpointer._flatten(tree):
        name = "/".join(str(p) for p in path)
        out[f"{key}/{name}"] = (t.detach().numpy().copy()
                                if isinstance(t, torch.Tensor) else
                                np.asarray(t, np.int32))


def _grid_rank(rank, world, init_file, data, ckpt, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        d = np.load(data)
        tree = harness.nest((k[2:], d[k]) for k in d.files
                            if k.startswith("p/"))
        mesh = make_host_mesh(*GRID)
        cfg = get_arch(ARCH).reduced()
        # the replicated attention; a TP grid's checkpoint is
        # test_torch_tp.py's
        ctx = lm.make_context(cfg, "cpu", mesh=mesh, engine="fused_flat",
                              compute_dtype=torch.float32, explicit_tp=False)
        model = zoo.build(cfg, ctx)
        # the lane and, split over the model group, embed and lm_head
        params = convert.params_from_jax(tree, "cpu", lane=rank % mesh.model,
                                         model=(mesh.model, rank % mesh.model),
                                         tp=False)
        opt = steps.init_state(model, params)
        rows = train.data_rows(harness.B, mesh.data, mesh.data_index)
        batch = {k: torch.from_numpy(d[k][rows]).long()
                 for k in ("tokens", "labels")}
        step = steps.make_train_step(model, adamw.AdamWConfig(**harness.OPT))
        params, opt, _ = step(params, opt, batch)
        lay = checkpointer.context_layout(ctx)
        assert lay.dp == 2 and lay.ep == 2
        assert lay.vocab == (cfg.vocab, cfg.d_model) and not lay.tp
        checkpointer.wait(checkpointer.save(ckpt, (params, opt), 1, lay=lay))
        assert checkpointer.latest_step(ckpt) == 1     # after the barrier
        out = {}
        _save_tree(out, "held", (params, opt))
        pair = dist.new_group([0, 1])       # a (1, 2) grid of two survivors
        if rank < 2:
            mine = convert.params_from_jax(tree, "cpu", lane=rank,
                                           model=(2, rank), tp=False)
            got, _ = elastic.remesh_restore(
                ckpt, (mine, adamw.init(mine)),
                HostMesh(1, 2, None, pair, pair), vocab=lay.vocab)
            _save_tree(out, "one_two", got)
        if rank == 0:
            whole = convert.params_from_jax(tree, "cpu")
            got, _ = elastic.remesh_restore(ckpt, (whole, adamw.init(whole)))
            _save_tree(out, "one", got)
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def test_grid_save_and_remesh_restore(tmp_path):
    cfg = get_arch(ARCH).reduced()
    data = tmp_path / "data.npz"
    np.savez(data, **harness.batch(cfg.vocab),
             **{"p/" + k: v for k, v in harness.params(ARCH, ep=GRID[1],
                                                       node=1).items()})
    ckpt = str(tmp_path / "ckpt")
    mp.spawn(_grid_rank, args=(4, str(tmp_path / "rendezvous"), str(data),
                               ckpt, str(tmp_path)), nprocs=4, join=True)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    whole = {k[4:]: v for k, v in ranks[0].items() if k.startswith("one/")}
    # the reference reads the grid's checkpoint whole: the same leaves
    like = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), harness.nest(
        (k, v) for k, v in whole.items()))
    ref, step = jckpt.restore(ckpt, (like["0"], jadamw.AdamWState(
        jnp.int32(0), like["1"]["mu"], like["1"]["nu"], like["1"]["master"])))
    assert step == 1
    names = [k for k in whole]
    _same_bits([whole[k] for k in names],
               [np.asarray(x) for x in jax.tree.leaves(ref)])
    assert int(whole["1/step"]) == 1
    for r, got in enumerate(ranks):
        for key, w in whole.items():
            held = got[f"held/{key}"]
            if key == "1/step":
                assert int(held) == int(w)
                continue
            params = key.startswith("0/")
            path = key.split("/", 1 if params else 2)[-1]
            cut = harness.lane_of if params else harness.state_of_rank
            np.testing.assert_array_equal(held, cut(w, path, r, GRID),
                                          err_msg=f"rank {r} {key}")
            if r < 2:
                np.testing.assert_array_equal(
                    got[f"one_two/{key}"], harness.lane_of(w, path, r, (1, 2)),
                    err_msg=f"(1, 2) rank {r} {key}")
    assert any(got[f"held/1/mu/{k}"].shape != whole[f"1/mu/{k}"].shape
               for got in ranks for k in ("embed", "lm_head"))   # ZeRO-1 cut


def test_the_port_imports_nothing_of_jax_or_the_reference():
    """No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
    ``jax``, ``ml_dtypes`` or the reference package ``repro``."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = [os.path.join(root, "chip_smoke.py")] + [
        os.path.join(d, f)
        for d, _, names in os.walk(os.path.join(root, "src", "repro_torch"))
        for f in names if f.endswith(".py")]
    banned = re.compile(r"^\s*(import|from)\s+(jax|ml_dtypes|repro)(\.|\s|$)",
                        re.M)
    assert len(files) > 30
    hits = []
    for f in files:
        with open(f) as fh:
            hits += [(f, m.group(0).strip()) for m in banned.finditer(fh.read())]
    assert hits == []
