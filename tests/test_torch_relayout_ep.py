"""The re-layout over ranks that each hold a lane: the port on four spawned
gloo ranks against the reference under ``shard_map`` on 4 forced host
devices (one subprocess, run at the same time).

- Every engine under the reference's zipf table (12 experts on 4 lanes x 4
  slots, the hottest experts replicated with non-uniform counts; the
  reference's ``TABLE_GRAD_CODE``): outputs and the gradients of the
  laid-out weights, scattered back to the canonical experts, against the
  JAX engines and the dense oracle; ``ragged`` (which XLA:CPU cannot run)
  against the port's ``fused_flat``.
- The reference's ``REPLICATED_CONTINUITY_CODE`` scenario rank by rank
  (reduced qwen3-moe, float32, fused_flat): a step, a relayout onto a
  replicated table (3 slots a lane), three steps in which the replicas
  drift, and a relayout from it that carries the replica mean: the tables,
  losses and each rank's lane of the params and AdamW state.  The loss at
  fixed parameters is unchanged by each migration.  A mutation that sources
  every slot from replica 0 misses the reference.
- On a (2, 2) (data, model) grid with ZeRO-1 (three layers, so AdamW's
  state is cut on the slot axis, and after a relayout onto 5 slots a lane on
  d_model): each rank's migrated params and mu, nu and master slices equal
  the slices of the unsharded migration bit for bit, twice.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_ep_train as harness
from torch_adam import close_updated
from conftest import run_devices
from xla_prelude import PRELUDE
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core import dcomm, fusco, relayout, routing, traffic
from repro_torch.core.dcomm import DcommConfig
from repro_torch.launch import steps, train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lm, zoo
from repro_torch.optim import adamw

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

EP, E, K, NS = 4, 12, 2, 2
T, D, F = 16 * EP, 16, 24
CF = 8.0
NAMES = ("x", "wr", "w1", "w3", "w2")
# (name, engine, DcommConfig extras): fused_pipe at a fixed slice count (the
# reference's pipe constants are another card's)
ENGINES = (("flat", "fused_flat", {}), ("dedup", "fused_flat", {"dedup": True}),
           ("pipe", "fused_pipe", {"pipe_slices": 4}),
           ("hier", "fused_hier", {}), ("disagg", "disagg", {}))
ARCH = "qwen3-moe-30b-a3b"
OPT = dict(lr=3e-3, warmup_steps=1, total_steps=8)
SPL = 3                      # slots a lane of the replicated tables
DRIFT = 3                    # steps under the replicated table
GRID, GRID_LAYERS, GRID_SPL = (2, 2), 3, 5
WEIGHTS = tuple(f"layers/moe/{n}" for n in train.MOE_WEIGHTS)


def _zipf_table(solve):
    return solve(1.0 / np.arange(1, E + 1), ep=EP, node_size=NS,
                  slots_per_lane=4)


def _engine_data() -> dict:
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(x=f32(T, D), wr=f32(D, E) * 0.5, w1=f32(E, D, F) * 0.1,
                w3=f32(E, D, F) * 0.1, w2=f32(E, F, D) * 0.1, cot=f32(T, D))


JAX_CODE = """
import dataclasses, numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.configs import get_arch
from repro.core import fusco, relayout, traffic
from repro.core.dcomm import DcommConfig
from repro.launch.steps import make_train_step
from repro.launch.train import _migrate_moe_tree, apply_relayout
from repro.models import lm, zoo
from repro.optim import adamw
from torch_adam import step_slack

out = {{}}
d = np.load({data!r})
EP, E, K = {ep}, {e}, {k}
table = relayout.solve_placement(1.0 / np.arange(1, E + 1), ep=EP,
                                 node_size={ns}, slots_per_lane=4)
tbl = jnp.asarray(table.lane_expert).reshape(-1)
mesh = make_mesh((EP,), ("model",))
args = [jnp.asarray(d["x"]), jnp.asarray(d["wr"])] + [
    jnp.asarray(d[n])[tbl] for n in ("w1", "w3", "w2")]
for name, engine, kw in {engines!r}:
    cfg = DcommConfig(engine=engine, ep_axis="model", node_size={ns},
                      capacity_factor={cf}, **kw)
    g = shard_map(lambda x, wr, a, b, c: fusco.moe_shuffle_ffn(
                      x, wr, a, b, c, table, cfg, K),
                  mesh=mesh, in_specs=(P("model"), P(), P("model"),
                                       P("model"), P("model")),
                  out_specs=P("model"), check_vma=False)

    def fwd_bwd(*a):
        y, vjp = jax.vjp(g, *a)
        return y, vjp(jnp.asarray(d["cot"]))

    y, grads = jax.jit(fwd_bwd).lower(*args).compile({fast!r})(*args)
    out[name] = np.asarray(y)
    for n, v in zip({names!r}, grads):
        out[name + "_d" + n] = np.asarray(v)


def flat(tree, prefix=""):
    o = {{}}
    for k, v in tree.items():
        if isinstance(v, dict):
            o.update(flat(v, prefix + k + "/"))
        else:
            o[prefix + k] = v
    return o


def nest(items):
    tree = {{}}
    for k, v in items:
        node = tree
        *path, leaf = k.split("/")
        for part in path:
            node = node.setdefault(part, {{}})
        node[leaf] = v
    return tree


def save(prefix, params, opt, room):
    for kind, tree in (("p", params), ("mu", opt.mu), ("nu", opt.nu),
                       ("master", opt.master), ("room", room)):
        for k, v in flat(tree).items():
            out[prefix + "/" + kind + "/" + k] = np.asarray(v)


mesh = make_mesh((1, EP), ("data", "model"))
cfg = get_arch({arch!r}).reduced()
ctx = dataclasses.replace(
    lm.make_context(cfg, mesh, multi_pod=False, engine="fused_flat",
                    capacity_factor={cf}, node_size={ns}),
    compute_dtype=jnp.float32, remat=False)
params = jax.tree.map(jnp.asarray, nest(
    (k[2:], d[k]) for k in d.files if k.startswith("p/")))
batch = {{k: jnp.asarray(d[k]) for k in ("tokens", "labels")}}
opt_cfg = adamw.AdamWConfig(**{opt!r})
quiet = lambda *a, **kw: None
losses = []
with mesh:
    opt = adamw.init(params)
    st = traffic.init_traffic_state(cfg.moe.n_experts, EP,
                                    n_layers=cfg.n_layers)
    step = jax.jit(make_train_step(zoo.build(cfg, ctx), opt_cfg))
    # each element's room for the AdamW steps taken (tests/torch_adam.py),
    # summed over the steps and migrated with the weights
    room = jax.tree.map(lambda p: np.zeros(p.shape), params)

    def stepped(room, opt, i):
        lr = float(adamw.schedule(opt_cfg, jnp.int32(i)))
        return jax.tree.map(lambda r, m, v: r + step_slack(
            np.asarray(m), np.asarray(v), i, lr, opt_cfg), room, opt.mu,
            opt.nu)

    params, opt, m = step(params, opt, batch, st)
    room = stepped(room, opt, 1)
    st = m.pop("traffic")
    losses.append(float(m["loss"]))
    out["ema1"] = np.asarray(st.expert_ema)
    old = ctx.placement
    params, opt, ctx, stats = apply_relayout(params, opt, st, ctx,
                                             slots_per_lane={spl}, log=quiet)
    room = _migrate_moe_tree(room, old, ctx.placement)
    out["table1"] = np.asarray(ctx.placement.lane_expert)
    save("r1", params, opt, room)
    step = jax.jit(make_train_step(zoo.build(cfg, ctx), opt_cfg))
    for i in range({drift}):
        params, opt, m = step(params, opt, batch, st)
        room = stepped(room, opt, i + 2)
        st = m.pop("traffic")
        losses.append(float(m["loss"]))
    save("drift", params, opt, room)
    out["ema2"] = np.asarray(st.expert_ema)
    old = ctx.placement
    params, opt, ctx, stats = apply_relayout(params, opt, st, ctx,
                                             slots_per_lane={spl}, log=quiet)
    room = _migrate_moe_tree(room, old, ctx.placement)
    out["table2"] = np.asarray(ctx.placement.lane_expert)
    save("r2", params, opt, room)
out["losses"] = np.asarray(losses)
np.savez({out!r}, **out)
print("JAX_OK")
"""


def _lane_rows(a, r, n=EP):
    k = a.shape[0] // n
    return a[r * k:(r + 1) * k]


def _engines(rank, d, groups) -> dict:
    """Every engine of ENGINES and ragged under the zipf table on this
    rank's token shard and lane of the laid-out weights: outputs and the
    gradients of x, the router and the rank's slots."""
    table = _zipf_table(relayout.solve_placement)
    slots = relayout.slot_table(table)
    out = {}
    for name, engine, kw in ENGINES + (("ragged", "ragged", {}),):
        cfg = DcommConfig(engine=engine, node_size=NS, capacity_factor=CF,
                          **kw)
        ts = [torch.from_numpy(_lane_rows(d["x"], rank)),
              torch.from_numpy(d["wr"])] + [
            _lane_rows(torch.from_numpy(d[n])[slots], rank)
            for n in ("w1", "w3", "w2")]
        ts = [t.clone().requires_grad_(True) for t in ts]
        y = fusco.moe_shuffle_ffn(*ts, table, cfg, K, group=groups)
        gs = torch.autograd.grad(
            (y * torch.from_numpy(_lane_rows(d["cot"], rank))).sum(), ts)
        out[name] = y.detach().numpy()
        out.update({f"{name}_d{n}": g.numpy() for n, g in zip(NAMES, gs)})
    return out


def _save(out: dict, prefix: str, params, opt) -> None:
    for kind, tree in (("p", params), ("mu", opt.mu), ("nu", opt.nu),
                       ("master", opt.master)):
        for k, v in harness.flat(tree).items():
            out[f"{prefix}/{kind}/{k}"] = v.detach().numpy().copy()


def _clone(params, opt):
    """Copies of ``params`` and ``opt`` (a relayout writes in place)."""
    copy = lambda tree: adamw.tree_map(lambda t: t.detach().clone(), tree)
    return copy(params), adamw.AdamWState(opt.step, copy(opt.mu),
                                          copy(opt.nu), copy(opt.master))


def _replica0_leaf(t, old, new, lanes, cut_old, cut_new, whole_new, group,
                   mult):
    """The mutation: every destination slot sourced from its expert's old
    replica 0 (``relayout.migration_gather_index``) instead of the mean,
    over an EP group without ZeRO cuts (the whole stack all-gathered)."""
    stack = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(stack, t.contiguous(), group=group)
    whole = torch.cat(stack, 1)
    flat = whole.reshape(whole.shape[0], -1, *whole.shape[3:])
    idx = relayout.migration_gather_index(old, new).long()
    rows = flat[:, idx].reshape(whole.shape[0], new.ep, -1, *whole.shape[3:])
    return rows[:, lanes.start:lanes.stop].contiguous().to(t.dtype)


def _continuity(rank, d) -> dict:
    """The replicated-table scenario on this rank of an EP group of four."""
    cfg = get_arch(ARCH).reduced()
    ctx = lm.make_context(cfg, "cpu", ep_group=dist.group.WORLD,
                          engine="fused_flat", capacity_factor=CF,
                          node_size=NS, compute_dtype=torch.float32,
                          explicit_tp=False)     # the replicated layout
    tree = harness.nest((k[2:], d[k]) for k in d.files if k.startswith("p/"))
    params = convert.params_from_jax(tree, "cpu", lane=rank,
                                     model=(EP, rank), tp=False)
    batch = {k: torch.from_numpy(d[k]).long() for k in ("tokens", "labels")}
    opt_cfg = adamw.AdamWConfig(**OPT)
    model = zoo.build(cfg, ctx)
    opt = steps.init_state(model, params)
    st = traffic.init_traffic_state(cfg.moe.n_experts, EP,
                                    n_layers=cfg.n_layers)
    quiet = lambda *a, **k: None
    out, losses = {}, []

    def take_step():
        nonlocal params, opt, st
        params, opt, m = steps.make_train_step(model, opt_cfg)(
            params, opt, batch, st)
        st = m.pop("traffic")
        losses.append(float(m["loss"]))

    def fixed_loss():
        with torch.no_grad():
            return float(model.loss(params, batch)[0])

    take_step()
    out["ema1"] = st.expert_ema.numpy().copy()
    before = fixed_loss()
    params, opt, ctx, _ = train.apply_relayout(params, opt, st, ctx,
                                               slots_per_lane=SPL, log=quiet)
    model = zoo.build(cfg, ctx)
    out["loss_fixed1"] = np.array([before, fixed_loss()])
    out["table1"] = ctx.placement.lane_expert.copy()
    _save(out, "r1", params, opt)
    # a copy migrated from the fresh replicated table onto another
    agree = train.apply_relayout(
        *_clone(params, opt), st._replace(expert_ema=st.expert_ema.flip(-1)),
        ctx, slots_per_lane=SPL, log=quiet)
    assert not np.array_equal(agree[2].placement.lane_expert,
                              ctx.placement.lane_expert)
    with torch.no_grad():
        out["loss_fixed_agree"] = np.array([fixed_loss(), float(zoo.build(
            cfg, agree[2]).loss(agree[0], batch)[0])])
    del agree
    for _ in range(DRIFT):
        take_step()
    _save(out, "drift", params, opt)
    out["ema2"] = st.expert_ema.numpy().copy()
    kept = _clone(params, opt)
    params, opt, ctx2, _ = train.apply_relayout(params, opt, st, ctx,
                                                slots_per_lane=SPL, log=quiet)
    out["table2"] = ctx2.placement.lane_expert.copy()
    _save(out, "r2", params, opt)
    migrate, train._migrate_leaf = train._migrate_leaf, _replica0_leaf
    try:
        mp_, mopt, _, _ = train.apply_relayout(*kept, st, ctx,
                                               slots_per_lane=SPL, log=quiet)
    finally:
        train._migrate_leaf = migrate
    _save(out, "mutant", mp_, mopt)
    out["losses"] = np.array(losses)
    return out


def _grid_cfg():
    return dataclasses.replace(get_arch(ARCH).reduced(), n_layers=GRID_LAYERS)


KINDS = ("p", "mu", "nu", "master")


def _seeded(kind: str, i: int, shape, scale=1.0) -> np.ndarray:
    seed = 100 * KINDS.index(kind) + i
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)


def _grid_loads(i: int) -> np.ndarray:
    rng = np.random.default_rng(10 + i)
    return (rng.random((GRID_LAYERS, 8)) * np.array(
        [6.0, 1, 1, 3.0, 1, 1, 1, 1])).astype(np.float32)


def _cut(kind: str, whole: np.ndarray, path: str, rank: int) -> np.ndarray:
    """A whole leaf as ``rank`` of the grid holds it: its lane, and for
    AdamW's state its ZeRO-1 slice."""
    cut = harness.lane_of if kind == "p" else harness.state_of_rank
    return np.ascontiguousarray(cut(whole, path, rank, GRID))


def _drift(kind: str, name: str, whole_shape) -> np.ndarray:
    """The seeded drift added to a whole expert leaf after each relayout."""
    return _seeded(kind, 50 + train.MOE_WEIGHTS.index(name), whole_shape,
                   0.01)


def _grid(rank, g) -> dict:
    """Two relayouts on a (2, 2) grid: from the arithmetic placement onto
    5 slots a lane, then (the slots drifted apart) onto another table of
    5.  The params are ``g``'s seeded whole tree, AdamW's state a seeded
    whole tree of each kind, cut to the rank."""
    mesh = make_host_mesh(*GRID)
    cfg = _grid_cfg()
    ctx = lm.make_context(cfg, "cpu", mesh=mesh, engine="fused_flat",
                          node_size=1, capacity_factor=CF,
                          compute_dtype=torch.float32, explicit_tp=False)
    whole = {k[2:]: g[k] for k in g.files if k.startswith("g/")}
    tree = lambda kind: harness.nest(
        (k, torch.from_numpy(_cut(kind, v if kind == "p" else _seeded(
            kind, i, v.shape), k, rank))) for i, (k, v) in
        enumerate(whole.items()))
    params = tree("p")
    opt = adamw.AdamWState(1, tree("mu"), tree("nu"), tree("master"))
    st = traffic.init_traffic_state(8, GRID[1], n_layers=GRID_LAYERS)
    rows = train.data_rows(harness.B, GRID[0], rank // GRID[1])
    batch = {k: torch.from_numpy(g[k][rows]).long()
             for k in ("tokens", "labels")}
    out = {}
    for i in range(2):
        st = st._replace(expert_ema=torch.from_numpy(_grid_loads(i)))
        loss = lambda: float(zoo.build(cfg, ctx).loss(params, batch)[0])
        with torch.no_grad():
            before = loss()
        params, opt, ctx, _ = train.apply_relayout(
            params, opt, st, ctx, slots_per_lane=GRID_SPL,
            log=lambda *a, **k: None)
        with torch.no_grad():
            out[f"grid{i}/loss_fixed"] = np.array([before, loss()])
        out[f"grid{i}/table"] = ctx.placement.lane_expert.copy()
        _save(out, f"grid{i}", params, opt)
        for kind, t in zip(KINDS, (params, opt.mu, opt.nu, opt.master)):
            for n in train.MOE_WEIGHTS:
                leaf = t["layers"]["moe"][n]
                shape = (GRID_LAYERS, GRID[1],
                         *params["layers"]["moe"][n].shape[2:])
                leaf.add_(torch.from_numpy(_cut(
                    kind, _drift(kind, n, shape), f"layers/moe/{n}", rank)))
    return out


def _rank_main(rank, world, init_file, data, grid_data, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        d, g = np.load(data), np.load(grid_data)
        out = _engines(rank, d, dcomm.ep_groups(dist.group.WORLD, NS))
        out.update(_continuity(rank, d))
        out.update(_grid(rank, g))
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def _close(got, want, what, tol=harness.TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _canon(lanes: list, table) -> np.ndarray:
    """The ranks' gradients of their slots, stacked lane-major and
    scattered back onto the canonical experts."""
    g = np.concatenate(lanes)
    out = np.zeros((E,) + g.shape[1:], np.float32)
    np.add.at(out, relayout.placement_table(table).reshape(-1), g)
    return out


def _dense(d) -> dict:
    ts = [torch.from_numpy(d[n]).requires_grad_(True) for n in NAMES]
    y = fusco.dense_moe_reference(*ts, K)
    gs = torch.autograd.grad((y * torch.from_numpy(d["cot"])).sum(), ts)
    return {"y": y.detach().numpy(),
            **{f"d{n}": g.numpy() for n, g in zip(NAMES, gs)}}


def _grid_oracle(g, rank: int, tables) -> dict:
    """The unsharded migration of the seeded whole trees onto ``tables``
    (each relayout's), with the same drift after each, cut to ``rank``."""
    whole = {k[2:]: g[k] for k in g.files if k.startswith("g/")}
    trees = {kind: {k: torch.from_numpy(v if kind == "p" else _seeded(
        kind, i, v.shape)) for i, (k, v) in enumerate(whole.items())}
        for kind in KINDS}
    old = routing.ExpertPlacement(8, GRID[1], 1)
    out = {}
    for i, tbl in enumerate(tables):
        new = relayout.TablePlacement(tbl, node_size=1, n_experts=8)
        for kind, tree in trees.items():
            for k in WEIGHTS:
                t = relayout.migrate_lane_major(tree[k], old, new, lane_axis=1)
                out[f"grid{i}/{kind}/{k}"] = _cut(kind, t.numpy(), k, rank)
                tree[k] = t + torch.from_numpy(
                    _drift(kind, k.split("/")[-1], t.shape))
        old = new
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocess and the four gloo ranks, once for the module:
    (the reference's arrays, each rank's arrays, the engine and scenario
    data, the grid's data)."""
    tmp_path = tmp_path_factory.mktemp("relayout_ep")
    cfg = get_arch(ARCH).reduced()
    data = tmp_path / "data.npz"
    np.savez(data, **_engine_data(), **harness.batch(cfg.vocab),
             **{"p/" + k: v for k, v in harness.params(ARCH, ep=EP,
                                                       node=NS).items()})
    gcfg = _grid_cfg()
    grid_data = tmp_path / "grid.npz"
    # the reduced tree's two layers and a third, a copy of the first
    gparams = {k: np.concatenate([v, v[:1]]) if k.startswith("layers/") else v
               for k, v in harness.params(ARCH, ep=GRID[1], node=1).items()}
    np.savez(grid_data, **harness.batch(gcfg.vocab),
             **{"g/" + k: v for k, v in gparams.items()})
    code = PRELUDE + JAX_CODE.format(
        data=str(data), ep=EP, e=E, k=K, ns=NS, cf=CF, engines=ENGINES,
        fast=harness.FAST, names=NAMES, arch=ARCH, opt=OPT, spl=SPL,
        drift=DRIFT, out=str(tmp_path / "jax.npz"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(run_devices, code, EP, 600)
        mp.spawn(_rank_main, args=(EP, str(tmp_path / "rendezvous"),
                                   str(data), str(grid_data), str(tmp_path)),
                 nprocs=EP, join=True)
        assert "JAX_OK" in jax_run.result()
    want = dict(np.load(tmp_path / "jax.npz"))
    got = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(EP)]
    return want, got, np.load(data), np.load(grid_data)


@pytest.mark.parametrize("name", [e[0] for e in ENGINES] + ["ragged"])
def test_every_engine_under_a_replicated_table(runs, name):
    """Outputs, dx, the router's gradient and the laid-out weights'
    gradients scattered onto the canonical experts: against the JAX engine
    (``ragged``: the port's fused_flat) and the dense oracle."""
    want, got, d, _ = runs
    table = _zipf_table(relayout.solve_placement)
    assert table.max_replicas > 1 and len(set(table.n_replicas)) > 2
    dense = _dense(d)
    ref = want if name != "ragged" else {
        k.replace("flat", "ragged", 1): np.concatenate(
            [got[r][k] for r in range(EP)]) for k in got[0]
        if k.startswith("flat")}
    for r in range(EP):
        _close(got[r][name], _lane_rows(ref[name], r), f"{name} rank {r}")
        _close(got[r][f"{name}_dx"], _lane_rows(ref[f"{name}_dx"], r),
               f"{name} dx rank {r}")
    _close(np.concatenate([got[r][name] for r in range(EP)]), dense["y"],
           f"{name} vs the dense oracle")
    _close(sum(got[r][f"{name}_dwr"] for r in range(EP)),
           ref[f"{name}_dwr"] if name != "ragged" else dense["dwr"],
           f"{name} router grad")
    for n in ("w1", "w3", "w2"):
        mine = _canon([got[r][f"{name}_d{n}"] for r in range(EP)], table)
        if name != "ragged":
            _close(mine, _canon([want[f"{name}_d{n}"]], table),
                   f"{name} d{n} canonical vs JAX")
        _close(mine, dense[f"d{n}"], f"{name} d{n} vs the dense oracle")


def test_replicated_scenario_tables_losses_and_traffic(runs):
    want, got, _, _ = runs
    _close(got[0]["losses"], want["losses"], "losses")
    for r in range(EP):
        assert got[r]["losses"].tolist() == got[0]["losses"].tolist()
        np.testing.assert_array_equal(got[r]["table1"], want["table1"])
        np.testing.assert_array_equal(got[r]["table2"], want["table2"])
        _close(got[r]["ema1"], want["ema1"], "ema1")
        _close(got[r]["ema2"], want["ema2"], "ema2")
    assert np.bincount(want["table1"].reshape(-1)).max() > 1  # replicas


def test_replicated_scenario_state_rank_by_rank(runs):
    """Each rank's lane of the params, mu, nu and master after the relayout
    onto the replicated table, after the drift and after the relayout from
    it (the replica mean)."""
    want, got, _, _ = runs
    t1 = want["table1"].reshape(-1)
    drifted = want["drift/p/layers/moe/w1"]
    drifted = drifted.reshape(drifted.shape[0], -1, *drifted.shape[3:])
    e = int(np.argmax(np.bincount(t1)))
    a, b = np.flatnonzero(t1 == e)[:2]
    assert not np.allclose(drifted[:, a], drifted[:, b])   # they drifted
    for r in range(EP):
        for stage in ("r1", "drift", "r2"):
            for kind in KINDS:
                for k in WEIGHTS:
                    _updated_close(got[r], want, stage, kind, k, r)


def _updated_close(got: dict, want: dict, stage: str, kind: str, path: str,
                   r: int, mine: str | None = None) -> None:
    """Rank ``r``'s lane of ``stage``'s ``kind`` leaf at ``path`` (in
    ``got`` under ``mine``, default that stage's) against the reference's:
    mu and nu at TOL, params and master with their room for the steps taken
    (``torch_adam``)."""
    key = f"{stage}/{kind}/{path}"
    mine = mine or key
    w = harness.lane_of(want[key], path, r)
    if kind in ("mu", "nu"):
        _close(got[mine], w, f"rank {r} {mine}")
    else:
        close_updated(got[mine], w, harness.lane_of(
            want[f"{stage}/room/{path}"], path, r), f"rank {r} {mine}")


def test_loss_at_fixed_params_is_unchanged_by_a_migration(runs):
    """Unchanged by a migration whose old copies agree: from the arithmetic
    placement, from the fresh replicated table onto another, and on the
    grid's first relayout.  (From drifted replicas the mean replaces each
    copy, so the loss moves.)"""
    _, got, _, _ = runs
    for r in range(EP):
        for key in ("loss_fixed1", "loss_fixed_agree", "grid0/loss_fixed"):
            before, after = got[r][key]
            np.testing.assert_allclose(after, before, rtol=1e-5,
                                       err_msg=f"rank {r} {key}")


def test_sourcing_replica_zero_misses_the_reference(runs):
    """The mutation (every slot from its expert's old replica 0) misses
    JAX's migrated params, mu, nu and master, where the mean meets them."""
    want, got, _, _ = runs

    def misses(r, kind, k):
        try:
            _updated_close(got[r], want, "r2", kind, k, r,
                           mine=f"mutant/{kind}/{k}")
        except AssertionError:
            return True
        return False

    missed = {kind for r in range(EP) for kind in KINDS for k in WEIGHTS
              if misses(r, kind, k)}
    assert missed == set(KINDS), missed


def test_grid_zero1_migration_is_the_unsharded_one_bit_for_bit(runs):
    _, got, _, g = runs
    gcfg = _grid_cfg()
    tables = [got[0][f"grid{i}/table"] for i in range(2)]
    for i, tbl in enumerate(tables):
        loads = _grid_loads(i).sum(axis=0)
        solved = relayout.solve_placement(loads, ep=GRID[1], node_size=1,
                                          slots_per_lane=GRID_SPL)
        np.testing.assert_array_equal(tbl, solved.lane_expert)
        assert np.bincount(tbl.reshape(-1)).max() == 2
    for r in range(EP):
        for i in range(2):
            np.testing.assert_array_equal(got[r][f"grid{i}/table"], tables[i])
        oracle = _grid_oracle(g, r, tables)
        for key, w in oracle.items():
            assert got[r][key].shape == w.shape, (r, key)
            np.testing.assert_array_equal(got[r][key], w, f"rank {r} {key}")
    # the state really was cut on the slot axis, then on d_model
    mu0 = (GRID_LAYERS, 1, 4, gcfg.d_model, gcfg.moe.d_ff_expert)
    assert adamw.zero_dim(mu0, GRID[0], True) == 2
    assert adamw.zero_dim(mu0[:2] + (GRID_SPL,) + mu0[3:], GRID[0], True) == 3
