"""The port's ``fused_hier``, ``fused_flat`` with ``dedup``, ``ragged`` and the
two-level (pod, model) exchange against the JAX package.

- ``core/balancer.py`` against ``repro.core.balancer`` and the exhaustive
  oracle; the hierarchical, condensed and stage-2 plans and the ragged
  descriptors against ``repro.core.planner`` / ``repro.core.dcomm`` field by
  field; each owner table (stage 1, stage 2, ragged) against the counting
  build.
- EP = 1 in-process: ``dedup`` and ``fused_hier`` against the JAX engines
  under ``jax.vmap(..., axis_name="model")``, outputs and gradients (router
  included); ``ragged`` against the port's ``fused_flat`` (bit for bit: the
  same FFN rows and the same sums) and the dense oracle, with capacity
  drops.
- EP = 4: four gloo ranks in one spawned group against ``shard_map`` on 4
  forced host devices in one subprocess (``conftest.run_devices``; JAX
  cannot vmap ``axis_index_groups``), run at the same time, rank by rank:
  ``fused_hier`` at node size 2 and 4, balancer off and on with a fixed
  ``algorithm1_groups`` assignment, ``dedup``, and on a 2 pod x 2 lane mesh
  ``fused_flat``, ``fused_pipe`` (S 2) and ``fused_hier``; the gradients of
  ``fused_hier`` (node size 2) and ``dedup``; ``ragged`` against the port's
  ``fused_flat``, outputs and gradients, with drops, and ``_a2a_vec``
  against JAX's.

float32, inputs from numpy seeds; tolerance 1e-5 (sums in another order),
gradients 1e-5 of each result's largest magnitude.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from conftest import run_devices
from xla_prelude import PRELUDE
from repro.core import balancer as jbalancer
from repro.core import dcomm as jdcomm
from repro.core import fusco as jfusco
from repro.core import planner as jplanner
from repro.core.dcomm import DcommConfig as JDcommConfig
from repro.core.routing import ExpertPlacement as JPlacement
from repro_torch.core import balancer, dcomm, fusco, planner
from repro_torch.core.dcomm import DcommConfig
from repro_torch.core.routing import ExpertPlacement
from repro_torch.kernels import ref

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

E, K, D, F, CF = 8, 2, 16, 24, 8.0
TOL = 1e-5
EP, T_LANE = 4, 32
NAMES = ("x", "wr", "w1", "w3", "w2")
LOADS = np.array([[1.0, 5.0], [3.0, 2.0]], np.float32)   # (nodes, lanes) at EP 4
# the EP = 4 cases: name -> (engine, node_size, pods, DcommConfig options,
# balancer assignment from LOADS)
CASES = {
    "hier_ns2": ("fused_hier", 2, 1, dict(use_balancer=False), False),
    "hier_ns2_balanced": ("fused_hier", 2, 1, {}, True),
    "hier_ns4": ("fused_hier", 4, 1, dict(use_balancer=False), False),
    "dedup": ("fused_flat", 2, 1, dict(dedup=True), False),
    "pods_flat": ("fused_flat", 2, 2, {}, False),
    "pods_pipe": ("fused_pipe", 2, 2, dict(pipe_slices=2), False),
    "pods_hier": ("fused_hier", 2, 2, dict(use_balancer=False), False),
}
GRAD_CASES = ("hier_ns2", "dedup")


def _weights(seed, t_total):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(wr=rng.standard_normal((D, E)).astype(f32) * 0.5,
                w1=rng.standard_normal((E, D, F)).astype(f32) * 0.1,
                w3=rng.standard_normal((E, D, F)).astype(f32) * 0.1,
                w2=rng.standard_normal((E, F, D)).astype(f32) * 0.1,
                x=rng.standard_normal((t_total, D)).astype(f32),
                cot=rng.standard_normal((t_total, D)).astype(f32))


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close(got, want, what, scale=False):
    want = np.asarray(want)
    atol = TOL * max(1.0, float(np.abs(want).max())) if scale else TOL
    np.testing.assert_allclose(np.asarray(got), want, rtol=TOL, atol=atol,
                               err_msg=what)


# ---------------------------------------------------------------- balancer

@pytest.mark.parametrize("n,m,seed", [(2, 2, 0), (3, 4, 1), (4, 3, 2), (1, 5, 3)])
def test_balancer_matches_jax_and_brute_force(n, m, seed):
    rng = np.random.default_rng(seed)
    loads = rng.integers(0, 50, (n, m)).astype(np.float32)
    loads[0, 0] = loads[0, 1]                     # a tie: the sort is stable
    got = balancer.algorithm1_groups(torch.from_numpy(loads))
    want = np.asarray(jbalancer.algorithm1_groups(jnp.asarray(loads)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for row in got.numpy():
        assert sorted(row) == list(range(m))
    lt = torch.from_numpy(loads)
    np.testing.assert_allclose(balancer.group_loads(lt, got).numpy(),
                               np.asarray(jbalancer.group_loads(
                                   jnp.asarray(loads), jnp.asarray(want))))
    static = balancer.static_assignment(n, m)
    np.testing.assert_array_equal(static.numpy(), np.asarray(
        jbalancer.static_assignment(n, m)))
    for a in (got, static):
        for node in range(n):
            for lane in range(m):
                np.testing.assert_array_equal(
                    balancer.forwarder_lane(a, node, lane,
                                            torch.arange(n)).numpy(),
                    np.asarray(jbalancer.forwarder_lane(
                        jnp.asarray(a.numpy()), node, lane, jnp.arange(n))))
    best, best_load = balancer.brute_force_assignment(loads)
    want_best, want_load = jbalancer.brute_force_assignment(loads)
    assert (best_load, best.tolist()) == (want_load, want_best.tolist())
    assert best_load <= float(balancer.max_group_load(lt, got))


# ------------------------------------------------------------------- plans

def _routing(seed, t, ep_k=K):
    rng = np.random.default_rng(seed)
    A = np.stack([rng.choice(E, ep_k, replace=False) for _ in range(t)]).astype(np.int32)
    gates = rng.uniform(size=(t, ep_k)).astype(np.float32)
    return A, gates


def _fields(got, want, names):
    for name in names:
        g, w = getattr(got, name), getattr(want, name)
        if hasattr(g, "slot"):
            np.testing.assert_array_equal(g.slot.numpy(), np.asarray(w.slot),
                                          err_msg=f"{name}.slot")
            np.testing.assert_array_equal(g.counts.numpy(), np.asarray(w.counts),
                                          err_msg=f"{name}.counts")
            assert (g.capacity, g.num_groups) == (w.capacity, w.num_groups)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)


def _owner_lists(table, src, rows):
    """The owner table's rows, sorted, are the counting build's lists of
    ``src`` over ``rows`` outputs (-1 entries skipped)."""
    offsets, lists = ref.build_owners_ref(src.reshape(-1), rows)
    for i in range(rows):
        assert lists[offsets[i]:offsets[i + 1]].tolist() == sorted(
            x for x in table[i].tolist() if x >= 0), i


@pytest.mark.parametrize("ep,ns,cap1,balanced", [(4, 2, 8, False), (4, 2, 4, True),
                                                  (8, 4, 6, True), (4, 4, 3, False),
                                                  (1, 1, 16, False)])
def test_hier_and_stage2_plans_match_jax(ep, ns, cap1, balanced):
    t = 20
    A, gates = _routing(7, t)
    placement = ExpertPlacement(E, ep, ns)
    jplace = JPlacement(n_experts=E, ep=ep, node_size=ns)
    loads = np.random.default_rng(8).uniform(size=(ep // ns, ns)).astype(np.float32)
    assign = (balancer.algorithm1_groups(torch.from_numpy(loads))
              if balanced else None)
    jassign = None if assign is None else jnp.asarray(assign.numpy())
    jbuild = jax.jit(lambda lane: jplanner.build_hier_plan(
        jnp.asarray(A), jnp.asarray(gates), jplace, cap1, lane, jassign))
    for lane in range(ep):
        got = planner.build_hier_plan(torch.from_numpy(A), torch.from_numpy(gates),
                                      placement, cap1, lane, assign)
        want = jbuild(jnp.int32(lane))
        _fields(got, want, ("slots", "src_of_slot", "meta_expert", "meta_gate",
                            "dst_rank_load", "dropped"))
        _owner_lists(got.slots.slot, got.src_of_slot, t)
    # stage 2 on the last lane's landed metadata (as if it were the forwarder)
    c2 = 5
    s2 = planner.build_stage2_plan(got.meta_expert, got.meta_gate, ns,
                                   E // ep, c2)
    w2 = jplanner.build_stage2_plan(want.meta_expert, want.meta_gate, ns,
                                    E // ep, c2)
    _fields(s2, w2, ("slots", "src_of_slot", "gate_of_slot"))
    _owner_lists(s2.slots.slot, s2.src_of_slot, got.meta_expert.shape[0])


@pytest.mark.parametrize("ep,cap", [(1, 24), (4, 6), (8, 3)])
def test_condensed_plan_matches_jax(ep, cap):
    t = 20
    A, gates = _routing(9, t, 3)
    placement = ExpertPlacement(E, ep, max(1, ep // 2))
    got = planner.build_condensed_plan(torch.from_numpy(A),
                                       torch.from_numpy(gates), placement, cap)
    want = jplanner.build_condensed_plan(
        jnp.asarray(A), jnp.asarray(gates),
        JPlacement(n_experts=E, ep=ep, node_size=max(1, ep // 2)), cap)
    _fields(got, want, ("slots", "src_of_slot", "meta_expert", "meta_gate",
                        "dropped"))
    _owner_lists(got.slots.slot, got.src_of_slot, t)


@pytest.mark.parametrize("ep,cap", [(1, 8), (4, 3), (2, 2)])
def test_ragged_descriptors_match_jax(ep, cap):
    t = 20
    A, gates = _routing(10, t)
    node = max(1, ep // 2)
    plan = planner.build_flat_plan(torch.from_numpy(A), torch.from_numpy(gates),
                                   ExpertPlacement(E, ep, node), cap)
    jplace = JPlacement(n_experts=E, ep=ep, node_size=node)
    jplan = jplanner.build_flat_plan(jnp.asarray(A), jnp.asarray(gates), jplace,
                                     cap)
    got = dcomm.build_ragged_descriptors(plan, ExpertPlacement(E, ep, node), cap)
    want = jdcomm.build_ragged_descriptors(jplan, jplace, cap)
    _fields(got, want, got._fields)
    rng = np.random.default_rng(11)
    quad = [rng.integers(0, 9, ep).astype(np.int32) for _ in range(5)]
    for g, w in zip(dcomm.ragged_reverse_descriptors(*map(torch.from_numpy, quad)),
                    jdcomm.ragged_reverse_descriptors(*map(jnp.asarray, quad))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the combine's owner table: the compact row of each assignment
    owners = dcomm.ragged_owner_table(plan)
    _owner_lists(owners, got.compact_src, t)
    live = plan.slots.slot >= 0
    assert torch.equal(owners >= 0, live)


# ------------------------------------------------------------------ EP = 1

def _cfgs(engine, ep, ns, pods=1, cf=CF, **kw):
    axis = ("pod", "model") if pods > 1 else "model"
    return (DcommConfig(engine=engine, ep_axis=axis, node_size=ns,
                        capacity_factor=cf, **kw),
            JDcommConfig(engine=engine, ep_axis=axis, node_size=ns,
                         capacity_factor=cf, **kw))


def _jax_ep1(p, jcfg, grads=False, assignment=None):
    jp = JPlacement(n_experts=E, ep=1, node_size=1)

    def y(*a):
        return jax.vmap(lambda *b: jfusco.moe_shuffle_ffn(
            *b, jp, jcfg, K, assignment), in_axes=(0, None, 0, 0, 0),
            axis_name="model")(a[0][None], a[1], a[2][None], a[3][None],
                               a[4][None])[0]

    args = [jnp.asarray(p[n]) for n in NAMES]
    if not grads:
        return np.asarray(jax.jit(y)(*args))
    return jax.jit(jax.grad(lambda *a: jnp.sum(y(*a) * jnp.asarray(p["cot"])),
                            argnums=tuple(range(5))))(*args)


@pytest.mark.parametrize("engine,kw,cf", [("fused_hier", {}, CF),
                                          ("fused_hier", {}, 0.5),
                                          ("fused_flat", dict(dedup=True), CF),
                                          ("fused_flat", dict(dedup=True), 0.5)])
def test_engine_ep1_matches_jax_outputs_and_grads(engine, kw, cf):
    """Gradients of ``sum(out * cot)`` for x, the router (through the
    piggybacked gates) and w1/w3/w2; factor 0.5 drops rows."""
    p = _weights(0, 32)
    cfg, jcfg = _cfgs(engine, 1, 1, cf=cf, **kw)
    ts = [_t(p[n], grad=True) for n in NAMES]
    y = fusco.moe_shuffle_ffn(*ts, ExpertPlacement(E, 1, 1), cfg, K)
    _close(y.detach(), _jax_ep1(p, jcfg), f"{engine} {kw} out")
    if cf == CF:
        dense = fusco.dense_moe_reference(*(_t(p[n]) for n in NAMES), K)
        _close(y.detach(), dense.numpy(), "dense")
    (y * _t(p["cot"])).sum().backward()
    for n, t, w in zip(NAMES, ts, _jax_ep1(p, jcfg, grads=True)):
        _close(t.grad, w, f"{engine} {kw} d{n}", scale=True)


@pytest.mark.parametrize("cf", [CF, 0.5])
def test_ragged_ep1_is_fused_flat_and_the_dense_oracle(cf):
    """The repaired ragged engine computes fused_flat's function: at one
    lane the same FFN rows and the same sums, so the same bits, and the
    same gradients; without drops the dense oracle's output."""
    p = _weights(1, 32)
    outs, grads = {}, {}
    for engine in ("ragged", "fused_flat"):
        ts = [_t(p[n], grad=True) for n in NAMES]
        y = fusco.moe_shuffle_ffn(*ts, ExpertPlacement(E, 1, 1),
                                  DcommConfig(engine=engine, capacity_factor=cf), K)
        (y * _t(p["cot"])).sum().backward()
        outs[engine], grads[engine] = y.detach(), [t.grad for t in ts]
    assert torch.equal(outs["ragged"], outs["fused_flat"])
    for n, g, w in zip(NAMES, grads["ragged"], grads["fused_flat"]):
        _close(g, w.numpy(), f"ragged d{n}", scale=True)
    if cf == CF:
        dense = fusco.dense_moe_reference(*(_t(p[n]) for n in NAMES), K)
        _close(outs["ragged"], dense.numpy(), "dense")


def test_defaults_are_the_references():
    from repro_torch.launch import serve, train
    assert DcommConfig().engine == JDcommConfig().engine == "fused_hier"
    assert (DcommConfig().node_size, DcommConfig().use_balancer) == (
        JDcommConfig().node_size, JDcommConfig().use_balancer)
    assert serve.parse_args([]).engine == train.parse_args([]).engine == "fused_hier"
    assert train.parse_args(["--dedup"]).dedup and not train.parse_args([]).dedup
    for engine in ("fused_flat", "fused_pipe", "fused_hier", "disagg", "ragged"):
        assert serve.parse_args(["--engine", engine]).engine == engine
    assert fusco._ENGINES == ("fused_flat", "fused_pipe", "fused_hier",
                              "disagg", "ragged")


@pytest.mark.parametrize("flags", [["--engine", "fused_hier"],
                                   ["--engine", "fused_flat", "--dedup"],
                                   ["--engine", "ragged"]])
def test_reduced_train_run_follows_fused_flat(flags):
    """``launch/train.run`` of the reduced qwen3-moe on the CPU through the
    engine takes fused_flat's losses: bf16, the engines round their partial
    sums in other places (hier and dedup gate at the expert), so to 2e-3
    relative, a quarter of bf16's epsilon (ragged: the same bits)."""
    from repro_torch.launch import train
    argv = ["--reduced", "--steps", "3", "--seq", "16", "--batch", "2"]
    out = train.run(train.parse_args(argv + flags), device="cpu")
    flat = train.run(train.parse_args(argv + ["--engine", "fused_flat"]),
                     device="cpu")
    assert np.isfinite(out["losses"]).all()
    np.testing.assert_allclose(out["losses"], flat["losses"], rtol=2e-3)


# ------------------------------------------------------------------ EP = 4

JAX_CODE = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.core import fusco, balancer
from repro.core.dcomm import DcommConfig, _a2a_vec
from repro.core.routing import ExpertPlacement
d = dict(np.load({data!r}))
E, K, EP = {e}, {k}, {ep}
cases, grad_cases = {cases!r}, {grad_cases!r}
out = {{}}
args = [jnp.asarray(d[n]) for n in ("x", "wr", "w1", "w3", "w2")]
for name, (engine, ns, pods, kw, balanced) in cases.items():
    axes = ("pod", "model") if pods > 1 else ("model",)
    mesh = make_mesh((pods, EP // pods) if pods > 1 else (EP,), axes)
    spec = P(axes)
    placement = ExpertPlacement(n_experts=E, ep=EP, node_size=ns)
    cfg = DcommConfig(engine=engine, ep_axis=axes if pods > 1 else "model",
                      node_size=ns, capacity_factor={cf}, **kw)
    assignment = (balancer.algorithm1_groups(jnp.asarray(d["loads"]))
                  if balanced else None)
    moe = shard_map(lambda x, wr, a, b, c: fusco.moe_shuffle_ffn(
                        x, wr, a, b, c, placement, cfg, K, assignment),
                    mesh=mesh, in_specs=(spec, P(), spec, spec, spec),
                    out_specs=spec, check_vma=False)
    out[name] = np.asarray(jax.jit(moe)(*args))
    if name in grad_cases:
        g = jax.jit(jax.grad(lambda *a: jnp.sum(moe(*a) * d["cot"]),
                             argnums=(0, 1, 2, 3, 4)))(*args)
        for n, v in zip(("x", "wr", "w1", "w3", "w2"), g):
            out[name + "_d" + n] = np.asarray(v)
mesh = make_mesh((EP,), ("model",))
vec = shard_map(lambda v: _a2a_vec(v[0], EP, "model")[None], mesh=mesh,
                in_specs=P("model"), out_specs=P("model"), check_vma=False)
out["a2a_vec"] = np.asarray(jax.jit(vec)(jnp.asarray(d["vec"])))
np.savez({out!r}, **out)
print("JAX_OK")
"""


def _rank_main(rank, world, init_file, data, out_dir):
    """One EP rank: every case of CASES on its token shard and its lane's
    experts, the gradients of GRAD_CASES, ragged and fused_flat (outputs
    and gradients, with and without drops), and ``_a2a_vec``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        d = dict(np.load(data))
        el = E // world
        tl = d["x"].shape[0] // world
        world_group = dist.group.WORLD
        # every group, built on every rank in the same order
        groups = {(2, 1): dcomm.ep_groups(world_group, 2),
                  (4, 1): dcomm.ep_groups(world_group, 4),
                  (2, 2): dcomm.ep_groups(world_group, 2, n_pods=2)}
        assignment = balancer.algorithm1_groups(torch.from_numpy(d["loads"]))
        mine = lambda n: (d[n][rank * tl:(rank + 1) * tl] if n in ("x", "cot")
                          else d[n] if n == "wr"
                          else d[n][rank * el:(rank + 1) * el])
        out = {}

        def run(name, cfg, placement, group, assign=None, grads=False):
            ts = [_t(mine(n), grad=grads) for n in NAMES]
            y = fusco.moe_shuffle_ffn(*ts, placement, cfg, K, assign,
                                      group=group)
            out[name] = y.detach().numpy()
            if grads:
                gs = torch.autograd.grad((y * _t(mine("cot"))).sum(), ts)
                out.update({f"{name}_d{n}": g.numpy() for n, g in zip(NAMES, gs)})

        for name, (engine, ns, pods, kw, balanced) in CASES.items():
            cfg = _cfgs(engine, world, ns, pods, **kw)[0]
            run(name, cfg, ExpertPlacement(E, world, ns), groups[(ns, pods)],
                assignment if balanced else None, name in GRAD_CASES)
        for cf in (CF, 0.5):
            for engine in ("ragged", "fused_flat"):
                run(f"{engine}_cf{cf}", DcommConfig(engine=engine,
                                                    capacity_factor=cf),
                    ExpertPlacement(E, world, 2), world_group, grads=True)
        out["a2a_vec"] = dcomm._a2a_vec(torch.from_numpy(d["vec"][rank]), world,
                                        world_group).numpy()
        # smaller nodes and a (pod, model) axis without their groups raise
        raised = []
        for name in ("hier_ns2", "pods_flat"):
            engine, ns, pods, kw, _ = CASES[name]
            with pytest.raises(ValueError, match="ep_groups") as e:
                run(name, _cfgs(engine, world, ns, pods, **kw)[0],
                    ExpertPlacement(E, world, ns), world_group)
            raised.append(e is not None)
        out["raised"] = np.array(raised)
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def test_engines_ep4_match_jax_rank_by_rank(tmp_path):
    p = _weights(2, EP * T_LANE)
    vec = np.arange(EP * EP, dtype=np.int32).reshape(EP, EP) * 3 + 1
    data = tmp_path / "data.npz"
    np.savez(data, loads=LOADS, vec=vec, **p)
    code = PRELUDE + JAX_CODE.format(
        data=str(data), e=E, k=K, ep=EP, cf=CF, cases=CASES,
        grad_cases=GRAD_CASES, out=str(tmp_path / "jax.npz"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(run_devices, code, EP, 300)
        mp.spawn(_rank_main, args=(EP, str(tmp_path / "rendezvous"), str(data),
                                   str(tmp_path)), nprocs=EP, join=True)
        assert "JAX_OK" in jax_run.result()
    want = np.load(tmp_path / "jax.npz")
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(EP)]
    rows = lambda a, r: a[r * T_LANE:(r + 1) * T_LANE]
    lanes = lambda a, r: a[r * (E // EP):(r + 1) * (E // EP)]
    for name in CASES:
        for r in range(EP):
            _close(got[r][name], rows(want[name], r), f"{name} rank {r}")
    for name in GRAD_CASES:
        for n in NAMES:
            key = f"{name}_d{n}"
            for r in range(EP):
                # the router is replicated: JAX sums its gradient over the
                # lanes, each rank holds its own loss's share
                w = (want[key] if n == "wr" else
                     rows(want[key], r) if n == "x" else lanes(want[key], r))
                g = (sum(got[q][key] for q in range(EP)) if n == "wr"
                     else got[r][key])
                _close(g, w, f"{key} rank {r}", scale=True)
    dense = fusco.dense_moe_reference(*(_t(p[n]) for n in NAMES), K).numpy()
    for r in range(EP):
        _close(got[r][f"ragged_cf{CF}"], rows(dense, r), f"ragged dense rank {r}")
        for cf in (CF, 0.5):
            for key in ("", "_dx", "_dwr", "_dw1", "_dw3", "_dw2"):
                _close(got[r][f"ragged_cf{cf}{key}"],
                       got[r][f"fused_flat_cf{cf}{key}"],
                       f"ragged vs fused_flat cf {cf}{key} rank {r}", scale=True)
        np.testing.assert_array_equal(got[r]["a2a_vec"], want["a2a_vec"][r])
        assert got[r]["raised"].all()
    # drops happened at factor 0.5: the output is another one
    assert np.abs(got[0]["ragged_cf0.5"] - got[0][f"ragged_cf{CF}"]).max() > 1e-3
