"""The port's fused_flat MoE shuffle against the JAX package.

EP = 1 runs in-process.  EP = 4 runs four gloo ranks (spawned with
torch.multiprocessing, each holding one token shard and its lane's experts)
and compares them rank by rank with the JAX shuffle run under
``jax.vmap(..., axis_name="model")`` in this process, as
``tests/test_dcomm_invariance.py`` emulates the EP axis.  float32, tolerance
1e-5 (sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.core import fusco as jfusco
from repro.core import planner as jplanner
from repro.core.dcomm import DcommConfig as JDcommConfig
from repro.core.routing import ExpertPlacement as JPlacement
from repro_torch.core import fusco, planner
from repro_torch.core.dcomm import DcommConfig, _cap, _flat_exchange
from repro_torch.core.routing import ExpertPlacement
from repro_torch.kernels import ref
from repro_torch.layers.moe import moe_decode_block

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

E, K, D, F, CF = 8, 2, 16, 24, 8.0
TOL = 1e-5


def _weights(seed, t_total):
    """Router, canonical experts (E, d, f)/(E, f, d) and tokens, from numpy."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.standard_normal((D, E)).astype(f32) * 0.5,
            rng.standard_normal((E, D, F)).astype(f32) * 0.1,
            rng.standard_normal((E, D, F)).astype(f32) * 0.1,
            rng.standard_normal((E, F, D)).astype(f32) * 0.1,
            rng.standard_normal((t_total, D)).astype(f32))


def _jax_shuffle(ep, wr, w1, w3, w2, x, cf=CF):
    """JAX fused_flat on ``ep`` emulated lanes: x (ep, T, d) -> (ep, T, d)."""
    placement = JPlacement(n_experts=E, ep=ep, node_size=max(1, ep // 2))
    cfg = JDcommConfig(engine="fused_flat", ep_axis="model",
                       node_size=placement.node_size, capacity_factor=cf)
    lane = lambda w: jnp.asarray(w).reshape(ep, E // ep, *w.shape[1:])

    def fn(xl, a, b, c):
        return jfusco.moe_shuffle_ffn(xl, jnp.asarray(wr), a, b, c, placement,
                                      cfg, K)

    return np.asarray(jax.jit(jax.vmap(fn, axis_name="model"))(
        jnp.asarray(x), lane(w1), lane(w3), lane(w2)))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_moe_shuffle_ffn_ep1_matches_jax_and_dense():
    wr, w1, w3, w2, x = _weights(0, 24)
    placement = ExpertPlacement(n_experts=E, ep=1, node_size=1)
    cfg = DcommConfig(engine="fused_flat", capacity_factor=CF)
    y = fusco.moe_shuffle_ffn(_t(x), _t(wr), _t(w1), _t(w3), _t(w2),
                              placement, cfg, K).numpy()
    np.testing.assert_allclose(y, _jax_shuffle(1, wr, w1, w3, w2, x[None])[0],
                               rtol=TOL, atol=TOL)
    dense = fusco.dense_moe_reference(_t(x), _t(wr), _t(w1), _t(w3), _t(w2), K)
    np.testing.assert_allclose(y, dense.numpy(), rtol=TOL, atol=TOL)
    jdense = jfusco.dense_moe_reference(*map(jnp.asarray, (x, wr, w1, w3, w2)), K)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense), rtol=TOL,
                               atol=TOL)


def test_capacity_overflow_drops_like_jax():
    """A small capacity factor drops assignments; both packages drop the
    same ones."""
    wr, w1, w3, w2, x = _weights(1, 32)
    placement = ExpertPlacement(n_experts=E, ep=1, node_size=1)
    cfg = DcommConfig(engine="fused_flat", capacity_factor=0.5)
    y = fusco.moe_shuffle_ffn(_t(x), _t(wr), _t(w1), _t(w3), _t(w2),
                              placement, cfg, K).numpy()
    np.testing.assert_allclose(
        y, _jax_shuffle(1, wr, w1, w3, w2, x[None], cf=0.5)[0],
        rtol=TOL, atol=TOL)
    dense = fusco.dense_moe_reference(_t(x), _t(wr), _t(w1), _t(w3), _t(w2), K)
    assert not np.allclose(y, dense.numpy(), atol=1e-3)   # something dropped


@pytest.mark.parametrize("t,ep,cf", [(24, 1, 8.0), (32, 1, 0.5), (12, 4, 2.0)])
def test_slot_table_is_the_owner_lists_of_the_combine(t, ep, cf):
    """The combine's owner lists, the flat plan's slot table (T, K), are the
    exact inverse of src_of_slot: every live buffer row sits in exactly one
    list, at its (t, k), and dropped assignments are -1 -- on the port's
    plan and on the JAX ``build_flat_plan`` from the same routing, which
    agree.  The counting build's lists (``ref.build_owners_ref``, the plain
    version of the card's) are the table's rows in ascending order."""
    rng = np.random.default_rng(5)
    A = np.stack([rng.choice(E, K, replace=False) for _ in range(t)]).astype(np.int32)
    gates = rng.uniform(size=(t, K)).astype(np.float32)
    node = max(1, ep // 2)
    cap = _cap(t * K / E, cf)
    plan = planner.build_flat_plan(torch.from_numpy(A), torch.from_numpy(gates),
                                   ExpertPlacement(E, ep, node), cap)
    jplan = jplanner.build_flat_plan(jnp.asarray(A), jnp.asarray(gates),
                                     JPlacement(n_experts=E, ep=ep,
                                                node_size=node), cap)
    slot, src = plan.slots.slot.numpy(), plan.src_of_slot.numpy()
    np.testing.assert_array_equal(slot, np.asarray(jplan.slots.slot))
    np.testing.assert_array_equal(src, np.asarray(jplan.src_of_slot))
    tok, _ = np.nonzero(slot >= 0)
    rows = slot[slot >= 0]
    assert sorted(rows) == list(np.flatnonzero(src >= 0))   # each exactly once
    assert (src[rows] == tok).all()                          # at its token
    assert (int(plan.dropped) > 0) == (cf < 1)               # drops are -1
    offsets, owners = ref.build_owners_ref(plan.src_of_slot, t)
    for i in range(t):
        assert owners[offsets[i]:offsets[i + 1]].tolist() == sorted(
            x for x in slot[i] if x >= 0)


def _rank_main(rank, world, init_file, data, out_dir):
    """One EP rank: the fused_flat shuffle on its shard, and the decode MoE
    on all tokens (replicated), over a gloo group of ``world`` ranks."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        d = np.load(data)
        placement = ExpertPlacement(n_experts=E, ep=world,
                                    node_size=max(1, world // 2))
        cfg = DcommConfig(engine="fused_flat", capacity_factor=CF)
        el = E // world
        lane = lambda w: torch.from_numpy(w.reshape(world, el, *w.shape[1:]))
        w1, w3, w2 = lane(d["w1"]), lane(d["w3"]), lane(d["w2"])
        group = dist.group.WORLD
        y = fusco.moe_shuffle_ffn(torch.from_numpy(d["x"][rank]),
                                  torch.from_numpy(d["wr"]), w1[rank],
                                  w3[rank], w2[rank], placement, cfg, K,
                                  group=group)
        np.save(f"{out_dir}/shuffle{rank}.npy", y.numpy())
        yd = moe_decode_block(torch.from_numpy(d["x"].reshape(1, -1, D)),
                              {"router": torch.from_numpy(d["wr"]),
                               "w1": w1[rank:rank + 1], "w3": w3[rank:rank + 1],
                               "w2": w2[rank:rank + 1]},
                              placement=placement, dcfg=cfg, top_k=K,
                              group=group)
        np.save(f"{out_dir}/decode{rank}.npy", yd.numpy())
    finally:
        dist.destroy_process_group()


def test_moe_shuffle_ffn_ep4_gloo_matches_jax_rank_by_rank(tmp_path):
    ep, t = 4, 12
    wr, w1, w3, w2, x = _weights(2, ep * t)
    x = x.reshape(ep, t, D)
    np.savez(tmp_path / "data.npz", wr=wr, w1=w1, w3=w3, w2=w2, x=x)
    mp.spawn(_rank_main, args=(ep, str(tmp_path / "rendezvous"),
                               str(tmp_path / "data.npz"), str(tmp_path)),
             nprocs=ep, join=True)
    expect = _jax_shuffle(ep, wr, w1, w3, w2, x)
    for r in range(ep):
        np.testing.assert_allclose(np.load(tmp_path / f"shuffle{r}.npy"),
                                   expect[r], rtol=TOL, atol=TOL,
                                   err_msg=f"rank {r}")
    dense = fusco.dense_moe_reference(_t(x.reshape(-1, D)), _t(wr), _t(w1),
                                      _t(w3), _t(w2), K).numpy()
    np.testing.assert_allclose(expect.reshape(-1, D), dense, rtol=TOL, atol=TOL)
    for r in range(ep):
        np.testing.assert_allclose(np.load(tmp_path / f"decode{r}.npy")[0],
                                   dense, rtol=TOL, atol=TOL,
                                   err_msg=f"decode rank {r}")


def test_engines_of_later_slices_raise():
    """The engines the first slices left for later dispatch now: fused_hier,
    ragged, fused_flat with dedup, and a (pod, model) axis, which at one
    lane is the identity.  An unknown engine still raises.  (Their missing
    groups over more than one lane raise on the gloo ranks of
    ``test_torch_hier.py``.)"""
    placement = ExpertPlacement(n_experts=E, ep=1, node_size=1)
    x = torch.zeros(4, D)
    A = torch.zeros(4, K, dtype=torch.int32)
    g = torch.full((4, K), 0.5)
    for cfg in (DcommConfig(engine="fused_hier"), DcommConfig(engine="ragged"),
                DcommConfig(engine="fused_flat", dedup=True)):
        assert fusco.dispatch(x, A, g, placement, cfg).expert_rows.shape[:2] == (1, E)
    with pytest.raises(ValueError, match="unknown engine"):
        fusco.dispatch(x, A, g, placement, DcommConfig(engine="sparse"))
    buf = torch.randn(1, 3, D)
    assert _flat_exchange(buf, DcommConfig(ep_axis=("pod", "model")), 1) is buf
    assert _flat_exchange(buf, DcommConfig(), 1) is buf
