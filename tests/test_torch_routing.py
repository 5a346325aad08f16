"""Routing, descriptors and the flat plan of the port against the JAX
package on the same numpy inputs.  Integer outputs must agree exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dcomm as jdcomm
from repro.core import descriptors as jdesc
from repro.core import planner as jplanner
from repro.core import routing as jrouting
from repro_torch.core import dcomm, descriptors, planner, routing


def _logits(t, e, seed):
    """Tie-free logits: a random permutation of well-separated values per
    row, so jax.lax.top_k and torch.topk cannot order ties differently."""
    rng = np.random.default_rng(seed)
    base = np.linspace(-3.0, 3.0, e, dtype=np.float32)
    return np.stack([rng.permutation(base) for _ in range(t)])


@pytest.mark.parametrize("t,e,k,normalize", [(16, 8, 2, True),
                                             (33, 128, 8, True),
                                             (7, 8, 3, False)])
def test_top_k_routing_matches_jax(t, e, k, normalize):
    lg = _logits(t, e, seed=t)
    A_j, g_j = jrouting.top_k_routing(jnp.asarray(lg), k, normalize)
    A_t, g_t = routing.top_k_routing(torch.from_numpy(lg), k, normalize)
    assert A_t.dtype == torch.int32 and g_t.dtype == torch.float32
    np.testing.assert_array_equal(A_t.numpy(), np.asarray(A_j))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-6)


def test_router_logits_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((12, 16)).astype(np.float32)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    np.testing.assert_allclose(
        routing.router_logits(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jrouting.router_logits(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_experts,ep,node_size", [(8, 4, 2), (8, 1, 1),
                                                    (4, 8, 4)])
def test_placement_maps_match_jax(n_experts, ep, node_size):
    rng = np.random.default_rng(ep)
    A = rng.integers(0, n_experts, (20, 2)).astype(np.int32)
    pj = jrouting.ExpertPlacement(n_experts, ep, node_size)
    pt = routing.ExpertPlacement(n_experts, ep, node_size)
    rep_j = jrouting.balanced_replica_choice(jnp.asarray(A), pj)
    rep_t = routing.balanced_replica_choice(torch.from_numpy(A), pt)
    np.testing.assert_array_equal(rep_t.numpy(), np.asarray(rep_j))
    np.testing.assert_array_equal(
        pt.lane_of_expert(torch.from_numpy(A), rep_t).numpy(),
        np.asarray(pj.lane_of_expert(jnp.asarray(A), rep_j)))
    np.testing.assert_array_equal(
        pt.local_expert_index(torch.from_numpy(A), rep_t).numpy(),
        np.asarray(pj.local_expert_index(jnp.asarray(A), rep_j)))
    np.testing.assert_array_equal(
        routing.token_node_matrix(torch.from_numpy(A), pt, rep_t).numpy(),
        np.asarray(jrouting.token_node_matrix(jnp.asarray(A), pj, rep_j)))
    assert (pt.n_nodes, pt.experts_per_lane, pt.replicas) == (
        pj.n_nodes, pj.experts_per_lane, pj.replicas)


def test_placement_rejects_what_jax_rejects():
    for args in [(8, 3, 1), (6, 4, 2), (8, 4, 3)]:
        with pytest.raises(ValueError):
            jrouting.ExpertPlacement(*args)
        with pytest.raises(ValueError):
            routing.ExpertPlacement(*args)


@pytest.mark.parametrize("n,groups,capacity,seed", [(40, 5, 4, 0),
                                                    (64, 8, 16, 1),
                                                    (1, 3, 2, 2)])
def test_slot_table_matches_jax(n, groups, capacity, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-1, groups, (n // 2 or 1, 2)).astype(np.int32)
    valid = rng.uniform(size=keys.shape) > 0.1
    st_j = jdesc.build_slot_table(jnp.asarray(keys), groups, capacity,
                                  jnp.asarray(valid))
    st_t = descriptors.build_slot_table(torch.from_numpy(keys), groups,
                                        capacity, torch.from_numpy(valid))
    np.testing.assert_array_equal(st_t.slot.numpy(), np.asarray(st_j.slot))
    np.testing.assert_array_equal(st_t.counts.numpy(), np.asarray(st_j.counts))
    assert int(st_t.dropped()) == int(st_j.dropped())
    np.testing.assert_array_equal(
        descriptors.positions_within_groups(torch.from_numpy(keys.ravel())).numpy(),
        np.asarray(jdesc.positions_within_groups(jnp.asarray(keys.ravel()))))


@pytest.mark.parametrize("t,e,k,ep,cap", [(24, 8, 2, 4, 8),    # fits
                                          (24, 8, 2, 4, 2),    # overflows
                                          (32, 8, 2, 1, 8),
                                          (16, 4, 2, 8, 8)])   # replicated
def test_flat_plan_matches_jax(t, e, k, ep, cap):
    lg = _logits(t, e, seed=ep + cap)
    A_j, g_j = jrouting.top_k_routing(jnp.asarray(lg), k)
    A = np.array(A_j)
    gates = np.array(g_j)
    pj = jrouting.ExpertPlacement(e, ep, 1)
    pt = routing.ExpertPlacement(e, ep, 1)
    plan_j = jplanner.build_flat_plan(jnp.asarray(A), jnp.asarray(gates), pj, cap)
    plan_t = planner.build_flat_plan(torch.from_numpy(A),
                                     torch.from_numpy(gates), pt, cap)
    np.testing.assert_array_equal(plan_t.slots.slot.numpy(),
                                  np.asarray(plan_j.slots.slot))
    np.testing.assert_array_equal(plan_t.src_of_slot.numpy(),
                                  np.asarray(plan_j.src_of_slot))
    np.testing.assert_array_equal(plan_t.gate_of_slot.numpy(),
                                  np.asarray(plan_j.gate_of_slot))
    np.testing.assert_array_equal(plan_t.lane.numpy(), np.asarray(plan_j.lane))
    assert int(plan_t.dropped) == int(plan_j.dropped)
    if cap == 2:
        assert int(plan_t.dropped) > 0


def test_cap_matches_jax_over_a_sweep():
    for n in [0.0, 0.5, 1.0, 3.0, 4.0, 7.9, 32.0, 33.3, 64.0, 100.25, 511.0]:
        for factor in [1.0, 1.25, 2.0, 8.0]:
            for align in [1, 8, 16]:
                assert dcomm._cap(n, factor, align) == jdcomm._cap(n, factor, align)
    assert dcomm._cap(512 * 8 / 128, 2.0) == 64       # the serving main path
