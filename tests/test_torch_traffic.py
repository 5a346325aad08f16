"""The port's online traffic statistics against the JAX package:
``core/traffic.observe`` on its own, threaded through the moe prefill at
EP = 4 (``fused_hier`` with the traffic-fed Algorithm 1, four gloo ranks
against ``shard_map`` on four forced host devices) and through the moe_tx
stream at EP = 1 (per-layer barriers and the streamed schedule); the pad
mask; and the copied ``commplan`` and ``relayout`` views.

Counts are integers and must match exactly; EMAs within 1e-6 (float32, the
same sums); the model's logits within 1e-4 (float32 sums in another order
across two layers and the vocabulary projection).
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from conftest import run_devices
from xla_prelude import PRELUDE
from repro.compat import make_mesh
from repro.configs import get_arch as jget_arch
from repro.core import balancer as jbalancer
from repro.core import commplan as jcommplan
from repro.core import relayout as jrelayout
from repro.core import traffic as jtraffic
from repro.core.routing import ExpertPlacement as JPlacement
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core import balancer, commplan, dcomm, relayout, traffic
from repro_torch.core.routing import ExpertPlacement
from repro_torch.layers.moe import moe_block, stream_tx_layers
from repro_torch.models import lm

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

ARCH = "qwen3-moe-30b-a3b"
TX = "moe-tx-stream"
TOL_EMA = 1e-6
TOL = 1e-4
EP, NODE, B, S = 4, 2, 2, 16
COUNTS = ("last_expert_count", "steps")


def _check_state(got, want, what=""):
    """Every leaf of a port TrafficState against the reference's (numpy)."""
    for name in traffic.TrafficState._fields:
        g = np.asarray(getattr(got, name))
        w = np.asarray(getattr(want, name))
        assert g.shape == w.shape, (what, name)
        if name in COUNTS:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")
        else:
            np.testing.assert_allclose(g, w, rtol=TOL_EMA, atol=TOL_EMA,
                                       err_msg=f"{what} {name}")


def _port_state(st) -> traffic.TrafficState:
    return traffic.TrafficState(*(torch.from_numpy(np.array(x)) for x in st))


def _host(st) -> traffic.TrafficState:
    return traffic.TrafficState(*(x.cpu().numpy() for x in st))


@pytest.mark.parametrize("n_experts,ep,node", [(16, 1, 1), (16, 4, 1),
                                               (16, 4, 2), (16, 4, 4),
                                               (16, 8, 2), (4, 8, 4)])
def test_observe_matches_jax(n_experts, ep, node):
    """Three successive observations of seeded routings from a random lane
    with a random validity mask; (4, 8, 4) replicates each expert twice."""
    rng = np.random.default_rng(ep * 10 + node)
    t, k = 24, 3
    jp = JPlacement(n_experts=n_experts, ep=ep, node_size=node)
    tp = ExpertPlacement(n_experts=n_experts, ep=ep, node_size=node)
    want = jtraffic.init_traffic_state(n_experts, ep)
    got = traffic.init_traffic_state(n_experts, ep)
    for _ in range(3):
        A = np.stack([rng.choice(n_experts, k, replace=False) for _ in range(t)]
                     ).astype(np.int32)
        valid = rng.random(t) < 0.7
        lane = int(rng.integers(ep))
        want = jtraffic.observe(want, jnp.asarray(A), jp, lane,
                                valid=jnp.asarray(valid))
        got = traffic.observe(got, torch.from_numpy(A), tp, lane,
                              valid=torch.from_numpy(valid))
        _check_state(got, jax.tree.map(np.asarray, want))
    np.testing.assert_allclose(traffic.expert_loads(got).numpy(),
                               np.asarray(jtraffic.expert_loads(want)),
                               rtol=TOL_EMA)
    assert bool(traffic.has_stats(got))
    np.testing.assert_array_equal(
        traffic.balancer_loads(got, tp).numpy(),
        np.asarray(jtraffic.balancer_loads(want, jp)))


def test_cold_state_grouping_is_the_references():
    """Algorithm 1 on the all-zero state: the reference's table (stable ties,
    then the per-node rotation), which is not the static grouping."""
    for ep, node in ((4, 2), (8, 4), (8, 2)):
        tp = ExpertPlacement(n_experts=16, ep=ep, node_size=node)
        jp = JPlacement(n_experts=16, ep=ep, node_size=node)
        got = balancer.algorithm1_groups(
            traffic.balancer_loads(traffic.init_traffic_state(16, ep), tp))
        want = jbalancer.algorithm1_groups(
            jtraffic.balancer_loads(jtraffic.init_traffic_state(16, ep), jp))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert not torch.equal(got, balancer.static_assignment(ep // node,
                                                               node))


# ------------------------------------------------ moe prefill at EP = 4 ----

JAX_CODE = """
import dataclasses, numpy as np, jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.configs import get_arch
from repro.core import balancer, traffic
from repro.models import lm
d = np.load({data!r})
tree = {{}}
for key in d.files:
    if not key.startswith("p/"):
        continue
    node = tree
    *path, leaf = key[2:].split("/")
    for p in path:
        node = node.setdefault(p, {{}})
    node[leaf] = jnp.asarray(d[key])
cfg = get_arch({arch!r}).reduced()
mesh = make_mesh((1, {ep}), ("data", "model"))
ctx = dataclasses.replace(
    lm.make_context(cfg, mesh, multi_pod=False, engine="fused_hier",
                    node_size={node}), compute_dtype=jnp.float32)
tr = traffic.TrafficState(*(jnp.asarray(d["t/" + f])
                            for f in traffic.TrafficState._fields))
with mesh:
    logits, state, new = jax.jit(lambda p, t, tr, m: lm.prefill(
        p, t, jnp.arange(t.shape[1]), ctx, {max_len}, traffic=tr,
        traffic_mask=m))(tree, jnp.asarray(d["tokens"]), tr,
                         jnp.asarray(d["mask"]))
placement = ctx.placement
assign = np.stack([np.asarray(balancer.algorithm1_groups(
    traffic.balancer_loads(jax.tree.map(lambda x: x[i], new), placement)))
    for i in range(cfg.n_layers)])
np.savez({out!r}, logits=np.asarray(logits), assign=assign,
         **{{"t/" + f: np.asarray(getattr(new, f))
            for f in traffic.TrafficState._fields}})
print("JAX_OK")
"""


def _rank_main(rank, world, init_file, data, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        d = np.load(data)
        params = {}
        for key in d.files:
            if key.startswith("p/"):
                node = params
                *path, leaf = key[2:].split("/")
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = torch.from_numpy(d[key])
        tr = traffic.TrafficState(*(torch.from_numpy(d["t/" + f])
                                    for f in traffic.TrafficState._fields))
        ctx = lm.make_context(get_arch(ARCH).reduced(), "cpu",
                              ep_group=dist.group.WORLD, engine="fused_hier",
                              node_size=NODE, compute_dtype=torch.float32,
                              explicit_tp=False,     # serving: whole weights
                              split_vocab=False)
        seen, entry = [], dcomm.hier_dispatch

        def recording(x, A, gates, placement, cfg, assignment=None,
                      group=None):
            seen.append(assignment.clone())
            return entry(x, A, gates, placement, cfg, assignment, group)

        dcomm.hier_dispatch = recording
        tokens = torch.from_numpy(d["tokens"]).long()
        params = lm.shard_params(params, ctx)      # this rank's lane
        logits, _, new = lm.prefill(params, tokens, torch.arange(S), ctx, S + 1,
                                    traffic=tr,
                                    traffic_mask=torch.from_numpy(d["mask"]))
        np.savez(f"{out_dir}/rank{rank}.npz", logits=logits.numpy(),
                 assign=torch.stack(seen).numpy(),
                 **{"t/" + f: getattr(new, f).numpy()
                    for f in traffic.TrafficState._fields})
    finally:
        dist.destroy_process_group()


def test_moe_prefill_traffic_ep4_matches_shard_map(tmp_path):
    """The reduced qwen3-moe prefill through ``fused_hier`` (nodes of 2,
    the balancer on) with a warm random traffic state and left-padded rows:
    on every rank the logits, every traffic leaf, and the grouping each
    layer passes to ``hier_dispatch``, which must be the reference's
    ``algorithm1_groups(balancer_loads(tr))`` of the observed state."""
    cfg = get_arch(ARCH).reduced()
    ctx = dataclasses.replace(
        lm.make_context(cfg, "cpu", compute_dtype=torch.float32),
        placement=ExpertPlacement(cfg.moe.n_experts, EP, NODE))
    params = lm.init_params(cfg, ctx, torch.Generator().manual_seed(0),
                            dtype=torch.float32)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    mask = np.ones((B, S), bool)
    mask[0, :5] = False                      # row 0 left-padded by 5
    L, E = cfg.n_layers, cfg.moe.n_experts
    warm = traffic.TrafficState(
        rng.random((L, E), np.float32) * 8, rng.random((L, EP), np.float32) * 8,
        np.zeros((L, E), np.float32), np.full((L,), 3, np.int32),
        rng.random((L, EP, EP), np.float32), rng.random((L, EP), np.float32))

    def flat(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v.numpy()
    data = tmp_path / "data.npz"
    np.savez(data, tokens=tokens, mask=mask, **dict(flat(params, "p/")),
             **{"t/" + f: getattr(warm, f) for f in traffic.TrafficState._fields})
    code = PRELUDE + JAX_CODE.format(data=str(data), arch=ARCH, ep=EP,
                                     node=NODE, max_len=S + 1,
                                     out=str(tmp_path / "jax.npz"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(run_devices, code, EP, 300)
        mp.spawn(_rank_main, args=(EP, str(tmp_path / "rendezvous"), str(data),
                                   str(tmp_path)), nprocs=EP, join=True)
        assert "JAX_OK" in jax_run.result()
    want = np.load(tmp_path / "jax.npz")
    fields = traffic.TrafficState._fields
    want_tr = traffic.TrafficState(*(want["t/" + f] for f in fields))
    assert not all((a == balancer.static_assignment(EP // NODE, NODE).numpy()
                    ).all() for a in want["assign"])   # the balancer moved
    for r in range(EP):
        got = np.load(tmp_path / f"rank{r}.npz")
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=TOL,
                                   atol=TOL, err_msg=f"rank {r}")
        _check_state(traffic.TrafficState(*(got["t/" + f] for f in fields)),
                     want_tr, f"rank {r}")
        np.testing.assert_array_equal(got["assign"], want["assign"],
                                      err_msg=f"rank {r}")


# ------------------------------------------------ moe_tx stream at EP 1 ----

@pytest.mark.parametrize("engine,moe_stream", [("fused_flat", 0),
                                               ("fused_pipe", 2)])
def test_moe_tx_traffic_matches_jax(engine, moe_stream):
    """The reduced moe-tx-stream prefill with traffic through the per-layer
    barriers (fused_flat) and the streamed schedule (fused_pipe, both
    layers in one block): logits and every traffic leaf, from a cold
    state, with row 1 left-padded."""
    cfg_j = jget_arch(TX).reduced()
    mesh = make_mesh((1, 1), ("data", "model"))
    ctx_j = dataclasses.replace(
        jlm.make_context(cfg_j, mesh, multi_pod=False, engine=engine,
                         moe_stream=moe_stream), compute_dtype=jnp.float32)
    params_j = jlm.init_params(cfg_j, jax.random.PRNGKey(0), ctx_j,
                               dtype=jnp.float32)
    tokens = np.random.default_rng(1).integers(0, cfg_j.vocab, (2, 8)
                                               ).astype(np.int32)
    mask = np.ones((2, 8), bool)
    mask[1, :3] = False
    tr0 = jtraffic.init_traffic_state(cfg_j.moe.n_experts, 1,
                                      n_layers=cfg_j.n_layers)
    with mesh:
        logits_j, _, tr_j = jax.jit(lambda p, t, tr, m: jlm.prefill(
            p, t, jnp.arange(8), ctx_j, 9, traffic=tr, traffic_mask=m))(
            params_j, jnp.asarray(tokens), tr0, jnp.asarray(mask))

    cfg = get_arch(TX).reduced()
    ctx = lm.make_context(cfg, "cpu", engine=engine, moe_stream=moe_stream,
                          compute_dtype=torch.float32)
    params = convert.params_from_jax(jax.tree.map(np.asarray, params_j),
                                     device="cpu")
    logits, _, tr = lm.prefill(
        params, torch.from_numpy(tokens).long(), torch.arange(8), ctx, 9,
        traffic=traffic.init_traffic_state(cfg.moe.n_experts, 1,
                                           n_layers=cfg.n_layers),
        traffic_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), rtol=TOL,
                               atol=TOL)
    _check_state(tr, jax.tree.map(np.asarray, tr_j), engine)
    assert tr.last_expert_count.sum() == cfg.n_layers * mask.sum() * cfg.moe.top_k


# ------------------------------------------------------- pad invariance ----

def _moe_layer_params(rng, d, e, f, n=None):
    lead = () if n is None else (n,)
    w = lambda *s: torch.from_numpy(
        (rng.standard_normal(lead + s) * s[-2] ** -0.5).astype(np.float32))
    return {"router": w(d, e), "w1": w(1, e, d, f), "w3": w(1, e, d, f),
            "w2": w(1, e, f, d)}


@pytest.mark.parametrize("layer", ["moe_block", "stream_tx_layers"])
def test_traffic_pad_invariance(layer):
    """A prompt left-padded to 16 with its pad positions masked gives the
    traffic of the same prompt unpadded: the pads are routed (and may take
    capacity) but not counted.  Through ``moe_block`` and through a
    one-layer ``stream_tx_layers`` (a parallel block: its router reads the
    block input, so the real rows route the same behind the pads)."""
    rng = np.random.default_rng(3)
    d, e, f, k, n_real = 32, 8, 16, 2, 10
    placement = ExpertPlacement(e, 1, 1)
    dcfg = dcomm.DcommConfig(engine="fused_flat", node_size=1)
    x_real = torch.from_numpy(rng.standard_normal((1, n_real, d)).astype(np.float32))
    pads = torch.from_numpy(rng.standard_normal((1, 16 - n_real, d)).astype(np.float32))
    x_pad = torch.cat([pads, x_real], dim=1)
    mask = torch.arange(16)[None] >= 16 - n_real
    if layer == "moe_block":
        p = _moe_layer_params(rng, d, e, f)

        def run(x, m):
            return moe_block(x, p, placement=placement, dcfg=dcfg, top_k=k,
                             traffic=traffic.init_traffic_state(e, 1),
                             traffic_mask=m)[1]
    else:
        p = _moe_layer_params(rng, d, e, f, n=1)
        hq, hkv, hd = 2, 1, 16
        attn = {"wq": torch.randn(1, d, hq * hd) * 0.1,
                "wk": torch.randn(1, d, hkv * hd) * 0.1,
                "wv": torch.randn(1, d, hkv * hd) * 0.1,
                "wo": torch.randn(1, hq * hd, d) * 0.1}
        ln = torch.ones(1, d)

        def run(x, m):
            return stream_tx_layers(
                x, p, attn, ln, ln, placement=placement, dcfg=dcfg, top_k=k,
                positions=torch.arange(x.shape[1]), n_heads=hq, n_kv=hkv,
                head_dim=hd, traffic=traffic.init_traffic_state(e, 1,
                                                                n_layers=1),
                traffic_mask=m)[1]
    clean = run(x_real, torch.ones(1, n_real, dtype=torch.bool))
    padded = run(x_pad, mask)
    assert clean.last_expert_count.sum() == n_real * k
    for name in traffic.TrafficState._fields:
        assert torch.equal(getattr(clean, name), getattr(padded, name)), name
    unmasked = run(x_pad, None)
    assert unmasked.last_expert_count.sum() == 16 * k


# ---------------------------------------------- commplan and relayout ----

@pytest.mark.parametrize("n_experts,ep,node", [(16, 4, 2), (16, 8, 4),
                                               (4, 8, 2), (8, 1, 1)])
def test_commplan_and_relayout_views_match_reference(n_experts, ep, node):
    """The copied ``commplan`` (path costs, decisions, their summary, the
    dedup accounting, sequence migration) and the ``relayout`` views on
    random layer-stacked states, with the same explicit link costs on both
    sides (the port's defaults are the H100 point)."""
    rng = np.random.default_rng(n_experts + ep + node)
    L = 3
    jp = JPlacement(n_experts=n_experts, ep=ep, node_size=node)
    tp = ExpertPlacement(n_experts=n_experts, ep=ep, node_size=node)
    state = jtraffic.TrafficState(
        rng.random((L, n_experts), np.float32) * 10,
        rng.random((L, ep), np.float32) * 10,
        rng.integers(0, 20, (L, n_experts)).astype(np.float32),
        np.array([0, 2, 5], np.int32),
        rng.random((L, ep, ep), np.float32) * 10,
        rng.random((L, ep), np.float32) * 10)
    port_state = traffic.TrafficState(*state)
    costs = dict(intra_bw=819e9, inter_bw=50e9, hop_overhead_s=2e-6)
    for dedup in (False, True):
        kw = dict(row_bytes=128, dedup=dedup, default="fused_hier")
        want = jcommplan.plan_paths(state, jp, costs=jcommplan.LinkCosts(**costs),
                                    **kw)
        got = commplan.plan_paths(port_state, tp,
                                  costs=commplan.LinkCosts(**costs), **kw)
        np.testing.assert_equal([tuple(x) for x in got],
                                [tuple(x) for x in want])
        assert (commplan.summarize_decisions(got)
                == jcommplan.summarize_decisions(want))
    assert (commplan.dedup_savings(port_state, tp)
            == jcommplan.dedup_savings(state, jp))
    loads = rng.random(ep * 2) * 5
    for threshold in (1.05, 10.0):
        got_perm, got_st = commplan.plan_sequence_migration(
            loads, 2, row_bytes=64, threshold=threshold)
        want_perm, want_st = jcommplan.plan_sequence_migration(
            loads, 2, row_bytes=64, threshold=threshold)
        np.testing.assert_array_equal(got_perm, want_perm)
        assert got_st == want_st
    dc = dcomm.DcommConfig()
    lc = commplan.LinkCosts.from_dcomm(dc)
    assert lc == commplan.LinkCosts()
    assert (lc.intra_bw, lc.inter_bw, lc.hop_overhead_s) == (
        dc.pipe_stage_bw, dc.pipe_wire_bw, dc.pipe_overhead_s)
    np.testing.assert_array_equal(relayout.placement_table(tp),
                                  jrelayout.placement_table(jp))
    np.testing.assert_array_equal(relayout.replica_counts(tp),
                                  jrelayout.replica_counts(jp))
    for counts in (state.last_expert_count[1], state.expert_ema[2]):
        np.testing.assert_array_equal(relayout.lane_loads(counts, tp),
                                      jrelayout.lane_loads(counts, jp))
