"""``lm.prefill`` of the moe family over an EP group of four against the JAX
package on four forced host devices: each rank runs the MoE layers on its
stripe of the sequence, as the reference's island shards it
(``x_spec = P(data, model, None)``), so each rank reckons its capacity from
its own tokens.  A capacity factor of 0.5 makes tokens drop, the case in
which running the whole batch on every rank gives other results.

The port runs four gloo ranks; the JAX side runs ``conftest.run_devices``
with a (1, 4) mesh, at the same time.  Both take the same float32
parameters.  Tolerance 1e-4 on logits and caches (float32 sums in another
order across two layers and the vocabulary projection).
"""

import concurrent.futures
import dataclasses

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from conftest import run_devices
from xla_prelude import PRELUDE
from repro_torch.configs import get_arch
from repro_torch.core.routing import ExpertPlacement
from repro_torch.models import lm

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

ARCH = "qwen3-moe-30b-a3b"
EP, B, S = 4, 4, 32
CF = 0.5          # ~8 assignments per (lane, expert) per rank, capacity 8
TOL = 1e-4

JAX_CODE = """
import dataclasses, numpy as np, jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.configs import get_arch
from repro.models import lm
d = np.load({data!r})
tree = {{}}
for key in d.files:
    if key == "tokens":
        continue
    node = tree
    *path, leaf = key.split("/")
    for p in path:
        node = node.setdefault(p, {{}})
    node[leaf] = jnp.asarray(d[key])
cfg = get_arch({arch!r}).reduced()
mesh = make_mesh((1, {ep}), ("data", "model"))
ctx = dataclasses.replace(
    lm.make_context(cfg, mesh, multi_pod=False, engine="fused_flat",
                    capacity_factor={cf}), compute_dtype=jnp.float32)
tokens = jnp.asarray(d["tokens"])
with mesh:
    logits, state = jax.jit(lambda p, t: lm.prefill(
        p, t, jnp.arange(t.shape[1]), ctx, {max_len}))(tree, tokens)
np.savez({out!r}, logits=np.asarray(logits), k=np.asarray(state.kv["k"]),
         v=np.asarray(state.kv["v"]))
print("JAX_OK")
"""


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _rank_main(rank, world, init_file, data, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        d = np.load(data)
        params = _unflatten({k: torch.from_numpy(d[k]) for k in d.files
                             if k != "tokens"})
        tokens = torch.from_numpy(d["tokens"]).long()
        cfg = get_arch(ARCH).reduced()
        out = {}
        for name, cf in (("", CF), ("_nodrop", 8.0)):
            # a serving context: whole weights on every rank
            ctx = lm.make_context(cfg, "cpu", ep_group=dist.group.WORLD,
                                  capacity_factor=cf,
                                  compute_dtype=torch.float32,
                                  explicit_tp=False, split_vocab=False)
            logits, state = lm.prefill(lm.shard_params(params, ctx), tokens,
                                       torch.arange(S), ctx, S + 1)
            out["logits" + name] = logits.numpy()
            if not name:
                out.update(k=state.kv["k"].numpy(), v=state.kv["v"].numpy())
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def test_moe_prefill_ep4_shards_the_sequence_like_jax(tmp_path):
    cfg = get_arch(ARCH).reduced()
    ctx = dataclasses.replace(
        lm.make_context(cfg, "cpu", compute_dtype=torch.float32),
        placement=ExpertPlacement(n_experts=cfg.moe.n_experts, ep=EP,
                                  node_size=EP // 2))
    params = lm.init_params(cfg, ctx, torch.Generator().manual_seed(0),
                            dtype=torch.float32)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    data = tmp_path / "data.npz"
    np.savez(data, tokens=tokens,
             **{k: v.numpy() for k, v in _flatten(params)})
    code = PRELUDE + JAX_CODE.format(data=str(data), arch=ARCH, ep=EP, cf=CF,
                                     max_len=S + 1,
                                     out=str(tmp_path / "jax.npz"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(run_devices, code, EP, 300)
        mp.spawn(_rank_main, args=(EP, str(tmp_path / "rendezvous"), str(data),
                                   str(tmp_path)), nprocs=EP, join=True)
        assert "JAX_OK" in jax_run.result()
    want = np.load(tmp_path / "jax.npz")
    for r in range(EP):
        got = np.load(tmp_path / f"rank{r}.npz")
        for name in ("logits", "k", "v"):
            np.testing.assert_allclose(got[name], want[name], rtol=TOL,
                                       atol=TOL, err_msg=f"rank {r} {name}")
        # tokens dropped: without drops the logits are other ones
        assert np.abs(got["logits"] - got["logits_nodrop"]).max() > 1e-2
