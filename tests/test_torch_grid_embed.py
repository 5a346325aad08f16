"""The vlm and encdec families over a (data, model) grid against the JAX
package: ``layers/attention.sharded_flash_attention`` (the reference's
head-parallel island) and reduced ``qwen2-vl-7b`` and
``seamless-m4t-large-v2`` trained and served on four gloo ranks, each rank
against the reference's mesh of four forced host devices.

The reference runs in one subprocess (``conftest.run_devices``) while the
port's four ranks run (``mp.spawn``, a ``file://`` rendezvous under
``tmp_path``), both set up once for the module on the same float32
parameters (seeded numpy in the reference's tree; each rank takes its cut
of the vocab pair through ``convert.params_from_jax(model=)``, the cut
``lm.shard_params`` makes of the whole tree) and the same global batches
(each data rank its rows, ``zoo.data_batch``):

- the island on a (1, 4) mesh at 6 q heads over 2 kv heads, so two padded
  heads read the last kv head clamped, with qk-norm and M-RoPE inside the
  shard: the output, and dq, dk, dv of one cotangent (each rank seeds its
  share of it, and the ranks' gradients sum to the reference's);
- each family's loss and every gradient leaf (``steps.value_and_grad``:
  the divisor, the reduction of the replicated leaves over the grid, a
  rank's shard of the vocab pair against the reference's cut of it) on a
  (2, 2) and a (1, 4) mesh.  Seamless runs at a vocabulary of 254, which 2
  divides and 4 does not: the (1, 4) case splits its vocab pair on d, the
  fallback ``lm._vocab_ce_chunk`` sums in f32;
- one lock-step ``serve.run(mesh=)`` of each family on the (2, 2) grid
  (the context's compute dtype float32) against the reference's bundle on
  its (2, 2) mesh, on the weights and batch ``serve.setup`` draws.

Tolerances: the island 1e-5 x max(1, |ref|); the loss, each gradient leaf
and the served logits 1e-4 relative to max(1, the leaf's max), as
``tests/test_torch_vlm.py`` and ``tests/test_torch_encdec.py`` hold them on
one rank; the served tokens exact.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from conftest import run_devices
from test_torch_ssm import close, flat, seeded
from test_torch_vlm import LAYOUTS
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.launch import serve, steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.layers import attention
from repro_torch.models import encdec_model, lm, zoo
from repro_torch.optim import adamw

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

TOL = 1e-4
TOL_ISLAND = 1e-5
SHAPES = ((2, 2), (1, 4))
WORLD = 4
VLM, SEAMLESS = "qwen2-vl-7b", "seamless-m4t-large-v2"
VOCAB = {VLM: 256, SEAMLESS: 254}
# the island: (B, S, Hq, Hkv, hd), M-RoPE sections, theta
ISLAND = (2, 16, 6, 2, 16)
SECTIONS, THETA = (2, 3, 3), 1e6
PROMPT, GEN = 8, 3
SERVE = ["--reduced", "--requests", "4", "--prompt-len", str(PROMPT),
         "--gen", str(GEN)]


def config(arch: str):
    return dataclasses.replace(get_arch(arch).reduced(), vocab=VOCAB[arch])


def params_np(arch: str) -> dict:
    """Seeded float32 parameters in the reference's tree (flat paths)."""
    cfg = config(arch)
    ctx = lm.make_context(cfg, "cpu", compute_dtype=torch.float32)
    init = (encdec_model.init_params if cfg.family == "encdec"
            else lm.init_params)
    shapes = {k: tuple(v.shape) for k, v in flat(init(
        cfg, ctx, torch.Generator().manual_seed(0),
        dtype=torch.float32)).items()}
    return seeded(shapes, 2)


def batch_np(arch: str) -> dict:
    """A global batch of four rows, labels partly -1."""
    cfg = config(arch)
    rng = np.random.default_rng(3)
    if cfg.family == "encdec":
        toks = rng.integers(0, cfg.vocab, (4, 9)).astype(np.int32)
        labels = toks[:, 1:].copy()
        labels[0, :3] = labels[3, 5:] = -1
        return {"frames": rng.standard_normal((4, 16, cfg.d_model)
                                              ).astype(np.float32),
                "tokens": toks[:, :-1], "labels": labels}
    labels = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    labels[0, :3] = labels[2, 10:] = -1
    return {"embeds": rng.standard_normal((4, 16, cfg.d_model)
                                          ).astype(np.float32),
            "positions": LAYOUTS["image"], "labels": labels}


def island_np() -> dict:
    b, s, hq, hkv, hd = ISLAND
    rng = np.random.default_rng(5)
    n = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return {"q": n(b, s, hq, hd), "k": n(b, s, hkv, hd), "v": n(b, s, hkv, hd),
            "q_norm": 1 + 0.1 * n(hd), "k_norm": 1 + 0.1 * n(hd),
            "ct": n(b, s, hq, hd), "rope": LAYOUTS["image"]}


JAX_CODE = r"""
import os
os.environ["XLA_FLAGS"] += (" --xla_backend_optimization_level=0"
                            " --xla_llvm_disable_expensive_passes=true"
                            " --xla_cpu_multi_thread_eigen=false")
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.configs import get_arch
from repro.layers import attention
from repro.models import encdec_model, lm, zoo

SHAPES, VOCAB, SECTIONS, THETA = {shapes!r}, {vocab!r}, {sections!r}, {theta!r}
d = np.load({data!r})
meshes = {{s: make_mesh(s, ("data", "model")) for s in SHAPES}}
out = {{}}


def tree(prefix):
    t = {{}}
    for k in d.files:
        if k.startswith(prefix):
            node = t
            *path, leaf = k[len(prefix):].split("/")
            for part in path:
                node = node.setdefault(part, {{}})
            node[leaf] = jnp.asarray(d[k])
    return t


# the island on the (1, 4) mesh: output and the VJP of one cotangent
isl = tree("island/")
pos = isl["rope"]
fn = lambda q, k, v: attention.sharded_flash_attention(
    q, k, v, pos[0], pos[0], mesh=meshes[1, 4], data_axes=("data",),
    causal=True, q_norm=isl["q_norm"], k_norm=isl["k_norm"],
    rope_theta=THETA, mrope_sections=SECTIONS, rope_positions=pos)
with meshes[1, 4]:
    o, vjp = jax.vjp(jax.jit(fn), isl["q"], isl["k"], isl["v"])
    for name, g in zip(("out", "dq", "dk", "dv"), (o, *vjp(isl["ct"]))):
        out["island/" + name] = np.asarray(g)

for arch, vocab in VOCAB.items():
    cfg = dataclasses.replace(get_arch(arch).reduced(), vocab=vocab)
    params, batch = tree(arch + "/p/"), tree(arch + "/b/")
    for shape in SHAPES:
        ctx = dataclasses.replace(
            lm.make_context(cfg, meshes[shape], multi_pod=False),
            compute_dtype=jnp.float32, remat=False)
        loss_fn = (encdec_model.encdec_loss if cfg.family == "encdec"
                   else lm.lm_loss)
        with meshes[shape]:
            (loss, _), grads = jax.jit(jax.value_and_grad(
                lambda p, b: loss_fn(p, b, ctx), has_aux=True))(params, batch)
        c = "%s/%dx%d/" % (arch, *shape)
        out[c + "loss"] = np.asarray(loss)
        for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
            out[c + "g/" + "/".join(p.key for p in path)] = np.asarray(g)
    # serve.run's lock-step batch on the (2, 2) mesh: prefill, greedy decode
    ctx = dataclasses.replace(
        lm.make_context(get_arch(arch).reduced(), meshes[2, 2],
                        multi_pod=False),
        compute_dtype=jnp.float32)
    bundle = zoo.build(ctx.cfg, ctx)
    sp, sb = tree(arch + "/sp/"), tree(arch + "/sb/")
    gen, max_len = int(d[arch + "/gen"]), int(d[arch + "/max_len"])
    with meshes[2, 2]:
        logits, st = jax.jit(
            lambda p, b: bundle.prefill(p, b, max_len))(sp, sb)
        step = jax.jit(lambda p, s, t: bundle.decode_step(p, s, t, max_len))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        seqs = [tok]
        for _ in range(gen - 1):
            logits, st = step(sp, st, tok)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            seqs.append(tok)
    out[arch + "/serve/tokens"] = np.asarray(jnp.stack(seqs, 1))
    out[arch + "/serve/logits"] = np.asarray(logits)
np.savez({out!r}, **out)
print("JAX_OK")
"""


def _tensors(d: dict, prefix: str) -> dict:
    """The ``prefix`` entries of ``d`` as torch tensors (floats float32,
    ints int64), the prefix dropped."""
    return {k[len(prefix):]: torch.from_numpy(v).float() if v.dtype.kind == "f"
            else torch.from_numpy(v).long()
            for k, v in d.items() if k.startswith(prefix)}


def _nest(flat_tree: dict) -> dict:
    tree = {}
    for k, v in flat_tree.items():
        node = tree
        *path, leaf = k.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def _rank_main(rank, world, init_file, data, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=240))
    try:
        meshes = {s: make_host_mesh(*s) for s in SHAPES}
        d = dict(np.load(data))
        out = {}
        # the island on the (1, 4) grid: each rank seeds its share of the
        # cotangent, and the gradients are summed over the group
        isl = _tensors(d, "island/")
        group = meshes[1, 4].ep_group
        q, k, v = (isl[n].requires_grad_(True) for n in ("q", "k", "v"))
        pos = isl["rope"]
        o = attention.sharded_flash_attention(
            q, k, v, pos[0], pos[0], group=group, causal=True,
            q_norm=isl["q_norm"], k_norm=isl["k_norm"], rope_theta=THETA,
            mrope_sections=SECTIONS, rope_positions=pos)
        o.backward(isl["ct"] / WORLD)
        out["island/out"] = o.detach().numpy()
        for name, t in (("dq", q), ("dk", k), ("dv", v)):
            g = t.grad.clone()
            dist.all_reduce(g, group=group)
            out["island/" + name] = g.numpy()
        for arch in VOCAB:
            cfg = config(arch)
            prefix = arch + "/p/"
            tree = _nest({k[len(prefix):]: v for k, v in d.items()
                          if k.startswith(prefix)})
            batch = _tensors(d, arch + "/b/")
            for shape in SHAPES:
                ctx = lm.make_context(cfg, "cpu", mesh=meshes[shape],
                                      compute_dtype=torch.float32)
                model = zoo.build(cfg, ctx)
                # this rank's cut of the reference's tree: the vocab pair's
                # shard, as lm.shard_params cuts the port's whole tree
                params = convert.params_from_jax(
                    tree, device="cpu", model=(shape[1], rank % shape[1]),
                    tp=False)
                held = lm.shard_params(convert.params_from_jax(
                    tree, device="cpu"), ctx)
                c = f"{arch}/{shape[0]}x{shape[1]}/"
                out[c + "cut_equal"] = np.array(all(
                    torch.equal(a, b) for a, b in zip(adamw.leaves(params),
                                                      adamw.leaves(held))))
                loss, _, grads = steps.value_and_grad(model)(
                    params, zoo.data_batch(batch, ctx))
                out[c + "loss"] = loss.detach().numpy()
                for path, g in flat(adamw.unflatten(params, grads)).items():
                    out[c + "g/" + path] = g.numpy()
            # serve.run on the (2, 2) grid, the compute dtype float32
            make = lm.make_context
            lm.make_context = lambda *a, **kw: make(
                *a, **{**kw, "compute_dtype": torch.float32})
            try:
                sv = serve.run(serve.parse_args(["--arch", arch] + SERVE),
                               device="cpu", mesh=meshes[2, 2])
            finally:
                lm.make_context = make
            out[arch + "/serve/tokens"] = sv["tokens"].numpy()
            out[arch + "/serve/logits"] = sv["logits"].numpy()
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """The reference's arrays and each rank's, from one subprocess and one
    spawn of four ranks running at once."""
    tmp = tmp_path_factory.mktemp("grid_embed")
    arrays = {f"island/{k}": v for k, v in island_np().items()}
    for arch in VOCAB:
        arrays.update({f"{arch}/p/{k}": v for k, v in params_np(arch).items()})
        arrays.update({f"{arch}/b/{k}": v for k, v in batch_np(arch).items()})
        # serve.run's weights and batch, drawn by its setup at one rank
        s = serve.setup(serve.parse_args(["--arch", arch] + SERVE), "cpu")
        arrays.update({f"{arch}/sp/{k}": v.float().numpy()
                       for k, v in flat(s.params).items()})
        arrays.update({f"{arch}/sb/{k}": v.float().numpy()
                       if v.is_floating_point() else v.numpy().astype(np.int32)
                       for k, v in s.batch.items()})
        arrays[f"{arch}/gen"] = np.array(GEN)
        arrays[f"{arch}/max_len"] = np.array(s.max_len)
    data = str(tmp / "data.npz")
    np.savez(data, **arrays)
    code = JAX_CODE.format(shapes=SHAPES, vocab=VOCAB, sections=SECTIONS,
                           theta=THETA, data=data, out=str(tmp / "jax.npz"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(run_devices, code, WORLD, 600)
        mp.spawn(_rank_main, args=(WORLD, str(tmp / "rendezvous"), data,
                                   str(tmp)), nprocs=WORLD, join=True)
        assert "JAX_OK" in jax_run.result()
    want = dict(np.load(tmp / "jax.npz"))
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    return want, ranks


@pytest.mark.parametrize("name", ["out", "dq", "dk", "dv"])
def test_island_matches_reference_with_padded_heads(grid, name):
    """6 q heads over 2 kv heads on four ranks: two q heads a rank, heads 6
    and 7 zero padding that reads kv head 1; qk-norm and M-RoPE at the
    image layout inside the shard; every rank's output (the heads
    all-gathered) and the gradients summed over the ranks."""
    want, ranks = grid
    for r, got in enumerate(ranks):
        close(got[f"island/{name}"], want[f"island/{name}"],
              f"rank {r} {name}", TOL_ISLAND)


def _vocab_cut(path: str, g: np.ndarray, shape, r: int) -> np.ndarray:
    """The reference's whole gradient as rank ``r`` holds it: the vocab
    pair cut to its model rank's shard (vocab or d), the rest whole."""
    return np.asarray(lm.tp_cut(path, g, shape[1], r % shape[1], tp=False))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", list(VOCAB))
def test_loss_and_every_grad_leaf_match_the_reference_mesh(grid, arch, shape):
    """The loss and every gradient leaf on each rank (after the grid's
    reductions) against ``jax.value_and_grad`` on the reference's mesh of
    the same shape; the vocab pair split over the model group (on d for
    seamless over four, whose 254 tokens do not split there), each rank's
    cut of the reference's tree through ``convert`` the one
    ``lm.shard_params`` makes."""
    want, ranks = grid
    c = f"{arch}/{shape[0]}x{shape[1]}/"
    paths = sorted(k[len(c) + 2:] for k in want if k.startswith(c + "g/"))
    m = shape[1]
    split = "embed" if arch == VLM or m == 2 else None
    for r, got in enumerate(ranks):
        assert got[c + "cut_equal"], f"rank {r}: convert's cut"
        assert sorted(k[len(c) + 2:] for k in got
                      if k.startswith(c + "g/")) == paths
        close(got[c + "loss"], want[c + "loss"], f"rank {r} loss")
        for path in paths:
            ref = _vocab_cut(path, want[c + "g/" + path], shape, r)
            close(got[c + "g/" + path], ref, f"rank {r} {path}")
        # the vocab pair's shard: on the vocab, or on d (seamless over 4)
        on_d = got[c + "g/embed"].shape[-1] < config(arch).d_model
        assert on_d == (split is None)


@pytest.mark.parametrize("arch", list(VOCAB))
def test_lock_step_serve_gives_the_reference_mesh_tokens(grid, arch):
    """``serve.run(mesh=)`` on the (2, 2) grid: each data rank prefills and
    decodes its two requests, the model group runs the prefill's attention
    head-parallel; every rank returns the whole batch's tokens, the
    reference's, and its last logits."""
    want, ranks = grid
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got[f"{arch}/serve/tokens"],
                                      want[f"{arch}/serve/tokens"],
                                      err_msg=f"rank {r}")
        close(got[f"{arch}/serve/logits"], want[f"{arch}/serve/logits"],
              f"rank {r} last logits")
