"""The ssm and hybrid families over a (data, model) grid against the JAX
package: ``layers/ssm.mamba2_mixer`` split by SSM head over a model group,
and reduced ``mamba2-2.7b`` and ``hymba-1.5b`` trained and served on gloo
ranks, each against the reference on a mesh of four forced host devices.

The reference runs in one subprocess (``conftest.run_devices``) while the
port's ranks run: first a world of two (``mp.spawn``, a ``file://``
rendezvous under ``tmp_path``) for the (2, 1) and (1, 2) grids, then a
world of four for the (2, 2) and (1, 4) grids.  Both sides start from the
same float32 parameters (seeded numpy in the reference's tree; each rank
takes its cut through ``convert.params_from_jax(model=)``, the cut
``lm.shard_params`` makes of the whole tree: the vocab pair's shard and its
SSM heads') and the same global batches (each data rank its rows):

- the mixer over the four ranks of a (1, 4) model group against the
  reference's ``mamba2_mixer``, at 12 heads in 6 groups (a rank's three
  heads read two groups) and at 8 heads in 4 groups (a rank's two heads
  one whole group): the output, dx and every dW of one cotangent (each rank
  seeds its share; dx and the B and C columns' gradient are summed over
  the ranks, ``steps.reduce_whole``), and the state and output of one
  decode step from the prefill's state, each rank's heads' cut;
- each family's loss and every gradient leaf (``steps.value_and_grad``: a
  rank's shard against the reference's whole gradient cut by the port's
  rule) on a (2, 2) and a (1, 4) mesh, and on (1, 4) a mamba2 of six heads
  (d 48, head dim 16), which four ranks do not divide: its mixer runs
  whole on every rank;
- on every model group that divides the heads each rank holds exactly its
  heads' columns of ``in_proj_zx`` and ``conv_w`` and the B and C columns
  whole;
- serving: lock-step ``serve.run(mesh=)`` on (2, 2) and (2, 1) against the
  reference bundle on its (2, 2) mesh (the context's compute dtype float32),
  and the continuous engine (``serve.run`` with ``--continuous``) on (2, 1)
  and (2, 2) against the reference's lock-step tokens and the port's engine
  on one rank;
- one AdamW step of a reduced mamba2 on (1, 2) against the step on one
  rank: the loss, the clip norm (the B and C columns counted once) and
  each rank's updated parameters;
- a checkpoint of a reduced mamba2 after that step on (1, 2),
  restored on one rank and on (1, 4) (``elastic.remesh_restore``): the
  parameters and the AdamW state come back bit-equal.

Tolerances: the mixer 1e-5 x max(1, |ref|); the loss, each gradient leaf
and the served logits 1e-4 relative to max(1, the leaf's max), as
``tests/test_torch_ssm.py`` holds them on one rank; tokens and restored
bits exact.
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
from test_torch_grid_embed import _nest, _tensors
from test_torch_ssm import close, flat, seeded
from xla_prelude import PRELUDE
from repro_torch import convert
from repro_torch.checkpoint import checkpointer
from repro_torch.configs import get_arch
from repro_torch.launch import serve, steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.layers import ssm
from repro_torch.models import lm, zoo
from repro_torch.optim import adamw
from repro_torch.parallel import sharding
from repro_torch.runtime import elastic

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

TOL = 1e-4
TOL_MIXER = 1e-5
WORLD = 4
MAMBA, HYMBA = "mamba2-2.7b", "hymba-1.5b"
SIX = MAMBA + "@6"            # six SSM heads: four ranks do not divide them
ARCHS = (MAMBA, HYMBA, SIX)
CASES = ((MAMBA, (2, 2)), (MAMBA, (1, 4)), (HYMBA, (2, 2)), (HYMBA, (1, 4)),
         (SIX, (1, 4)))
SERVED = (MAMBA, HYMBA)
# the mixer: (B, S, d, P, N, chunk, K) and, by case, (heads, groups)
MIX = (2, 16, 32, 4, 4, 4, 4)
MIXERS = {"index": (12, 6), "groups": (8, 4)}
LEAVES = ("in_proj_zx", "in_proj_dt", "conv_w", "dt_bias", "a_log",
          "d_skip", "norm", "out_proj")
SERVE = ["--reduced", "--requests", "4", "--prompt-len", "8", "--gen", "3"]
STEP = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)


def config(name: str):
    """The reduced config of ``name`` ("arch", or "arch@6": six SSM heads)."""
    arch, *six = name.split("@")
    cfg = get_arch(arch).reduced()
    if six:
        cfg = dataclasses.replace(cfg, d_model=48, ssm=dataclasses.replace(
            cfg.ssm, head_dim=16))
    return cfg


def params_np(name: str) -> dict:
    """Seeded float32 parameters in the reference's tree (flat paths)."""
    cfg = config(name)
    ctx = lm.make_context(cfg, "cpu", compute_dtype=torch.float32)
    shapes = {k: tuple(v.shape) for k, v in flat(lm.init_params(
        cfg, ctx, torch.Generator().manual_seed(0),
        dtype=torch.float32)).items()}
    return seeded(shapes, 2)


def batch_np(name: str) -> dict:
    """A global batch of four rows of 16 tokens, labels partly -1."""
    rng = np.random.default_rng(3)
    toks = rng.integers(0, config(name).vocab, (4, 17)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = labels[2, 10:] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


def mixer_dims(name: str) -> tuple[dict, sharding.SsmDims]:
    """``mamba2_mixer``'s keyword dims of a mixer case and its leaves'
    ``SsmDims``."""
    h, g = MIXERS[name]
    _, _, _, p, n, chunk, _ = MIX
    args = dict(d_inner=h * p, n_heads=h, head_dim=p, d_state=n, n_groups=g,
                chunk=chunk)
    return args, sharding.SsmDims(h * p, h, 2 * g * n)


def mixer_np(name: str) -> dict:
    b, s, d, p, n, _, k = MIX
    args, dims = mixer_dims(name)
    din, h = dims.inner, dims.heads
    shapes = {"in_proj_zx": (d, 2 * din + dims.groups), "in_proj_dt": (d, h),
              "conv_w": (k, din + dims.groups), "dt_bias": (h,),
              "a_log": (h,), "d_skip": (h,), "norm": (din,),
              "out_proj": (din, d)}
    out = {f"p/{k}": v for k, v in seeded(shapes, 7).items()}
    rng = np.random.default_rng(8)
    out["x"] = rng.standard_normal((b, s, d)).astype(np.float32)
    out["ct"] = rng.standard_normal((b, s, d)).astype(np.float32)
    out["x1"] = rng.standard_normal((b, 1, d)).astype(np.float32)
    return out


JAX_CODE = r"""
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.configs import get_arch
from repro.layers import ssm
from repro.models import lm, zoo

MIXERS, MIX, CASES, SERVED = {mixers!r}, {mix!r}, {cases!r}, {served!r}
d = np.load({data!r})
meshes = {{s: make_mesh(s, ("data", "model")) for s in ((2, 2), (1, 4))}}
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


def config(name):
    arch, *six = name.split("@")
    cfg = get_arch(arch).reduced()
    if six:
        cfg = dataclasses.replace(cfg, d_model=48, ssm=dataclasses.replace(
            cfg.ssm, head_dim=16))
    return cfg


# the mixer, whole: output, the VJP of one cotangent, one decode step
_, _, _, p_dim, n_dim, chunk, _ = MIX
for name, (h, g) in MIXERS.items():
    m = tree("mixer/%s/" % name)
    args = dict(d_inner=h * p_dim, n_heads=h, head_dim=p_dim, d_state=n_dim,
                n_groups=g, chunk=chunk)
    fn = lambda x, p: ssm.mamba2_mixer(x, p, **args)
    (y, st), vjp = jax.vjp(jax.jit(fn), m["x"], m["p"])
    ct_st = jax.tree.map(jnp.zeros_like, st)
    dx, dp = vjp((m["ct"], ct_st))
    y1, st1 = jax.jit(lambda x, p, s: ssm.mamba2_mixer(
        x, p, state=s, single_step=True, **args))(m["x1"], m["p"], st)
    c = "mixer/%s/" % name
    for k, v in (("y", y), ("dx", dx), ("ssd", st.ssd), ("conv", st.conv),
                 ("y1", y1), ("ssd1", st1.ssd), ("conv1", st1.conv)):
        out[c + k] = np.asarray(v)
    for k, v in dp.items():
        out[c + "g/" + k] = np.asarray(v)

for name, shape in CASES:
    cfg = config(name)
    params, batch = tree(name + "/p/"), tree(name + "/b/")
    ctx = dataclasses.replace(
        lm.make_context(cfg, meshes[shape], multi_pod=False),
        compute_dtype=jnp.float32, remat=False)
    with meshes[shape]:
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: lm.lm_loss(p, b, ctx), has_aux=True))(params, batch)
    c = "%s/%dx%d/" % (name, *shape)
    out[c + "loss"] = np.asarray(loss)
    for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
        out[c + "g/" + "/".join(p.key for p in path)] = np.asarray(g)

# serve.run's lock-step batch on the (2, 2) mesh: prefill, greedy decode
for arch in SERVED:
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


def _tree(d: dict, prefix: str) -> dict:
    """The ``prefix`` entries of ``d`` as a nested tree, the prefix
    dropped."""
    return _nest({k[len(prefix):]: v for k, v in d.items()
                  if k.startswith(prefix)})


def _f32_serve(argv: list, mesh=None) -> dict:
    """``serve.run`` of ``argv`` on the CPU (on ``mesh``; None: one rank),
    the context's compute dtype float32."""
    make = lm.make_context
    lm.make_context = lambda *a, **kw: make(
        *a, **{**kw, "compute_dtype": torch.float32})
    try:
        return serve.run(serve.parse_args(argv), device="cpu", mesh=mesh)
    finally:
        lm.make_context = make


def _streams(out: dict) -> np.ndarray:
    """The continuous engine's outputs of ``serve.run``, in request order."""
    return np.array([r.output for r in sorted(out["done"],
                                              key=lambda r: r.rid)])


def _serve_rank(arch: str, mesh, tag: str, out: dict) -> None:
    """Lock-step and continuous ``serve.run`` of ``arch`` on ``mesh``."""
    sv = _f32_serve(["--arch", arch] + SERVE, mesh)
    out[f"{arch}/{tag}/tokens"] = sv["tokens"].numpy()
    out[f"{arch}/{tag}/logits"] = sv["logits"].numpy()
    out[f"{arch}/{tag}/streams"] = _streams(
        _f32_serve(["--arch", arch, "--continuous"] + SERVE, mesh))


def _state(params, opt) -> dict:
    """A train state's leaves by "params/..." and "mu/..." (nu, master)."""
    out = {f"params/{k}": v.detach() for k, v in flat(params).items()}
    for part in ("mu", "nu", "master"):
        out.update({f"{part}/{k}": v
                    for k, v in flat(getattr(opt, part)).items()})
    return out


def _mixer_rank(d: dict, name: str, group, out: dict) -> None:
    """The mixer case ``name`` on this rank of the model group ``group``."""
    m, r = dist.get_world_size(group), dist.get_rank(group)
    args, dims = mixer_dims(name)
    t = _tensors(d, f"mixer/{name}/")
    own = {k: sharding.ssm_cut(f"layers/ssm/{k}", t["p/" + k], dims, m,
                               r).requires_grad_(True) for k in LEAVES}
    x = t["x"].requires_grad_(True)
    y, st = ssm.mamba2_mixer(x, own, group=group, **args)
    y.backward(t["ct"] / m)            # this rank's share of the cotangent
    paths = [f"layers/ssm/{k}" for k in LEAVES]
    grads = steps.reduce_whole(
        [own[k].grad for k in LEAVES], paths, group,
        lambda p: sharding.ssm_whole(p, dims, m))
    dx = x.grad.clone()
    dist.all_reduce(dx, group=group)
    with torch.no_grad():
        y1, st1 = ssm.mamba2_mixer(t["x1"], own, state=ssm.SsmState(
            st.ssd.detach(), st.conv.detach()), single_step=True,
            group=group, **args)
    c = f"mixer/{name}/"
    for k, v in (("y", y), ("dx", dx), ("ssd", st.ssd), ("conv", st.conv),
                 ("y1", y1), ("ssd1", st1.ssd), ("conv1", st1.conv)):
        out[c + k] = v.detach().numpy()
    for k, g in zip(LEAVES, grads):
        out[c + "g/" + k] = g.numpy()


def _init(rank, world, init_file):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=240))


def _pair_main(rank, world, init_file, data, out_dir):
    """The world of two: serving on the (2, 1) grid, and a train step of
    the reduced mamba2 on (1, 2) saved to ``out_dir/ckpt``."""
    _init(rank, world, init_file)
    try:
        out = {}
        for arch in SERVED:
            _serve_rank(arch, make_host_mesh(2, 1), "2x1", out)
        mesh = make_host_mesh(1, 2)
        cfg = config(MAMBA)
        model = zoo.build(cfg, lm.make_context(cfg, "cpu", mesh=mesh,
                                               compute_dtype=torch.float32))
        d = dict(np.load(data))
        tree = _tree(d, f"{MAMBA}/p/")
        params = convert.params_from_jax(tree, device="cpu", model=(2, rank),
                                         tp=False)
        opt = steps.init_state(model, params)
        batch = _tensors(d, f"{MAMBA}/b/")
        params, opt, met = steps.make_train_step(model, STEP)(params, opt,
                                                              batch)
        out["step/loss"] = met["loss"].numpy()
        out["step/grad_norm"] = met["grad_norm"].numpy()
        lay = checkpointer.context_layout(model.ctx)
        checkpointer.wait(checkpointer.save(f"{out_dir}/ckpt", (params, opt),
                                            1, lay=lay))
        out.update({f"ckpt/{k}": v.numpy()
                    for k, v in _state(params, opt).items()})
        np.savez(f"{out_dir}/pair{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def _rank_main(rank, world, init_file, data, out_dir):
    """The world of four: the mixer on (1, 4), each case's loss and grads on
    its grid, serving on (2, 2), the checkpoint restored on (1, 4)."""
    _init(rank, world, init_file)
    try:
        meshes = {s: make_host_mesh(*s) for s in ((2, 2), (1, 4))}
        d = dict(np.load(data))
        out = {}
        for name in MIXERS:
            _mixer_rank(d, name, meshes[1, 4].ep_group, out)
        for name, shape in CASES:
            cfg = config(name)
            tree = _tree(d, f"{name}/p/")
            ctx = lm.make_context(cfg, "cpu", mesh=meshes[shape],
                                  compute_dtype=torch.float32)
            params = convert.params_from_jax(
                tree, device="cpu", model=(shape[1], rank % shape[1]),
                tp=False)
            held = lm.shard_params(convert.params_from_jax(
                tree, device="cpu"), ctx)
            c = f"{name}/{shape[0]}x{shape[1]}/"
            out[c + "cut_equal"] = np.array(all(
                torch.equal(a, b) for a, b in zip(adamw.leaves(params),
                                                  adamw.leaves(held))))
            out[c + "split"] = np.array(lm.ssm_group(ctx) is not None)
            loss, _, grads = steps.value_and_grad(zoo.build(cfg, ctx))(
                params, zoo.data_batch(_tensors(d, f"{name}/b/"), ctx))
            out[c + "loss"] = loss.detach().numpy()
            for path, g in flat(adamw.unflatten(params, grads)).items():
                out[c + "g/" + path] = g.numpy()
            for path, p in flat(params).items():
                out[c + "p/" + path] = p.detach().numpy()
        for arch in SERVED:
            _serve_rank(arch, meshes[2, 2], "2x2", out)
        # the (1, 2) checkpoint restored on (1, 4)
        cfg = config(MAMBA)
        mesh = meshes[1, 4]
        model = zoo.build(cfg, lm.make_context(cfg, "cpu", mesh=mesh,
                                               compute_dtype=torch.float32))
        like = model.init(torch.Generator().manual_seed(5), torch.float32)
        (params, opt), step = elastic.remesh_restore(
            f"{out_dir}/ckpt", (like, steps.init_state(model, like)), mesh,
            vocab=(cfg.vocab, cfg.d_model), ssm=lm.ssm_dims(cfg))
        out["restore/step"] = np.array(step)
        out.update({f"restore/{k}": v.numpy()
                    for k, v in _state(params, opt).items()})
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """The reference's arrays, the port's one-rank side and each rank's,
    from one subprocess and two spawns (two ranks, then four) run while it
    runs."""
    tmp = tmp_path_factory.mktemp("grid_ssm")
    arrays = {}
    for name in MIXERS:
        arrays.update({f"mixer/{name}/{k}": v
                       for k, v in mixer_np(name).items()})
    for name in ARCHS:
        arrays.update({f"{name}/p/{k}": v for k, v in params_np(name).items()})
        arrays.update({f"{name}/b/{k}": v for k, v in batch_np(name).items()})
    one = {}
    for arch in SERVED:
        # serve.run's weights and batch, drawn by its setup at one rank
        s = serve.setup(serve.parse_args(["--arch", arch] + SERVE), "cpu")
        arrays.update({f"{arch}/sp/{k}": v.float().numpy()
                       for k, v in flat(s.params).items()})
        arrays.update({f"{arch}/sb/{k}": v.float().numpy()
                       if v.is_floating_point() else v.numpy().astype(np.int32)
                       for k, v in s.batch.items()})
        arrays[f"{arch}/gen"] = np.array(int(SERVE[-1]))
        arrays[f"{arch}/max_len"] = np.array(s.max_len)
    data = str(tmp / "data.npz")
    np.savez(data, **arrays)
    code = PRELUDE + JAX_CODE.format(
        mixers=MIXERS, mix=MIX, cases=CASES, served=SERVED, data=data,
        out=str(tmp / "jax.npz"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(run_devices, code, WORLD, 600)
        for arch in SERVED:          # the continuous engine on one rank
            one[arch] = _streams(_f32_serve(["--arch", arch, "--continuous"]
                                            + SERVE))
        mp.spawn(_pair_main, args=(2, str(tmp / "rendezvous2"), data,
                                   str(tmp)), nprocs=2, join=True)
        mp.spawn(_rank_main, args=(WORLD, str(tmp / "rendezvous4"), data,
                                   str(tmp)), nprocs=WORLD, join=True)
        assert "JAX_OK" in jax_run.result()
    want = dict(np.load(tmp / "jax.npz"))
    pair = [dict(np.load(tmp / f"pair{r}.npz")) for r in range(2)]
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    return want, ranks, pair, one, str(tmp / "ckpt")


@pytest.mark.parametrize("part", ["y", "dx", "grads", "states"])
@pytest.mark.parametrize("name", list(MIXERS))
def test_mixer_split_by_head_matches_reference(grid, name, part):
    """``mamba2_mixer`` over four ranks, each on its heads (12 heads in 6
    groups: a rank's three heads read two groups; 8 in 4: a rank's two one
    group), against the reference's whole mixer: the output on every rank,
    dx (the ranks' shares summed), every dW (each rank's heads' whole, the
    B and C columns' shares summed by ``steps.reduce_whole``) against the
    port's cut of the reference's, and the prefill's and one decode step's
    SSD state and conv inputs of the rank's heads."""
    want, ranks = grid[:2]
    c = f"mixer/{name}/"
    _, dims = mixer_dims(name)
    hl = dims.heads // WORLD
    for r, got in enumerate(ranks):
        what = f"rank {r} {name}"
        if part in ("y", "dx"):
            close(got[c + part], want[c + part], f"{what} {part}", TOL_MIXER)
            close(got[c + "y1"], want[c + "y1"], f"{what} step y", TOL_MIXER)
        elif part == "grads":
            for k in LEAVES:
                ref = sharding.ssm_cut(f"layers/ssm/{k}", want[c + "g/" + k],
                                       dims, WORLD, r)
                close(got[c + "g/" + k], ref, f"{what} d{k}", TOL_MIXER)
        else:
            for k in ("ssd", "ssd1"):
                close(got[c + k], want[c + k][:, r * hl:(r + 1) * hl],
                      f"{what} {k}", TOL_MIXER)
            for k in ("conv", "conv1"):
                ref = sharding.ssm_cut("layers/ssm/conv_w", want[c + k],
                                       dims, WORLD, r)
                close(got[c + k], ref, f"{what} {k}", TOL_MIXER)


def _ids(case):
    name, shape = case
    return f"{name}-{shape[0]}x{shape[1]}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_loss_and_every_grad_leaf_match_the_reference_mesh(grid, case):
    """The loss and every gradient leaf on each rank (after the grid's
    reductions) against ``jax.value_and_grad`` on the reference's mesh of
    the same shape: the vocab pair split over the model group (hymba's
    vocab of 256 on the vocab too), the Mamba2 leaves by SSM head where the
    group divides the heads (whole for the six-head mamba2 over four), each
    rank's cut of the reference's tree through ``convert`` the one
    ``lm.shard_params`` makes."""
    want, ranks = grid[:2]
    name, shape = case
    m = shape[1]
    dims = lm.ssm_dims(config(name))
    c = f"{name}/{shape[0]}x{shape[1]}/"
    paths = sorted(k[len(c) + 2:] for k in want if k.startswith(c + "g/"))
    for r, got in enumerate(ranks):
        assert got[c + "cut_equal"], f"rank {r}: convert's cut"
        assert bool(got[c + "split"]) == (dims.heads % m == 0)
        assert sorted(k[len(c) + 2:] for k in got
                      if k.startswith(c + "g/")) == paths
        close(got[c + "loss"], want[c + "loss"], f"rank {r} loss")
        for path in paths:
            ref = np.asarray(lm.tp_cut(path, want[c + "g/" + path], m, r % m,
                                       tp=False, ssm=dims))
            close(got[c + "g/" + path], ref, f"rank {r} {path}")


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_each_rank_holds_its_heads_columns_and_b_c_whole(grid, case):
    """Where the model group divides the SSM heads, each rank's
    ``in_proj_zx`` holds its heads' z and x columns and the B and C columns
    whole, and ``conv_w`` its heads' x columns and B and C whole, of the
    whole leaf's columns; its per-head leaves and ``out_proj`` its heads'.
    Where it does not, every rank holds them whole."""
    ranks = grid[1]
    name, shape = case
    m = shape[1]
    whole = params_np(name)
    din, h, gn = dims = lm.ssm_dims(config(name))
    split = h % m == 0
    for r, got in enumerate(ranks):
        c = f"{name}/{shape[0]}x{shape[1]}/p/layers/ssm/"
        zx, conv = got[c + "in_proj_zx"], got[c + "conv_w"]
        if not split:
            np.testing.assert_array_equal(zx, whole["layers/ssm/in_proj_zx"])
            np.testing.assert_array_equal(conv, whole["layers/ssm/conv_w"])
            continue
        k, lo = din // m, (r % m) * (din // m)
        wz, wc = whole["layers/ssm/in_proj_zx"], whole["layers/ssm/conv_w"]
        assert zx.shape[-1] == 2 * k + gn and conv.shape[-1] == k + gn
        np.testing.assert_array_equal(zx[..., :k], wz[..., lo:lo + k])
        np.testing.assert_array_equal(zx[..., k:2 * k],
                                      wz[..., din + lo:din + lo + k])
        np.testing.assert_array_equal(zx[..., 2 * k:], wz[..., 2 * din:])
        np.testing.assert_array_equal(conv[..., :k], wc[..., lo:lo + k])
        np.testing.assert_array_equal(conv[..., k:], wc[..., din:])
        hk = (r % m) * (h // m)
        for leaf in ("dt_bias", "a_log", "d_skip"):
            np.testing.assert_array_equal(
                got[c + leaf], whole[f"layers/ssm/{leaf}"][..., hk:hk + h // m])
        np.testing.assert_array_equal(
            got[c + "out_proj"], whole["layers/ssm/out_proj"][:, lo:lo + k])
        np.testing.assert_array_equal(got[c + "norm"],
                                      whole["layers/ssm/norm"][..., lo:lo + k])
        assert dims == sharding.SsmDims(din, h, gn)


@pytest.mark.parametrize("tag", ["2x2", "2x1"])
@pytest.mark.parametrize("arch", SERVED)
def test_lock_step_serve_gives_the_reference_mesh_tokens(grid, arch, tag):
    """``serve.run(mesh=)`` on the (2, 2) grid (each data rank prefills and
    decodes its two requests, the model group splits the SSM heads and runs
    Hymba's prefill attention head-parallel) and on the (2, 1) data grid:
    every rank returns the whole batch's tokens, the reference bundle's on
    its (2, 2) mesh, and its last logits."""
    want, ranks, pair = grid[:3]
    for r, got in enumerate(ranks if tag == "2x2" else pair):
        np.testing.assert_array_equal(got[f"{arch}/{tag}/tokens"],
                                      want[f"{arch}/serve/tokens"],
                                      err_msg=f"rank {r}")
        close(got[f"{arch}/{tag}/logits"], want[f"{arch}/serve/logits"],
              f"rank {r} last logits")


@pytest.mark.parametrize("tag", ["2x2", "2x1"])
@pytest.mark.parametrize("arch", SERVED)
def test_continuous_engine_on_the_grid_gives_the_reference_tokens(grid, arch,
                                                                  tag):
    """The continuous engine (``serve.run --continuous``: a pool of the four
    requests, two slots a data rank, the SSM rows all-gathered over the data
    group at each insert) on the (2, 2) and (2, 1) grids: every rank's
    streams are the reference's lock-step tokens and the port's engine's on
    one rank."""
    want, ranks, pair, one = grid[:4]
    for r, got in enumerate(ranks if tag == "2x2" else pair):
        streams = got[f"{arch}/{tag}/streams"]
        np.testing.assert_array_equal(streams, want[f"{arch}/serve/tokens"],
                                      err_msg=f"rank {r}")
        np.testing.assert_array_equal(streams, one[arch], err_msg=f"rank {r}")


def test_train_step_on_a_model_group_of_two_matches_one_rank(grid):
    """One AdamW step of the reduced mamba2 on (1, 2) (its mixers split by
    head, the vocab pair on the vocab) against the step on one rank from
    the same whole parameters and batch: each rank's loss and clip norm
    (the B and C columns, which both ranks hold, counted once) within 1e-5,
    its updated parameters within 1e-5 of its cut of the one rank's."""
    pair = grid[2]
    cfg = config(MAMBA)
    model = zoo.build(cfg, lm.make_context(cfg, "cpu",
                                           compute_dtype=torch.float32))
    params = convert.params_from_jax(_nest(params_np(MAMBA)), device="cpu")
    batch = {k: torch.from_numpy(v).long() for k, v in batch_np(MAMBA).items()}
    params, _, met = steps.make_train_step(model, STEP)(
        params, steps.init_state(model, params), batch)
    for r, got in enumerate(pair):
        close(got["step/loss"], float(met["loss"]), f"rank {r} loss", 1e-5)
        close(got["step/grad_norm"], float(met["grad_norm"]),
              f"rank {r} clip norm", 1e-5)
        for k, v in flat(params).items():
            close(got["ckpt/params/" + k],
                  _cut("params/" + k, v.detach().numpy(), 2, r, cfg),
                  f"rank {r} {k}", 1e-5)


def _cut(key: str, a: np.ndarray, m: int, r: int, cfg) -> np.ndarray:
    """A whole train-state leaf ("params/...", "mu/..." ...) as model rank
    ``r`` of ``m`` holds it in training."""
    path = key.split("/", 1)[1]
    return np.asarray(lm.tp_cut(path, a, m, r, tp=False,
                                ssm=lm.ssm_dims(cfg)))


@pytest.mark.parametrize("where", ["one rank", "1x4"])
def test_checkpoint_of_split_leaves_restores_bit_equal(grid, where):
    """A reduced mamba2's parameters and AdamW state after one step on
    (1, 2), saved whole (the ranks' SSM-head cuts gathered) and restored on
    one rank and on (1, 4): the one-rank tree cut again is each (1, 2)
    rank's, bit for bit, and each (1, 4) rank holds its cut of it."""
    ranks, pair, ckpt = grid[1], grid[2], grid[4]
    cfg = config(MAMBA)
    ctx = lm.make_context(cfg, "cpu", compute_dtype=torch.float32)
    like = lm.init_params(cfg, ctx, torch.Generator().manual_seed(5),
                          torch.float32)
    (params, opt), step = elastic.remesh_restore(ckpt,
                                                 (like, adamw.init(like)))
    assert step == 1
    whole = {k: v.numpy() for k, v in _state(params, opt).items()}
    keys = sorted(whole)
    if where == "one rank":
        for r, got in enumerate(pair):
            assert sorted(k[5:] for k in got if k.startswith("ckpt/")) == keys
            for k in keys:
                np.testing.assert_array_equal(
                    _cut(k, whole[k], 2, r, cfg), got["ckpt/" + k],
                    err_msg=f"(1, 2) rank {r} {k}")
        return
    for r, got in enumerate(ranks):
        assert int(got["restore/step"]) == 1
        for k in keys:
            np.testing.assert_array_equal(got["restore/" + k],
                                          _cut(k, whole[k], WORLD, r, cfg),
                                          err_msg=f"(1, 4) rank {r} {k}")
