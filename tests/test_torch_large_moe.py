"""The reference's large MoE configs in the port and what they need of it:
``mixtral-8x22b`` (group size 6, 8 experts of f 16384, a 4096-token
window), ``deepseek-v3-bench`` (the paper's Table 2 point: d 7168, 256
experts, top-8, group size 7) and the dense ``qwen3-4b``/``8b``/``14b``.

Against the JAX package: every ported config equal to the reference's; the
reference's ``fsdp_experts`` rule (``make_context`` on a stand-in mesh with
``.shape``) for every ported config at EP 1, 8 and 64 and DP 1 and 2; the
port's ``parallel/sharding`` against the reference's ``param_specs``; the
reduced mixtral's prefill and decode with a prompt longer than its window
(float32, 1e-4 on logits, as the other model tests); the plain flash at
group sizes 6 and 7 with a window against the Pallas kernel in interpret
mode.  Pinned: both large configs' parameter counts and the reckoned
per-rank training state with and without FSDP.  fused_swiglu's large-f
form: the wrapper's two C calls against the C signatures (a recorder: CUDA
is not here), and its arithmetic, the two launches' plain versions, against
the plain SwiGLU.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import make_mesh
from repro.configs import get_arch as jget_arch
from repro.kernels.flash_attention import _flash_fwd_pallas
from repro.models import lm as jlm
from repro.parallel.sharding import param_specs as jparam_specs
import torch_ep_train as h
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.core.routing import ExpertPlacement
from repro_torch.kernels import _build, fused_staging, ref
from repro_torch.kernels import grouped_matmul as gmm_k
from repro_torch.models import lm
from repro_torch.parallel import sharding

# one intra-op thread: the suite runs its files on parallel workers that
# share the host's cores
torch.set_num_threads(1)

NEW = ("mixtral-8x22b", "deepseek-v3-bench", "qwen3-4b", "qwen3-8b",
       "qwen3-14b")
TOL_MODEL = 1e-4
TOL = 2e-5


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_ported_configs_equal_the_reference(arch):
    """Every field of the port's config (and of its MoE spec) is the
    reference's, full width and reduced."""
    for mine, ref_cfg in ((get_arch(arch), jget_arch(arch)),
                          (get_arch(arch).reduced(),
                           jget_arch(arch).reduced())):
        for f in dataclasses.fields(mine):
            a, b = getattr(mine, f.name), getattr(ref_cfg, f.name)
            if f.name in ("moe", "ssm") and a is not None:
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, (arch, f.name, a, b)
    assert set(NEW) <= set(ARCH_IDS)


@pytest.mark.parametrize("arch,counts", [
    ("mixtral-8x22b", (5_338_601_472, 135_291_469_824)),
    ("deepseek-v3-bench", (9_130_062_080, 687_731_638_272)),
])
def test_large_param_counts_are_pinned(arch, counts):
    """(replicated, expert) parameters of the whole tree, reckoned."""
    assert lm.param_counts(get_arch(arch)) == counts


class _Mesh:
    """A stand-in for a mesh: the reference's ``make_context`` reads only
    its ``.shape``."""

    def __init__(self, data, model):
        self.shape = {"data": data, "model": model}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fsdp_rule_is_the_reference_make_context(arch):
    """``fsdp_experts`` as the reference's ``make_context`` sets it, at EP
    1, 8 and 64 and DP 1 and 2 (the rule reads one lane's expert bytes,
    whatever DP); the port's ``make_context`` at EP 1 and ``fsdp_rule`` on
    the placement of each EP; a family without MoE has none."""
    cfg = get_arch(arch)
    for ep in (1, 8, 64):
        for dp in (1, 2):
            want = jlm.make_context(jget_arch(arch), _Mesh(dp, ep),
                                    multi_pod=False).fsdp_experts
            got = (cfg.moe is not None and lm.fsdp_rule(cfg, ExpertPlacement(
                n_experts=cfg.moe.n_experts, ep=ep,
                node_size=max(1, ep // 4))))
            assert got == want, (arch, ep, dp)
            if ep == 1:
                assert lm.make_context(cfg, "cpu").fsdp_experts == want


def test_sharding_rule_is_the_reference_param_specs():
    """Each leaf of the reduced qwen3-moe tree: the dim the port splits over
    the EP group is where the reference's spec puts "model" on an expert
    leaf, and under FSDP the dim over the data group is its "data"; under
    ``tensor_parallel`` each TP leaf's dim over the model group is the
    reference's "model" entry (wq, wo and the MLP; none in the moe tree
    beyond attention), ``wk`` / ``wv`` stay whole (the reference's block
    reads them whole), the embed and head are split on the reference's
    "model" dim in training over a model group of 2 (``model_size``: the
    vocab), and all others are replicated."""
    cfg = get_arch("qwen3-moe-30b-a3b").reduced()
    ctx = lm.make_context(cfg, "cpu")
    ctx = dataclasses.replace(ctx, placement=dataclasses.replace(
        ctx.placement, ep=2, node_size=1))
    tree = lm.init_params(cfg, ctx, torch.Generator().manual_seed(0),
                          dtype=torch.float32)
    flat = h.flat(tree)
    jtree = h.nest((k, jnp.zeros(v.shape)) for k, v in flat.items())
    for fsdp in (False, True):
        want = h.flat(jparam_specs(jtree, multi_pod=False, model_size=2,
                                   fsdp_experts=fsdp))
        got = h.flat(sharding.param_specs(tree, fsdp_experts=fsdp))
        for path, spec in want.items():
            dims = tuple(spec) + (None,) * (flat[path].ndim - len(spec))
            model = [i for i, a in enumerate(dims) if a in ("model",
                                                            ("model",))]
            data = [i for i, a in enumerate(dims) if a == "data"]
            mine = got[path]
            if lm.lane_sharded(path):
                assert [mine.ep] == model, path
                assert ([] if mine.data is None
                        else [mine.data % flat[path].ndim]) == data, path
            else:
                assert mine == sharding.REPLICATED and not data, path
                tp = sharding.param_spec(path, flat[path].shape,
                                         tensor_parallel=True, model_size=2)
                if path.split("/")[0] in ("embed", "lm_head"):
                    assert tp == sharding.Spec(
                        model=model[0] - flat[path].ndim), path
                    assert not sharding.tp_sharded(path), path
                elif path.endswith(("wk", "wv")):
                    assert model and tp == sharding.REPLICATED, path
                elif model:
                    assert tp == sharding.Spec(
                        model=model[0] - flat[path].ndim), path
                    assert sharding.tp_sharded(path), path
                else:
                    assert tp == sharding.REPLICATED, path


def _jax_serve(cfg, tokens, max_len, steps):
    mesh = make_mesh((1, 1), ("data", "model"))
    ctx = dataclasses.replace(jlm.make_context(cfg, mesh, multi_pod=False),
                              compute_dtype=jnp.float32)
    params = jlm.init_params(cfg, jax.random.PRNGKey(0), ctx,
                             dtype=jnp.float32)
    s = tokens.shape[1]
    with mesh:
        prefill = jax.jit(lambda p, t: jlm.prefill(p, t, jnp.arange(s), ctx,
                                                   max_len))
        decode = jax.jit(lambda p, st, t: jlm.decode_step(p, st, t, ctx,
                                                          max_len))
        logits, state = prefill(params, jnp.asarray(tokens))
        out = [np.asarray(logits)]
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        for _ in range(steps):
            logits, state = decode(params, state, tok)
            out.append(np.asarray(logits))
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
    return jax.tree.map(np.asarray, params), out


def test_reduced_mixtral_past_its_window_matches_jax():
    """The reduced mixtral (window 16) prefills a prompt of 24 tokens,
    longer than its window, and decodes four tokens (the ring cache of the
    window's last positions): the logits at every step are the
    reference's."""
    arch, b, s, steps = "mixtral-8x22b", 2, 24, 4
    cfg = get_arch(arch).reduced()
    assert cfg.window == 16 < s
    max_len = s + steps + 1
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (b, s)).astype(
        np.int32)
    params_np, want = _jax_serve(jget_arch(arch).reduced(), tokens, max_len,
                                 steps)
    ctx = lm.make_context(cfg, "cpu", compute_dtype=torch.float32)
    params = convert.params_from_jax(params_np, device="cpu")
    logits, state = lm.prefill(params, torch.from_numpy(tokens).long(),
                               torch.arange(s), ctx, max_len)
    assert state.kv["k"].shape[2] == cfg.window
    got = [logits.numpy()]
    for _ in range(steps):
        logits, state = lm.decode_step(params, state, logits.argmax(-1), ctx,
                                       max_len)
        got.append(logits.numpy())
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        np.testing.assert_allclose(g, w, rtol=TOL_MODEL, atol=TOL_MODEL,
                                   err_msg=f"step {i}")


@pytest.mark.parametrize("hq,hkv,window", [(6, 1, None), (6, 1, 24),
                                           (7, 1, 24), (14, 2, None),
                                           (10, 2, None)])
def test_flash_plain_at_group_sizes_6_and_7_matches_pallas(hq, hkv, window):
    """The plain flash (what the Hopper form is held to on the card) at
    mixtral's and deepseek's group sizes, with and without a window shorter
    than the keys, and at qwen3-14b's 5, against the Pallas kernel in
    interpret mode."""
    b, sq, sk, hd, blk = 2, 32, 64, 16, 16
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in (
        (b, sq, hq, hd), (b, sk, hkv, hd), (b, sk, hkv, hd)))
    qp = np.arange(sq, dtype=np.int32) + sk - sq
    kp = np.arange(sk, dtype=np.int32)
    out_j, lse_j = _flash_fwd_pallas(*map(jnp.asarray, (q, k, v, qp, kp)),
                                     True, window, blk, blk, True)
    lse_j = np.moveaxis(np.asarray(lse_j), 1, 3).reshape(b, hq, sq)
    out, lse = ref.flash_attention_ref(
        *(torch.from_numpy(a) for a in (q, k, v, qp, kp)), True, window)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(lse.numpy(), lse_j, rtol=TOL, atol=TOL)


def _c_signature(fn: str) -> str:
    """'p' for each pointer, 'i' for each int of C entry ``fn``."""
    params, = (p for src in _build.CSRC.glob("*.cu")
               for p in re.findall(rf'extern "C" int {fn}\(([^)]*)\)',
                                   src.read_text()))
    return "".join("p" if "*" in p else "i" for p in params.split(","))


@pytest.mark.parametrize("f,dtype,want", [
    (2048, torch.bfloat16, "split"), (16384, torch.bfloat16, "split"),
    (768, torch.bfloat16, "wgmma"), (2048, torch.float32, "fma")])
def test_fused_swiglu_form_follows_f(monkeypatch, f, dtype, want):
    """bf16 at an f whose 64 x f activations do not stay resident takes the
    large-f form: ``grouped_swiglu`` then ``grouped_matmul``, each bound
    and called as its C signature says, with the flattened (S E) groups,
    the w1 expert stride and w2's strides, one launch counted and its
    form; f 768 the Hopper form; float32 the FMA form."""
    calls = []

    def fake_bind(name, fn, n_ptr, n_int):
        assert _c_signature(fn) == "p" * n_ptr + "i" * n_int + "p", fn
        return lambda *args: calls.append((fn, args)) or 0

    monkeypatch.setattr(_build, "bind", fake_bind)
    monkeypatch.setattr(_build, "require_cuda", lambda *a: None)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: object())
    s, e, c, d = 2, 3, 5, 16
    x = torch.zeros(s, e, c, d, dtype=dtype)
    ws = (torch.zeros(e, d, f, dtype=dtype), torch.zeros(e, d, f, dtype=dtype),
          torch.zeros(e, f, d, dtype=dtype))
    counts = torch.ones(s, e, dtype=torch.int32)
    n, forms = (fused_staging.fused_swiglu.launches,
                dict(fused_staging.fused_swiglu.forms))
    fused_staging.fused_swiglu(x, *ws, counts)
    assert fused_staging.fused_swiglu.launches == n + 1
    assert fused_staging.fused_swiglu.forms[want] == forms[want] + 1
    names = [fn for fn, _ in calls]
    if want == "split":
        assert names == ["grouped_swiglu", "grouped_matmul"]
        (_, a1), (_, a2) = calls
        assert a1[5:11] == (s * e, e, c, d, f, d * f)
        assert a2[4:12] == (s * e, e, c, f, d, *ws[2].stride())
        assert a2[12] == _build.DTYPE_CODE[torch.bfloat16]
    else:
        assert names == [{"wgmma": "fused_swiglu_tc",
                          "fma": "fused_swiglu"}[want]]


def test_large_f_form_arithmetic_is_the_plain_swiglu():
    """The large-f form's two launches, by their plain versions: silu(x @
    w1) * (x @ w3) per (s, e) group rounded to bf16, rows past counts zero,
    then grouped_matmul by w2: the plain SwiGLU within two bf16 steps of
    its largest output."""
    rng = np.random.default_rng(2)
    s, e, c, d, f = 2, 3, 6, 32, 48
    bf = torch.bfloat16
    x = torch.from_numpy(rng.standard_normal((s, e, c, d), np.float32)).to(bf)
    w1, w3 = (torch.from_numpy(rng.standard_normal((e, d, f), np.float32)
                               * d ** -0.5).to(bf) for _ in range(2))
    w2 = torch.from_numpy(rng.standard_normal((e, f, d), np.float32)
                          * f ** -0.5).to(bf)
    counts = torch.tensor([[0, 3, 6], [6, 1, 9]], dtype=torch.int32)
    cnt = counts.reshape(-1)
    g = x.reshape(s * e, c, d)
    hh = gmm_k.grouped_matmul_plain(g, w1, cnt).float()
    uu = gmm_k.grouped_matmul_plain(g, w3, cnt).float()
    a = (torch.nn.functional.silu(hh) * uu).to(bf)
    got = gmm_k.grouped_matmul_plain(a, w2, cnt).reshape(s, e, c, d)
    want = fused_staging.fused_swiglu_plain(x, w1, w3, w2, counts)
    tol = 2 * 2.0 ** -8 * want.float().abs().max().item()
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=0, atol=tol)
    live = torch.arange(c)[None, None] < counts[..., None]
    assert not got[~live].any()


def test_reckoned_state_with_fsdp_is_pinned():
    """The per-rank training state, GiB, reckoned from the parameter counts
    (``torch_ep_train.state_gib_per_rank``): ZeRO-1 and with FSDP of the
    experts, ``embed`` and ``lm_head`` split over the EP group, at the
    grids PERF.md prints."""
    table = {("qwen3-moe-30b-a3b", 8, 2): (44.74, 37.99),
             ("qwen3-moe-30b-a3b", 8, 4): (31.83, 21.71),
             ("qwen3-moe-30b-a3b", 64, 4): (10.72, 9.45),
             ("mixtral-8x22b", 8, 2): (213.13, 181.63),
             ("mixtral-8x22b", 8, 4): (151.95, 104.70),
             ("deepseek-v3-bench", 8, 2): (884.11, 723.98),
             ("deepseek-v3-bench", 8, 4): (622.94, 382.75),
             ("deepseek-v3-bench", 64, 4): (131.24, 101.21)}
    for (arch, ep, dp), want in table.items():
        mem = h.state_gib_per_rank(arch, eps=(ep,), dps=(dp,))
        got = (mem["gib_per_rank_dp"][ep, dp], mem["gib_per_rank_fsdp"][ep, dp])
        assert tuple(round(x, 2) for x in got) == want, (arch, ep, dp)
        one = h.state_gib_per_rank(arch, eps=(ep,), dps=(1,))
        assert one["gib_per_rank_fsdp"][ep, 1] == one["gib_per_rank_dp"][ep, 1]
