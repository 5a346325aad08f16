"""The port's copy of ``pipesim`` and its ``calibrate`` against the JAX
package.

Every planning function of ``repro_torch.core.pipesim`` returns what
``repro.core.pipesim``'s does on a grid of ``PipeParams``, and
``dcomm.pipe_geometry`` (the engine's slice count and capacity) what the
reference's does at the same constants.  Only the defaults differ: the
port's are the H100 spec point, on ``PipeParams`` and ``DcommConfig`` alike.
``calibrate`` on the CPU returns finite clamped constants, and ``apply`` and
``lm.make_context`` thread them into the config.
"""

import dataclasses
import itertools
import math

import pytest

from repro.core import dcomm as jdcomm
from repro.core import pipesim as jpipesim
from repro.core.dcomm import DcommConfig as JDcommConfig
from repro.core.routing import ExpertPlacement as JPlacement
from repro_torch.configs import get_arch
from repro_torch.core import calibrate, dcomm, pipesim
from repro_torch.core.dcomm import DcommConfig
from repro_torch.core.routing import ExpertPlacement
from repro_torch.models import lm

# (payload, stage, wire, overhead): the H100 spec point, the reference's
# TPU v5e point, an overhead-bound and a wire-bound point
POINTS = [(33.6e6, 3.35e12, 450e9, 2e-6), (4.2e6, 819e9, 50e9, 2e-6),
          (1e5, 1e12, 1e12, 1e-4), (2.7e8, 2e12, 25e9, 5e-7)]


def _params(mod, point, ring=2):
    payload, stage, wire, ovh = point
    return mod.PipeParams(payload_bytes=payload, stage_bw=stage, wire_bw=wire,
                          per_slice_overhead_s=ovh, ring_slots=ring)


@pytest.mark.parametrize("point,ring", itertools.product(POINTS, (2, 3)))
def test_planning_functions_match_the_reference(point, ring):
    p, jp = _params(pipesim, point, ring), _params(jpipesim, point, ring)
    for slice_bytes in (4096, 2 ** 16, 2 ** 20, 2 ** 24):
        assert pipesim.simulate(p, slice_bytes) == jpipesim.simulate(jp, slice_bytes)
        assert (pipesim.simulate_layer_stream(p, slice_bytes, 4)
                == jpipesim.simulate_layer_stream(jp, slice_bytes, 4))
    sizes = [4096, 65536, 2 ** 22]
    assert pipesim.sweep(p, sizes) == jpipesim.sweep(jp, sizes)
    assert pipesim.best_slice(p) == jpipesim.best_slice(jp)
    for max_slices in (None, 4):
        assert (pipesim.plan_slices(p, max_slices=max_slices)
                == jpipesim.plan_slices(jp, max_slices=max_slices))
        assert (pipesim.plan_layer_stream(p, 3, max_slices=max_slices)
                == jpipesim.plan_layer_stream(jp, 3, max_slices=max_slices))
    assert pipesim.plan_slices(p, 1e7) == jpipesim.plan_slices(jp, 1e7)
    for n, layers, k in ((1, 1, 1), (4, 3, 1), (8, 2, 2), (2, 16, 4)):
        assert (pipesim.simulate_interleaved_stream(p, n, layers, k)
                == jpipesim.simulate_interleaved_stream(jp, n, layers, k))
        for attn in (0.0, 1e-5, 3e-4):
            assert (pipesim.simulate_tx_stream(p, n, layers, attn, k)
                    == jpipesim.simulate_tx_stream(jp, n, layers, attn, k))
    for layers, k, attn in ((16, 1, 2.5e-5), (2, 2, 1e-6), (4, 1, 0.0)):
        assert (pipesim.plan_tx_stream(p, layers, k, attn)
                == jpipesim.plan_tx_stream(jp, layers, k, attn))
        assert (pipesim.plan_interleaved_stream(p, layers, max(k, 2))
                == jpipesim.plan_interleaved_stream(jp, layers, max(k, 2)))


def test_defaults_are_the_h100_spec_point():
    p = pipesim.PipeParams(payload_bytes=1.0)
    assert (p.stage_bw, p.wire_bw, p.per_slice_overhead_s) == (3.35e12, 450e9, 2e-6)
    cfg = DcommConfig()
    assert (cfg.pipe_slices, cfg.pipe_stage_bw, cfg.pipe_wire_bw,
            cfg.pipe_overhead_s) == (0, 3.35e12, 450e9, 2e-6)
    assert pipesim.params_from_dcomm(5.0, cfg) == dataclasses.replace(
        p, payload_bytes=5.0)


# (t, k, d, itemsize, n_experts, ep, factor): the serve and train prefills
# of qwen3-moe and the moe-tx prefill, and small shapes at EP 1 and 4
SHAPES = [(512, 8, 2048, 2, 128, 1, 2.0), (2048, 8, 2048, 2, 128, 1, 2.0),
          (4096, 4, 1024, 2, 64, 1, 2.0), (24, 2, 16, 4, 8, 1, 8.0),
          (12, 2, 16, 4, 8, 4, 2.0)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("point", POINTS[:2] + [(0, 1e9, 1e6, 1e-9)])
def test_pipe_geometry_matches_the_reference(shape, point):
    t, k, d, itemsize, n_e, ep, factor = shape
    _, stage, wire, ovh = point
    kw = dict(capacity_factor=factor, pipe_stage_bw=stage, pipe_wire_bw=wire,
              pipe_overhead_s=ovh)
    placement = ExpertPlacement(n_e, ep, max(1, ep // 2))
    jplacement = JPlacement(n_experts=n_e, ep=ep, node_size=max(1, ep // 2))
    for slices, layers, attn in ((0, 1, 0.0), (0, 16, 0.0), (0, 16, 2.5e-5),
                                 (3, 1, 0.0), (10 ** 6, 1, 0.0)):
        cfg = DcommConfig(engine="fused_pipe", pipe_slices=slices, **kw)
        jcfg = JDcommConfig(engine="fused_pipe", pipe_slices=slices, **kw)
        got = dcomm.pipe_geometry(t, k, d, itemsize, placement, cfg,
                                  n_layers=layers, attn_s=attn)
        want = jdcomm.pipe_geometry(t, k, d, itemsize, jplacement, jcfg,
                                    n_layers=layers, attn_s=attn)
        assert got == want, (slices, layers, attn)
        cap, s = got
        assert cap % s == 0 and 1 <= s <= cap


def test_calibrate_on_the_cpu_gives_clamped_constants_that_apply_threads():
    table = calibrate.calibrate(payload_bytes=1 << 16, repeats=2, device="cpu")
    assert table.platform == "cpu" and table.payload_bytes == 1 << 16
    for v, lo, hi in ((table.stage_bw, 1e6, 1e16), (table.wire_bw, 1e6, 1e16),
                      (table.overhead_s, 1e-9, 1e-1)):
        assert math.isfinite(v) and lo <= v <= hi
    assert table.wire_bw == pytest.approx(table.stage_bw / 4.0)
    assert set(table.as_dict()) == {"stage_bw", "wire_bw", "overhead_s",
                                    "platform", "payload_bytes"}
    cfg = calibrate.apply(table, DcommConfig(engine="fused_pipe", pipe_slices=3))
    assert (cfg.engine, cfg.pipe_slices, cfg.pipe_stage_bw, cfg.pipe_wire_bw,
            cfg.pipe_overhead_s) == ("fused_pipe", 3, table.stage_bw,
                                     table.wire_bw, table.overhead_s)
    ctx = lm.make_context(get_arch("moe-tx-stream").reduced(), "cpu",
                          engine="fused_pipe", moe_stream=2, pipe_slices=4,
                          calibration=table)
    assert ctx.moe_stream == 2 and ctx.dcfg == dataclasses.replace(
        cfg, pipe_slices=4, node_size=1)       # make_context's node of one lane
    assert calibrate._clamp(float("nan"), 1.0, 2.0) == 1.0
    assert calibrate._clamp(-3.0, 1.0, 2.0) == 1.0
    assert calibrate._clamp(5.0, 1.0, 2.0) == 2.0
