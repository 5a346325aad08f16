"""The full-width grid serve of ``chip_smoke.py`` through fused_flat and
fused_hier, each against the card alone, and the card alone's two engines
against each other.

    python3 tools/grid_serve_engines.py

Builds the kernels, then takes ``chip_smoke.GRID_SERVE`` (qwen3-moe-30b-a3b
at full width, 8 layers, FSDP of the experts by the reference's rule, the
continuous engine over 8 requests of 64 tokens) through each engine:
first on the card alone (each request's first-token logits from a prefill
of its row alone), printing the largest difference between the two
engines there, relative to max(1, |logit|) of the row (the same function,
the combine's bf16 roundings apart), and the smallest and largest
distance between two requests' logits; then ``chip_smoke.grid_card_check``
without its train cases on the (2, 2) grid of four gloo ranks sharing the
card, for each engine, printing its serving lines and kernel rows, or the
check that failed.  Four ranks through gloo: nothing here is a speed.
Needs one CUDA card.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ENGINES = ("fused_flat", "fused_hier")


def main() -> None:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        cs.fail("torch sees no CUDA device; this tool runs only on the GPU")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    _build.build_all()
    _build.build_all(cs.SPLIT_KERNELS, tuple((d,) for d in cs.SPLIT.values()))
    cs.stamp("build")
    one = {}
    for e in ENGINES:
        one[e] = cs.grid_serve_full("cuda", None, dict(cs.GRID_SERVE, engine=e)
                                    )["first_logits"].float()
        torch.cuda.empty_cache()
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max().clamp_min(1)).item()
    flat, hier = one["fused_flat"], one["fused_hier"]
    print("card alone, fused_flat against fused_hier, first-token logits per "
          "row:", [round(rel(a, b), 4) for a, b in zip(flat, hier)])
    cross = [rel(hier[i], hier[j]) for i in range(len(hier))
             for j in range(len(hier)) if i != j]
    print(f"card alone, fused_hier, one request's logits against another's: "
          f"{min(cross):.4g} to {max(cross):.4g}")
    cs.stamp("the card alone")
    for e in ENGINES:
        try:
            lines, _, rows = cs.grid_card_check(
                grids=((cs.GRID, ()),), serve=dict(cs.GRID_SERVE, engine=e))
        except AssertionError as err:
            print(f"{e}: FAILED {err}")
        else:
            for line in lines["serve"]:
                print(f"{e}: {line}")
            for r in rows:
                cs.print_row(r)
        cs.stamp(f"the grid through {e}")


if __name__ == "__main__":
    main()
