"""The ssm and hybrid grid phases of ``chip_smoke.py`` alone: hymba's flash
rows at the island's shard shapes and the mamba2 / hymba grid checks.

    python3 tools/ssm_grid_phases.py

Builds the kernels, prints the card's name and power limit, holds and times
the flash forward at ``chip_smoke.HYMBA_GRID_ATTN`` (``ssm_grid_flash_rows``),
then runs ``ssm_grid_want`` on the card alone and ``ssm_grid_rank`` on four
gloo ranks sharing the card (the (2, 2) and (1, 4) grids of
``SSM_GRID_SHAPES``) and prints ``ssm_grid_check``'s lines and rank 0's
launches, or the check that failed: the same phases as ``chip_smoke.py``'s
grid spawn, in ~90 s of command time instead of the whole script's.  Four
ranks through gloo: nothing of the grid is a speed.  Needs one CUDA card.
"""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def rank_main(rank, port, out_dir, device, spec):
    """One rank: both grids of ``SSM_GRID_SHAPES`` on the world of four."""
    import torch.distributed as dist
    import chip_smoke as cs
    from repro_torch.launch.mesh import make_host_mesh
    first = cs._grid_init(rank, port, device)
    try:
        meshes = {cs.GRID: first, (1, 4): make_host_mesh(1, 4)}
        cs.ssm_grid_rank(rank, out_dir, device, meshes, spec)
    finally:
        dist.destroy_process_group()


def main() -> None:
    import torch
    import chip_smoke as cs
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        cs.fail("torch sees no CUDA device; this tool runs only on the GPU")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:   # every nvcc started together
        split = ex.submit(_build.build_all, cs.SPLIT_KERNELS,
                          tuple((d,) for d in cs.SPLIT.values()))
        _build.build_all()
        split.result()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    print(cs.card_line(), flush=True)
    with torch.no_grad():
        for r in cs.ssm_grid_flash_rows():
            cs.print_row(r)
    cs.stamp("the flash rows")
    out_dir = ROOT / "build" / "grid"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    want = cs.ssm_grid_want(cs.SSM_GRID, "cuda")
    cs.stamp("the card alone's side")
    torch.cuda.empty_cache()
    cs.spawn_ranks(rank_main, 4, (cs.free_port(), str(out_dir), "cuda",
                                  cs.SSM_GRID), 900)
    cs.stamp("the spawn of four")
    lines, launches = cs.ssm_grid_check(out_dir, cs.SSM_GRID, want)
    for line in lines:
        print(line)
    print(json.dumps(launches))
    shutil.rmtree(out_dir, ignore_errors=True)
    cs.stamp("the check")


if __name__ == "__main__":
    main()
