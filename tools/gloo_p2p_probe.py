"""Whether gloo's point-to-point ``send`` / ``recv`` carries a CUDA tensor:
two spawned ranks on ``cuda:0`` in one gloo group, rank 0 sending 4 MiB of
f32 to rank 1.

    python3 tools/gloo_p2p_probe.py

Prints each rank's exit code and what it recorded (the values arrived, or
the exception it raised); a rank that aborts records nothing.  The
pipeline's ring hop (``repro_torch/parallel/pipeline.py``) uses
``all_to_all_single`` instead, which gloo carries on CUDA tensors.  Needs
one CUDA card.
"""

from __future__ import annotations

import datetime
import multiprocessing
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 30


def _rank(rank: int, port: int, out_dir: str) -> None:
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    res = {}
    try:
        x = torch.arange(1 << 20, device="cuda", dtype=torch.float32) + rank
        try:
            if rank == 0:
                dist.send(x, 1)
                res["sent"] = True
            else:
                y = torch.empty_like(x)
                dist.recv(y, 0)
                res["values_arrived"] = bool(torch.equal(y, x - 1))
        except RuntimeError as e:      # what the probe is for: recorded
            res["error"] = f"{type(e).__name__}: {e}"[:400]
        torch.save(res, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def main() -> None:
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        sys.exit("gloo_p2p_probe: needs a CUDA card")
    out_dir = tempfile.mkdtemp(dir=ROOT / "build") if (ROOT / "build").is_dir() \
        else tempfile.mkdtemp()
    try:
        mp = multiprocessing.get_context("spawn")
        port = cs.free_port()
        ranks = [mp.Process(target=_rank, args=(r, port, out_dir))
                 for r in range(2)]
        for p in ranks:
            p.start()
        for p in ranks:
            p.join(timeout=3 * TIMEOUT_S)
        for p in ranks:
            if p.is_alive():
                p.kill()
                p.join()
        for r, p in enumerate(ranks):
            f = Path(out_dir) / f"rank{r}.pt"
            got = torch.load(f) if f.exists() else "nothing recorded"
            print(f"rank {r}: exit code {p.exitcode}; {got}")
        print(cs.card_line())
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
