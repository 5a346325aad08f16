"""Time the port's full-width train runs of two checkouts in turns on one card.

    python3 tools/train_turns.py OLD_CHECKOUT NEW_CHECKOUT [--rounds N]

Each round runs OLD, NEW, NEW, OLD.  A turn is one process that imports
``repro_torch`` from its checkout's ``src`` and runs ``launch/train.run`` on
the card for each full-width train configuration of ``chip_smoke.py`` (this
checkout's ``TRAINS`` and ``TX_TRAINS``), one after another.  Prints a JSON
line for each turn and configuration (median ms per timed step, every
step's ms, peak GiB, losses), then for each configuration and checkout the
turns' medians, with the card's name and power limit.  Host clocks drift
between calls, so compare the two checkouts only within one run of this.
Needs one CUDA card; exits with another code than 0 if a turn fails.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

TURN = """
import json, sys
sys.path.insert(0, sys.argv[1] + "/src")
import torch
from repro_torch.kernels import _build
from repro_torch.launch import train
torch.backends.cuda.matmul.allow_tf32 = False
_build.build_all()
for label, argv in json.loads(sys.argv[2]).items():
    out = train.run(train.parse_args(argv), "cuda")
    print(json.dumps({"label": label, "ms_per_step": out["ms_per_step"],
                      "step_ms": out["step_ms"],
                      "peak_mem_gib": out["peak_mem_gib"],
                      "losses": out["losses"]}), flush=True)
    del out
    torch.cuda.empty_cache()
"""


def configs() -> dict:
    """Label -> train flags: ``chip_smoke.py``'s full-width train phases."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return {**chip_smoke.TRAINS, **chip_smoke.TX_TRAINS}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    trains = json.dumps(configs())
    seen: dict[tuple[str, str], list[float]] = {}
    for _ in range(args.rounds):
        for tag in ("old", "new", "new", "old"):
            tree = str(Path(getattr(args, tag)).resolve())
            run = subprocess.run([sys.executable, "-c", TURN, tree, trains],
                                 capture_output=True, text=True, timeout=900)
            if run.returncode:
                sys.exit(f"{tag} turn ({tree}) exited {run.returncode}:\n"
                         f"{run.stderr[-4000:]}")
            for line in run.stdout.splitlines():
                if not line.startswith("{"):
                    continue
                r = json.loads(line)
                print(json.dumps({"checkout": tag, **r}), flush=True)
                seen.setdefault((r["label"], tag), []).append(
                    r["ms_per_step"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(json.dumps({"median_ms_per_step": {
        f"{label} {tag}": {"median": statistics.median(v), "turns": v}
        for (label, tag), v in sorted(seen.items())}}))


if __name__ == "__main__":
    main()
