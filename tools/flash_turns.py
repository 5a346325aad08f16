"""Time the flash forward of two checkouts in turns on one card.

    python3 tools/flash_turns.py OLD_CHECKOUT [--rounds N]

Builds ``src/repro_torch/csrc/flash_attention.cu`` of OLD_CHECKOUT and of
this checkout, then at each bf16 flash shape of ``chip_smoke.py``'s
full-width paths (``FLASH_SHAPES`` below: the large configs' group sizes 5,
6 and 7, and the group sizes that divide 64) calls both in rounds of OLD,
NEW, NEW, OLD.  OLD takes the entry its own wrapper would take:
``flash_attention_fwd``, or ``flash_attention_fwd_tc`` where that entry
refuses the shape (before the Hopper form took every group size).  NEW goes
through this checkout's wrapper, which is also held against its plain
version (``chip_smoke.hold_flash``).  Each time is ``chip_smoke.time_ms``'s
median of 5 rounds of device time.  Prints the card's name and power limit,
then one JSON line a shape: the entries, every turn's ms, the medians and
the largest out / lse difference between the two.  Compare the checkouts
only within one run of this.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# label -> (attention shape, window): chip_smoke.py's flash calls
FLASH_SHAPES = {
    "mixtral-8x22b serve prefill (G 6)": (
        dict(b=8, sq=512, sk=512, hq=48, hkv=8, hd=128), 4096),
    "deepseek-v3-bench serve prefill (G 7)": (
        dict(b=8, sq=512, sk=512, hq=56, hkv=8, hd=128), None),
    "mixtral-8x22b 5120-token prompt (G 6, window binding)": (
        dict(b=1, sq=5120, sk=5120, hq=48, hkv=8, hd=128), 4096),
    "mixtral-8x22b train forward (G 6)": (
        dict(b=4, sq=512, sk=512, hq=48, hkv=8, hd=128), None),
    "qwen3-14b serve prefill (G 5)": (
        dict(b=8, sq=512, sk=512, hq=40, hkv=8, hd=128), None),
    "moe-tx-stream-1b serve prefill (G 4)": (
        dict(b=8, sq=512, sk=512, hq=16, hkv=4, hd=64), None),
    "qwen3-moe-30b-a3b serve prefill (G 8)": (
        dict(b=8, sq=64, sk=64, hq=32, hkv=4, hd=128), None),
    "qwen3-1.7b serve prefill (G 2)": (
        dict(b=8, sq=512, sk=512, hq=16, hkv=8, hd=128), None),
    "qwen3-moe-30b-a3b train forward (G 8)": (
        dict(b=4, sq=512, sk=512, hq=32, hkv=4, hd=128), None),
}
REFUSED = 1     # cudaErrorInvalidValue: the entry does not take the shape


def old_library(checkout: Path) -> ctypes.CDLL:
    """The old checkout's flash library, compiled by this checkout's
    ``_build`` from the old sources (its own file name: the hash of those
    sources)."""
    from repro_torch.kernels import _build
    mine = _build.CSRC
    _build.CSRC = (checkout / "src" / "repro_torch" / "csrc").resolve()
    try:
        _build.build_all(("flash_attention",))
        return ctypes.CDLL(str(_build.library_path("flash_attention")))
    finally:
        _build.CSRC = mine


def old_call(lib: ctypes.CDLL, q, k, v, qp, kp, window):
    """A callable of the entry the old wrapper would take, and its name."""
    import torch
    from repro_torch.kernels import _build
    b, sq, hq, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
            kp.data_ptr(), out.data_ptr(), lse.data_ptr(), b, sq, k.shape[1],
            hq, k.shape[2], hd, _build.DTYPE_CODE[q.dtype], 1, window or 0,
            _build.stream_of(q))
    for name in ("flash_attention_fwd", "flash_attention_fwd_tc"):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = fn(*args)
        if err == REFUSED and name == "flash_attention_fwd":
            torch.cuda.synchronize()
            continue
        _build.check(err, f"old {name}")

        def call(fn=fn):
            _build.check(fn(*args), f"old {name}")
        return call, name, out, lse
    raise RuntimeError("the old checkout takes no bf16 flash call of this shape")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch
    if not torch.cuda.is_available():
        sys.exit("flash_turns: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    torch.cuda.set_device(0)
    print(cs.card_line(), flush=True)
    _build.build_all(("flash_attention",))
    lib = old_library(Path(args.old))
    for label, (shape, window) in FLASH_SHAPES.items():
        inp = cs.attention_inputs("cuda", **shape)
        cs.hold_flash(label, *inp, window)
        old, entry, o_old, l_old = old_call(lib, *inp, window)
        o_new, l_new = fa.flash_attention(*inp, True, window)
        new = lambda: fa.flash_attention(*inp, True, window)
        turns = {"old": [], "new": []}
        for _ in range(args.rounds):
            for who in ("old", "new", "new", "old"):
                turns[who].append(cs.time_ms(old if who == "old" else new))
        print(json.dumps({
            "label": label, "shape": shape, "window": window,
            "old_entry": entry,
            "new_form": "mma.sync" if fa.hopper_refusal(
                shape["hd"], shape["hq"], shape["hkv"], shape["sk"])
            else "wgmma",
            "old_ms": turns["old"], "new_ms": turns["new"],
            "old_median": statistics.median(turns["old"]),
            "new_median": statistics.median(turns["new"]),
            "out_diff": cs.max_err(o_new, o_old),
            "lse_diff": cs.max_err(l_new, l_old)}), flush=True)
        del inp, o_old, l_old, o_new, l_new
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
