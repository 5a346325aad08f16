"""Build and load the hand-written CUDA kernels in ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface.  ``nvcc`` compiles it for
``sm_90a`` into its own shared library under ``<repo>/build/kernels/``, named
after a hash of the sources and flags, so an edited source is rebuilt; the
library is loaded with ``ctypes``.  Nothing is built at import: a wrapper
builds its kernel at first use, and :func:`build_all` builds them all at once,
one ``nvcc`` per source running in parallel.  A failed build raises; nothing
falls back.  A variant built with extra ``-D`` defines (the time split of
``csrc/hopper.cuh``) is a library of its own, which :func:`use_variant` puts
behind the ordinary wrappers for a while.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("segment_gather", "segment_scatter_add", "fused_swiglu",
           "flash_attention", "grouped_matmul")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of csrc/common.cuh
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_LIBS: dict[tuple[str, tuple[str, ...]], ctypes.CDLL] = {}
_VARIANT: dict[str, tuple[str, ...]] = {}    # kernel -> defines now in use


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc, or
    ``nvcc`` on PATH."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def library_path(name: str, defines: tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256(" ".join((*FLAGS, *defines)).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    tag = "".join(f"-{d.removeprefix('-D').lower()}" for d in defines)
    return BUILD / f"lib{name}{tag}-{h.hexdigest()[:16]}.so"


def _start(name: str, defines: tuple[str, ...] = ()):
    so = library_path(name, defines)
    if so.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *FLAGS, *defines, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so


def _finish(name: str, job) -> str:
    proc, tmp, so = job
    log, _ = proc.communicate()
    so.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, so)
    return log


def build_all(names=KERNELS, variants=((),)) -> dict[str, str]:
    """Build every kernel library (each of ``names`` with each tuple of
    defines in ``variants``) that is not built yet, one ``nvcc`` per
    library, all started together.  Returns the compiler's output (register
    and shared-memory use from ``-Xptxas -v``) by library file name, or ''
    for a library that was already built."""
    jobs = {(name, v): _start(name, v) for v in variants for name in names}
    logs, errors = {}, []
    for (name, v), job in jobs.items():      # wait for every job, then raise
        try:
            logs[library_path(name, v).name] = (
                _finish(name, job) if job is not None else "")
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (of the variant in use, see
    :func:`use_variant`), built first if needed."""
    key = (name, _VARIANT.get(name, ()))
    lib = _LIBS.get(key)
    if lib is None:
        job = _start(*key)
        if job is not None:
            _finish(name, job)
        lib = _LIBS[key] = ctypes.CDLL(str(library_path(*key)))
    return lib


@contextlib.contextmanager
def use_variant(name: str, *defines: str):
    """Within the block, kernel ``name``'s wrapper launches its library built
    with ``defines`` (such as ``-DREPRO_LOADS_ONLY``, which computes garbage
    and serves only to time a kernel's loads)."""
    before = _VARIANT.get(name, ())
    _VARIANT[name] = tuple(defines)
    try:
        yield
    finally:
        _VARIANT[name] = before


def bind(name: str, fn: str, n_ptr: int, n_int: int):
    """C entry ``fn`` of kernel ``name`` taking ``n_ptr`` pointers, then
    ``n_int`` ints, then the stream; returns a cudaError_t code."""
    f = getattr(load(name), fn)
    if f.argtypes is None:
        f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                      + [ctypes.c_void_p])
        f.restype = ctypes.c_int
    return f


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


TENSOR_MAP_ERROR = -1   # csrc/hopper.cuh: kErrTensorMap


def check(err: int, what: str) -> None:
    if err == TENSOR_MAP_ERROR:
        raise RuntimeError(f"{what}: a TMA tensor map could not be encoded "
                           "(base, stride or extent refused)")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    """The kernels take CUDA tensors on one device, contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: needs CUDA tensors on one device, got "
                             f"{[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: needs contiguous tensors")
