"""Build and load the hand-written CUDA kernels in ``ops/csrc``.

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` per ``.cu`` file, all started together, and linked into one shared
library with a plain C interface, loaded with ``ctypes``. The build happens
at first use, into ``<package>/_build/``, under a name that carries the
hash of the sources, so an edited source rebuilds and an unchanged one
loads the existing library. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..utils import profiling

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def build() -> Path:
    """Compile the kernels if the library for the current sources is
    missing; returns its path. The compilers' log (registers, spills) is
    written beside it as ``.log``."""
    lib = BUILD_DIR / f"libarl_kernels_{source_hash()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                                text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out, err = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) on {cmd[-1]}:\n{err[-4000:]}")
    tmp = lib.with_name(f"{tag}.tmp")
    if not failed:
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp)]
        link += [str(obj) for _, obj, _ in jobs]
        res = subprocess.run(link, capture_output=True, text=True)
        log.append(" ".join(link) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(f"link failed ({res.returncode}):\n{res.stderr[-4000:]}")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    lib.with_suffix(".log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("\n".join(failed))
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the CUDA kernels cannot run")
    lib = ctypes.CDLL(str(build()))
    sig = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
           ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    for name in ("arl_admm_solve", "arl_megastep", "arl_racestep", "arl_fused_solve"):
        fn = getattr(lib, name)
        fn.argtypes = sig
        fn.restype = ctypes.c_int
    lib.arl_cluster_fits.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int]
    lib.arl_cluster_fits.restype = ctypes.c_int
    return lib


# Set by ``utils.debug.enable_nan_debugging``. A launch through ``launch``
# bypasses the dispatcher, so that mode's per-op check never sees what a
# kernel wrote: while this is on, each wrapper checks its kernel's outputs
# right after the launch (``check_outputs``).
CHECK_OUTPUTS = False


def check_outputs(name: str, *tensors) -> None:
    """With NaN debugging on, raise ``FloatingPointError`` naming the kernel
    when one of its outputs holds a non-finite value (one host read per
    output); otherwise do nothing."""
    if not CHECK_OUTPUTS:
        return
    for i, t in enumerate(tensors):
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"{name}: output {i} of the kernel holds a non-finite value")


def launch(name: str, tensors, floats, ints, counters=(), trace=None) -> None:
    """Call the C entry ``name`` with device pointers, float and int
    parameters on the current stream; raise if the launch failed. A None
    in ``tensors`` (an optional operand left out) is a null pointer.
    ``counters``: int64 counter arrays (or None) whose pointers follow the
    operands' (the section counters). ``trace``: whether a profiler records
    (``utils.profiling.tracing()``, read here when None); then the argument
    marshalling and the call sit in the span ``cuda.launch.<name>``."""
    lib = library()
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: operands on {dev}; the kernels take CUDA tensors")
    for t in tensors:
        if t is not None and (t.device != dev or t.dtype != torch.float32 or not t.is_contiguous()):
            raise ValueError(f"{name}: every operand must be a contiguous float32 tensor on {dev}")
    for t in counters:
        if t is not None and (t.device != dev or t.dtype != torch.int64 or not t.is_contiguous()):
            raise ValueError(f"{name}: every counter array must be a contiguous int64 tensor on {dev}")
    with profiling.span(f"cuda.launch.{name}", profiling.tracing() if trace is None else trace):
        ops = list(tensors) + list(counters)
        ptrs = (ctypes.c_void_p * len(ops))(*(None if t is None else t.data_ptr() for t in ops))
        fv = (ctypes.c_float * len(floats))(*floats)
        iv = (ctypes.c_int * len(ints))(*ints)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, name)(ptrs, len(ops), fv, len(floats), iv, len(ints),
                                dev.index if dev.index is not None else torch.cuda.current_device(),
                                ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed with code {rc}"
                           + (" (operand count mismatch)" if rc < 0 else " (cudaError_t)"))
