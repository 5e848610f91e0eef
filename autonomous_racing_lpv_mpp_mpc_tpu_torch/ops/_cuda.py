"""Build and load the hand-written CUDA kernels in ``ops/csrc``.

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded with ``ctypes``. The build
happens at first use, into ``<package>/_build/``, under a name that carries
the hash of the sources, so an edited source rebuilds and an unchanged one
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


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
    missing; returns its path. The compiler's log (registers, spills) is
    written beside it as ``.log``."""
    lib = BUILD_DIR / f"libarl_kernels_{source_hash()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp)] + [str(p) for p in _sources() if p.suffix == ".cu"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    lib.with_suffix(".log").write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}")
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
    for name in ("arl_admm_solve", "arl_megastep"):
        fn = getattr(lib, name)
        fn.argtypes = sig
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, tensors, floats, ints) -> None:
    """Call the C entry ``name`` with device pointers, float and int
    parameters on the current stream; raise if the launch failed."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: every operand must be a contiguous float32 tensor on {dev}")
    ptrs = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    fv = (ctypes.c_float * len(floats))(*floats)
    iv = (ctypes.c_int * len(ints))(*ints)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(library(), name)(ptrs, len(tensors), fv, len(floats), iv, len(ints),
                                  dev.index if dev.index is not None else torch.cuda.current_device(),
                                  ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed with code {rc}"
                           + (" (operand count mismatch)" if rc < 0 else " (cudaError_t)"))
