"""Wheel packaging for the native tier (ROADMAP "wheel/build packaging").

The two C++ shared libraries (`native/libosqpcore.so`, the host QP core,
and `native/libiobridge.so`, the real-car IO bridge) are plain C-ABI
libraries loaded via ctypes — NOT Python extension modules — so the build
compiles them with the platform compiler and ships them as package data
under `autonomous_racing_lpv_mpp_mpc_tpu/native/` and, for the PyTorch
port, `autonomous_racing_lpv_mpp_mpc_tpu_torch/native/`. The ctypes
loaders (`oracle/native.py`, both packages' `io/bridge.py`) look in the
packaged location first and fall back to building from `native/` in a
source checkout.

Build: `python setup.py build_ext --inplace` or any PEP 517 frontend.
"""

import os
import shutil
import subprocess

from setuptools import setup
from setuptools.command.build_ext import build_ext as _build_ext
from setuptools.extension import Extension

HERE = os.path.dirname(os.path.abspath(__file__))
NATIVE = os.path.join(HERE, "native")
PKG_NATIVES = [os.path.join(HERE, pkg, "native") for pkg in (
    "autonomous_racing_lpv_mpp_mpc_tpu", "autonomous_racing_lpv_mpp_mpc_tpu_torch")]

LIBS = {
    "libosqpcore.so": (["osqp_core.cpp"], []),
    "libiobridge.so": (["io_bridge.cpp"], ["-lrt"]),
}


class BuildNativeLibs(_build_ext):
    """Compile the C-ABI shared libraries with g++ (no Python headers
    needed) and drop them into the package tree."""

    def run(self):
        cxx = os.environ.get("CXX", "g++")
        cxxflags = os.environ.get(
            "CXXFLAGS", "-O3 -march=native -fPIC -std=c++17 -Wall").split()
        for pkg_native in PKG_NATIVES:
            os.makedirs(pkg_native, exist_ok=True)
        for lib, (sources, extra_link) in LIBS.items():
            srcs = [os.path.join(NATIVE, s) for s in sources]
            out = os.path.join(NATIVE, lib)
            if not self._up_to_date(out, srcs):
                cmd = [cxx, *cxxflags, "-shared", "-o", out, *srcs,
                       *extra_link]
                print(" ".join(cmd))
                subprocess.run(cmd, check=True)
            for pkg_native in PKG_NATIVES:
                shutil.copy2(out, os.path.join(pkg_native, lib))
        # an __init__ makes each dir a package so package_data applies
        for pkg_native in PKG_NATIVES:
            init = os.path.join(pkg_native, "__init__.py")
            if not os.path.exists(init):
                open(init, "w").close()

    @staticmethod
    def _up_to_date(out, srcs):
        if not os.path.exists(out):
            return False
        mt = os.path.getmtime(out)
        return all(os.path.getmtime(s) <= mt for s in srcs)


setup(
    # a dummy Extension forces bdist_wheel to tag the wheel platform-specific
    ext_modules=[Extension("autonomous_racing_lpv_mpp_mpc_tpu._native_marker",
                           sources=[])],
    cmdclass={"build_ext": BuildNativeLibs},
    package_data={
        "autonomous_racing_lpv_mpp_mpc_tpu.native": ["*.so"],
        "autonomous_racing_lpv_mpp_mpc_tpu_torch.native": ["*.so"],
    },
)
