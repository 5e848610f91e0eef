"""Locate or build the native C-ABI shared libraries (the JAX package's
``utils/nativelib.py``; used by ``io/bridge.py``).

Resolution order:

1. the packaged copy (``autonomous_racing_lpv_mpp_mpc_tpu_torch/native/<lib>``,
   installed by setup.py's ``build_ext``), then
2. the source checkout (``<repo>/native/<lib>``), built there with
   ``make -C native <target>`` on first use when only the sources are
   present (a host C++ compiler; nothing is downloaded).

A library that can be neither found nor built raises
:class:`NativeLibUnavailable`: nothing falls back.
"""

from __future__ import annotations

import os
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG_NATIVE = os.path.join(_PKG_DIR, "native")
_SRC_NATIVE = os.path.join(os.path.dirname(_PKG_DIR), "native")


class NativeLibUnavailable(RuntimeError):
    pass


def find_native_lib(lib: str, make_target: str) -> str:
    """Return the path of shared library ``lib``, building it if needed."""
    packaged = os.path.join(_PKG_NATIVE, lib)
    if os.path.exists(packaged):
        return packaged
    src = os.path.join(_SRC_NATIVE, lib)
    if os.path.exists(src):
        return src
    if os.path.isdir(_SRC_NATIVE):
        try:
            subprocess.run(["make", "-C", _SRC_NATIVE, make_target],
                           check=True, capture_output=True, text=True)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            detail = getattr(e, "stderr", "") or ""
            raise NativeLibUnavailable(f"cannot build {lib}: {e} {detail[-2000:]}".rstrip()) from e
        if os.path.exists(src):
            return src
    raise NativeLibUnavailable(f"{lib} not found in {_PKG_NATIVE} or {_SRC_NATIVE}")
