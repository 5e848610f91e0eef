"""ctypes bindings for the native C++ QP core (``native/osqp_core.cpp``).

The port's copy of the JAX package's ``oracle/native.py``: the same C ABI,
loaded through the port's own ``utils/nativelib.py`` (the packaged
library, else ``make -C native libosqpcore.so`` in a source checkout; a
host C++ compiler, nothing downloaded). The API mirrors
:func:`osqp_ref_solve`.

In the port it is an independent second implementation of the oracle,
for cross-checks only. It is not a fallback: nothing calls it when the
numpy oracle fails, and when the library can be neither found nor built,
:class:`NativeUnavailable` is raised instead of taking numpy.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from ..utils.nativelib import NativeLibUnavailable, find_native_lib
from .osqp_ref import OsqpRefResult, OsqpRefSettings

_lib = None


class NativeUnavailable(RuntimeError):
    pass


def _load():
    global _lib
    if _lib is not None:
        return _lib
    try:
        path = find_native_lib("libosqpcore.so", "libosqpcore.so")
    except NativeLibUnavailable as e:
        raise NativeUnavailable(str(e)) from e
    lib = ctypes.CDLL(path)
    d = ctypes.POINTER(ctypes.c_double)
    lib.osqp_core_solve.restype = ctypes.c_int
    lib.osqp_core_solve.argtypes = [
        ctypes.c_int, ctypes.c_int, d, d, d, d, d,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_double,
        d, d, d, ctypes.POINTER(ctypes.c_int), d,
    ]
    _lib = lib
    return lib


def native_available() -> bool:
    try:
        _load()
        return True
    except NativeUnavailable:
        return False


def osqp_native_solve(
    P: np.ndarray,
    q: np.ndarray,
    A: np.ndarray,
    l: np.ndarray,
    u: np.ndarray,
    settings: Optional[OsqpRefSettings] = None,
) -> OsqpRefResult:
    """Solve min 1/2 x'Px + q'x s.t. l <= Ax <= u with the C++ core."""
    lib = _load()
    s = settings or OsqpRefSettings()
    P = np.ascontiguousarray(P, dtype=np.float64)
    q = np.ascontiguousarray(q, dtype=np.float64)
    A = np.ascontiguousarray(A, dtype=np.float64)
    # the C core clips with fmin/fmax, which propagate inf
    l = np.ascontiguousarray(l, dtype=np.float64)
    u = np.ascontiguousarray(u, dtype=np.float64)
    n, m = P.shape[0], A.shape[0]
    x = np.zeros(n)
    y = np.zeros(m)
    z = np.zeros(m)
    iters = ctypes.c_int(0)
    res = np.zeros(2)
    d = ctypes.POINTER(ctypes.c_double)
    as_p = lambda a: a.ctypes.data_as(d)
    rc = lib.osqp_core_solve(
        n, m, as_p(P), as_p(q), as_p(A), as_p(l), as_p(u),
        s.rho, s.sigma, s.alpha, s.max_iter, s.eps_abs, s.eps_rel,
        s.adaptive_rho_interval if s.adaptive_rho else 0, s.rho_eq_scale,
        as_p(x), as_p(y), as_p(z), ctypes.byref(iters), as_p(res),
    )
    if rc == -1:
        raise RuntimeError("native LDL^T factorization failed")
    obj = 0.5 * x @ P @ x + q @ x
    return OsqpRefResult(
        x=x, y=y, z=z, iters=int(iters.value),
        r_prim=float(res[0]), r_dual=float(res[1]),
        converged=(rc == 0), obj=float(obj),
    )
