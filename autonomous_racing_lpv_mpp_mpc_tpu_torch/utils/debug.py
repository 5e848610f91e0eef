"""Numerical-safety tools (the JAX package's ``utils/debug.py``; SURVEY.md §5
"Race detection / sanitizers").

- :func:`enable_nan_debugging`: fail fast at the op that produced the first
  non-finite value (the counterpart of ``jax_debug_nans`` /
  ``jax_debug_infs``).
- :func:`checked_closed_loop`: the closed loop with the finite-state and
  on-track checks; returns ``(error, log)``, and ``error.throw()`` raises
  with the first failed check's message.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..core.config import MPCConfig, SolverConfig, VehicleParams
from ..loop.closed_loop import closed_loop
from ..ops import _cuda
from ..track.track import Track

_aten = torch.ops.aten
# factories whose output is uninitialised memory until something writes it
_UNINITIALISED = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
                  _aten.new_empty_strided, _aten.resize_, _aten.set_}


def _finite(values) -> bool:
    """Every floating tensor and Python float among ``values`` is finite."""
    for v in values:
        if isinstance(v, torch.Tensor):
            if v.is_floating_point() and v.numel() and not bool(torch.isfinite(v).all()):
                return False
        elif isinstance(v, float) and not math.isfinite(v):
            return False
    return True


class _NanCheckMode(TorchDispatchMode):
    """Raise ``FloatingPointError`` at the first op whose output holds a NaN
    or an inf while all of its inputs were finite, naming the op."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.overloadpacket in _UNINITIALISED or _finite(tree_flatten(out)[0]):
            return out
        if _finite(tree_flatten((args, kwargs))[0]):
            raise FloatingPointError(f"{func} produced a non-finite value from finite inputs")
        return out


_MODE: Optional[_NanCheckMode] = None


def enable_nan_debugging(enable: bool = True) -> None:
    """Switch NaN/inf debugging on (or off with ``enable=False``).

    While it is on:

    - every PyTorch op run by the thread that switched it on is checked: an
      op whose output holds a NaN or an inf although all its inputs (tensors
      and Python floats) were finite raises ``FloatingPointError`` naming
      the op. An op that receives a non-finite value passes it on: the
      solvers carry +-inf as "no bound" in their box rows, and an inf/inf
      of two such rows is a NaN the solver discards by construction. (JAX's
      ``jax_debug_infs`` raises on any inf output.) The check reads each
      op's output back, so a CUDA op costs a device sync.
    - the hand-written kernels, which ``ops._cuda.launch`` starts without
      going through the dispatcher, are checked by their wrappers right
      after the launch, in any thread: a non-finite kernel output raises
      ``FloatingPointError`` naming the kernel.

    The op check is a ``TorchDispatchMode``; PyTorch keeps those per
    thread, so switch it off from the thread that switched it on.
    """
    global _MODE
    if enable and _MODE is None:
        _MODE = _NanCheckMode()
        _MODE.__enter__()
    elif not enable and _MODE is not None:
        mode, _MODE = _MODE, None
        mode.__exit__(None, None, None)
    _cuda.CHECK_OUTPUTS = enable


class CheckError:
    """The outcome of :func:`checked_closed_loop`'s checks (the JAX
    package's ``checkify.Error``): ``get()`` is the first failed check's
    message or None, ``throw()`` raises ``RuntimeError`` with it and does
    nothing on a sane run."""

    def __init__(self, message: Optional[str] = None):
        self.message = message

    def get(self) -> Optional[str]:
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise RuntimeError(self.message)


def checked_closed_loop(
    p: VehicleParams,
    cfg: MPCConfig,
    scfg: SolverConfig,
    track: Track,
    x0: torch.Tensor,
    x_ref,
    T: int,
    ey_limit: Optional[float] = None,
    **kw,
):
    """``loop.closed_loop`` with the JAX package's two checks on its states:
    every state finite, and |e_y| below ``ey_limit`` (default 5 x the track
    width). Returns ``(CheckError, log)``. The checks are reduced on the
    device and read back once, after the loop."""
    ey_i = 5 if cfg.model == "dynamic" else 3
    log = closed_loop(p, cfg, scfg, track, x0, x_ref, T, **kw)
    X = log.X
    limit = (torch.as_tensor(ey_limit, dtype=X.dtype, device=X.device) if ey_limit is not None
             else 5.0 * track.width.to(X))
    finite, ey_max, lim = torch.stack([torch.isfinite(X).all().to(X.dtype),
                                       X[..., ey_i].abs().max(), limit]).tolist()
    if not finite:
        return CheckError("non-finite state in closed loop"), log
    if not ey_max < lim:
        return CheckError(f"vehicle left the track neighborhood (|e_y| exceeded {lim})"), log
    return CheckError(), log
