"""The port's profiling and numerical-safety tools and its last two exports,
on the CPU: ``utils.timed`` / ``trace_to``,
``utils.enable_nan_debugging``, ``utils.checked_closed_loop`` (as
tests/test_profiling.py and tests/test_utils.py:101 hold the JAX package's),
``engine.aug_dim`` against JAX's and ``loop.passthrough``."""

import json
import math
import os

import numpy as np
import pytest
import torch

from autonomous_racing_lpv_mpp_mpc_tpu.engine import aug_dim as jaug_dim

from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import MPCConfig, MPCWeights, SolverConfig, VehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu_torch.engine import aug_dim
from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import closed_loop, constant_refs, mpc_init, mpc_step, passthrough
from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import _cuda
from autonomous_racing_lpv_mpp_mpc_tpu_torch.track import oval_track
from autonomous_racing_lpv_mpp_mpc_tpu_torch.utils import (
    checked_closed_loop, enable_nan_debugging, timed, trace_to,
)

P = VehicleParams()
CFG = MPCConfig(N=10, model="kinematic", weights=MPCWeights.for_model("kinematic"))
SCFG = SolverConfig(max_iter=40)


def test_timed_returns_positive_wall_and_result():
    x = torch.ones((128, 128))
    secs, out = timed(lambda a: (a @ a).sum(), x, warmup=1, iters=2)
    assert secs > 0
    assert float(out) == 128 * 128 * 128


def test_trace_to_writes_a_trace(tmp_path):
    x = torch.ones((64, 64))
    with trace_to(str(tmp_path)) as tr:
        (x @ x).sum()
    assert tr.path is not None and os.path.dirname(tr.path) == str(tmp_path)
    assert os.path.getsize(tr.path) > 0
    with open(tr.path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names


def test_nan_debugging_raises_at_the_first_non_finite_op():
    x = torch.tensor([-1.0, 4.0])
    enable_nan_debugging()
    try:
        assert _cuda.CHECK_OUTPUTS
        # +-inf given as data (the solvers' open box rows) passes silently
        lb = torch.full((2,), -math.inf)
        assert torch.equal(torch.clamp(x, lb, -lb), x)
        # a whole controller step, its bounds and certificate included
        track = oval_track(device="cpu")
        x0 = torch.tensor([0.5, 0.0, 0.0, 0.05])
        u, _, diag = mpc_step(P, CFG, SCFG, track, x0, constant_refs(CFG, 1.5, device="cpu"),
                              mpc_init(P, CFG, track, x0))
        assert bool(torch.isfinite(u).all())
        with pytest.raises(FloatingPointError, match="sqrt"):
            torch.sqrt(x)
        with pytest.raises(FloatingPointError, match="div"):
            x / torch.zeros(2)
        # a kernel's outputs, which the dispatcher never sees, are checked
        # by its wrapper
        with pytest.raises(FloatingPointError, match="arl_fused_solve"):
            _cuda.check_outputs("arl_fused_solve", torch.zeros(3), torch.tensor([0.0, math.nan]))
    finally:
        enable_nan_debugging(False)
    assert not _cuda.CHECK_OUTPUTS
    assert bool(torch.isnan(torch.sqrt(x)[0]))       # off: nothing raises
    _cuda.check_outputs("arl_fused_solve", torch.tensor([math.nan]))


def test_checked_closed_loop_flags_bad_state():
    track = oval_track(device="cpu")
    x0 = torch.tensor([0.5, 0.0, 0.0, 0.0])
    ref = constant_refs(CFG, 1.2, device="cpu")
    err, log = checked_closed_loop(P, CFG, SCFG, track, x0, ref, T=30)
    err.throw()                                   # sane run: no error
    assert err.get() is None
    plain = closed_loop(P, CFG, SCFG, track, x0, ref, T=30)
    for a, b in zip(log, plain):
        assert torch.equal(a, b)
    # an absurd start far off the track trips the e_y check
    err_bad, _ = checked_closed_loop(P, CFG, SCFG, track, torch.tensor([0.5, 0.0, 0.0, 25.0]), ref, T=30,
                                     ey_limit=1.0)
    with pytest.raises(RuntimeError, match="left the track"):
        err_bad.throw()


@pytest.mark.parametrize("model", ["dynamic", "kinematic"])
def test_aug_dim_matches_jax(model):
    assert aug_dim(model) == jaug_dim(model) == (6 if model == "dynamic" else 4) + 2


def test_passthrough_is_the_identity():
    x = torch.from_numpy(np.arange(6, dtype=np.float32))
    assert passthrough(x) is x
