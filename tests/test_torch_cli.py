"""The experiment command line of the port (``cli.py``, ``bench/presets.py``) and
what its presets need beside the kernels (``utils.metrics.lap_stats``,
``loop.friction.adaptive_closed_loop``, ``closed_loop(log_predictions=)``,
``utils.plotting``), against the JAX package's on the CPU.

Tolerances: the closed loops 2e-4 (tests/test_torch_closed_loop.py's);
the config1 preset's rounded fields within 1e-3, its converged share equal.
"""

import dataclasses
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_racing_lpv_mpp_mpc_tpu.bench.presets import PRESETS as JPRESETS
from autonomous_racing_lpv_mpp_mpc_tpu.bench.presets import run_preset as jrun_preset
from autonomous_racing_lpv_mpp_mpc_tpu.cli import _split_overrides as j_split_overrides
from autonomous_racing_lpv_mpp_mpc_tpu.core import MPCConfig as JMPCConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import SolverConfig as JSolverConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import VehicleParams as JVehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu.loop import closed_loop as jclosed_loop
from autonomous_racing_lpv_mpp_mpc_tpu.loop import constant_refs as jconstant_refs
from autonomous_racing_lpv_mpp_mpc_tpu.loop.closed_loop import ClosedLoopLog as JClosedLoopLog
from autonomous_racing_lpv_mpp_mpc_tpu.loop.friction import adaptive_closed_loop as jadaptive
from autonomous_racing_lpv_mpp_mpc_tpu.track import racetrack as jrace
from autonomous_racing_lpv_mpp_mpc_tpu.utils.metrics import lap_stats as jlap_stats

from autonomous_racing_lpv_mpp_mpc_tpu_torch import cli, convert
from autonomous_racing_lpv_mpp_mpc_tpu_torch.bench import PRESETS, run_preset
from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import MPCConfig, SolverConfig, VehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import (
    ClosedLoopLogPred, adaptive_closed_loop, closed_loop, constant_refs,
)
from autonomous_racing_lpv_mpp_mpc_tpu_torch.track import racetrack
from autonomous_racing_lpv_mpp_mpc_tpu_torch.utils import lap_stats


def test_lap_stats_matches_jax():
    """One seeded log crossing the line twice: every field equal."""
    rng = np.random.default_rng(0)
    T, L = 300, 7.5
    X = np.zeros((T, 6), np.float32)
    X[:, 0] = 1.5 + 0.1 * rng.standard_normal(T)
    X[:, 4] = np.cumsum(np.full(T, 0.06, np.float32))
    X[:, 5] = 0.05 * rng.standard_normal(T)
    conv = rng.random(T) > 0.1
    iters = rng.integers(3, 20, T).astype(np.float32)
    z = np.zeros(T, np.float32)
    cfg = MPCConfig(N=20)
    j = jlap_stats(JMPCConfig(N=20), JClosedLoopLog(X, X[:, :2], conv, iters, z, z), L, vx_ref=1.5)
    t = lambda a: torch.tensor(a)
    port = lap_stats(cfg, ClosedLoopLogPred(t(X), t(X[:, :2]), t(conv), t(iters), t(z), t(z), t(z), t(z)),
                     L, vx_ref=1.5)
    assert j.n_laps == port.n_laps == 2
    for f in dataclasses.fields(j):
        np.testing.assert_allclose(getattr(port, f.name), getattr(j, f.name), rtol=1e-6, err_msg=f.name)


@pytest.mark.parametrize("adapt", [True, False])
def test_adaptive_closed_loop_matches_jax(adapt):
    """20 steps with the plant at mu 0.5 and the controller from mu 1.0,
    both arms: states, controls and the estimate within 2e-4."""
    jcfg = JMPCConfig(N=8, model="dynamic", tire="pacejka")
    jscfg = JSolverConfig(max_iter=40, rho_interval=0)
    x0 = np.array([1.2, 0.0, 0.0, 0.0, 0.0, 0.0], np.float32)
    jlog = jadaptive(JVehicleParams(), jcfg, jscfg, jrace(), jnp.asarray(x0), jconstant_refs(jcfg, 2.6), T=20,
                     mu_true=0.5, mu0=1.0, n_sub=4, adapt=adapt)
    cfg = convert.mpc_config(jcfg)
    log = adaptive_closed_loop(VehicleParams(), cfg, convert.solver_config(jscfg).replace(certify_infeasibility=False),
                               racetrack(device="cpu"), torch.tensor(x0), constant_refs(cfg, 2.6, device="cpu"),
                               T=20, mu_true=0.5, mu0=1.0, n_sub=4, adapt=adapt)
    for name in ("X", "U", "mu_hat"):
        np.testing.assert_allclose(getattr(log, name).numpy(), np.asarray(getattr(jlog, name)), atol=2e-4,
                                   rtol=0, err_msg=name)
    np.testing.assert_array_equal(log.converged.numpy(), np.asarray(jlog.converged))
    assert abs(float(log.mu_hat[-1]) - 1.0) > 1e-3          # the estimator moved in both arms
    with pytest.raises(ValueError, match="dynamic model"):
        adaptive_closed_loop(VehicleParams(), MPCConfig(N=8, model="kinematic"), SolverConfig(),
                             racetrack(device="cpu"), torch.zeros(4), constant_refs(cfg, 2.6, device="cpu"),
                             T=1, mu_true=0.5)


def test_closed_loop_log_predictions_matches_jax():
    """One car's log with each step's prediction: the JAX package's single
    car form (no batch dim), X_pred (T, N+1, nx) within 2e-4."""
    jp, jcfg, jt = JVehicleParams(), JMPCConfig(N=8), jrace()
    jscfg = JSolverConfig(max_iter=20, rho_interval=0)
    x0 = np.array([1.2, 0.0, 0.0, 0.0, 2.0, 0.08], np.float32)
    jlog = jclosed_loop(jp, jcfg, jscfg, jt, jnp.asarray(x0), jconstant_refs(jcfg, 1.6), T=3, n_sub=4,
                        log_predictions=True)
    cfg = convert.mpc_config(jcfg)
    log = closed_loop(VehicleParams(), cfg, convert.solver_config(jscfg).replace(certify_infeasibility=False),
                      convert.track(jt, device="cpu"), torch.tensor(x0), constant_refs(cfg, 1.6, device="cpu"),
                      T=3, n_sub=4, log_predictions=True)
    assert isinstance(log, ClosedLoopLogPred) and tuple(log.X_pred.shape) == (3, 9, 6)
    for name in ("X", "U", "X_pred"):
        np.testing.assert_allclose(getattr(log, name).numpy(), np.asarray(getattr(jlog, name)), atol=2e-4,
                                   rtol=0, err_msg=name)


def _cli(capsys, *argv):
    assert cli.main(list(argv)) == 0
    return capsys.readouterr().out


def test_cli_list_names_the_jax_presets(capsys):
    out = _cli(capsys, "list")
    names = [line.split(":")[0] for line in out.strip().splitlines()]
    assert names == sorted(JPRESETS) == sorted(PRESETS)
    assert len(names) == 12
    assert "python -m autonomous_racing_lpv_mpp_mpc_tpu_torch" in _cli(capsys, "help")


def test_cli_run_config1_matches_jax(capsys, tmp_path):
    """BASELINE config 1 through the CLI on the CPU against the JAX
    package's preset; save= writes the same dict."""
    save = tmp_path / "config1.json"
    out = _cli(capsys, "run", "config1", "T=60", "max_iter=30", "device=cpu", f"save={save}")
    res = json.loads(out)
    j = jrun_preset("config1", scfg=JSolverConfig(max_iter=30), T=60)
    assert res["preset"] == "config1" and set(res) == {"preset", *j}
    for k in ("ey_rms_m", "ey_max_m", "vx_mean"):
        assert abs(res[k] - j[k]) <= 1e-3, (k, res[k], j[k])
    assert res["converged_frac"] == j["converged_frac"] and res["laps"] == j["laps"]
    assert json.loads(save.read_text()) == res


def test_cli_override_routing():
    """Keys split as the JAX package's _split_overrides does: SolverConfig
    fields first (``backend`` among them, even where a preset has its own
    backend knob), then VehicleParams fields, then the preset; a JAX
    backend name becomes the port's."""
    pairs = ["max_iter=80", "backend=xla", "mu=0.7", "T=900", "device=cpu", "plot=a.png", "eps_abs=1e-3"]
    s_kw, v_kw, rest = cli._split_overrides(pairs)
    js, jv, jr = j_split_overrides(pairs)
    assert (set(s_kw), set(v_kw), set(rest)) == (set(js), set(jv), set(jr))
    assert s_kw == {"max_iter": 80, "backend": "plain", "eps_abs": 1e-3}
    assert v_kw == {"mu": 0.7} and rest == {"T": 900, "device": "cpu", "plot": "a.png"}
    assert cli._split_overrides(["backend=pallas"])[0] == {"backend": "admm"}
    assert cli._split_overrides(["backend=fused"])[0] == {"backend": "fused"}
    # the hazard: run race backend=mega sets the solver's backend, not the preset's
    s_kw, _, rest = cli._split_overrides(["backend=mega", "mode=learn"])
    assert s_kw == {"backend": "mega"} and rest == {"mode": "learn"}
    with pytest.raises(SystemExit):
        cli._split_overrides(["T900"])


def test_presets_refuse_what_they_do_not_run():
    """config5 runs at world size 1 (a one-rank group of its own, ended
    with the call) and reports no scaling efficiency there; an unknown knob
    warns; an unknown preset or race backend raises; no device means the
    card."""
    r = run_preset("config5", device="cpu", per_device=16, T=5)
    assert r["devices"] == 1 and r["batch"] == 16 and r["converged_frac"] > 0.9
    assert "scaling_efficiency" not in r
    assert not torch.distributed.is_initialized()
    with pytest.raises(KeyError, match="unknown preset"):
        run_preset("config9")
    with pytest.warns(UserWarning, match=r"ignoring unknown knobs: \['mutrue'\]"):
        with pytest.raises(ValueError, match="backend 'pallas'"):
            run_preset("race", device="cpu", backend="pallas", mutrue=0.5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_preset("config1", T=1)


def test_cli_plot_writes_a_file(capsys, tmp_path):
    pytest.importorskip("matplotlib")
    path = tmp_path / "run.png"
    res = json.loads(_cli(capsys, "run", "config1", "T=12", "device=cpu", f"plot={path}"))
    assert res["converged_frac"] > 0.9 and path.stat().st_size > 10_000
