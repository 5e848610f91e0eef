"""The port's checkpointed sweep and log records (``parallel.scenarios.
checkpointed_sweep``, ``utils.record``) on the CPU.

- Kill and resume at world size 1 (a one-rank gloo group through a
  FileStore in tmp_path): the final metrics equal an uninterrupted run's
  bit for bit, as tests/test_checkpointed_sweep.py asserts for JAX, and a
  call on a finished directory runs nothing; the running sums equal the
  metrics of ``closed_loop``'s log of the same lanes (rtol 1e-6), and the
  metrics equal JAX's ``checkpointed_sweep`` on the same grid within the
  closed-loop parity bound (2e-4).
- ``checkpointed_race_sweep`` (the racestep's plain version): killed and
  resumed equals uninterrupted (tests/test_racestep.py::
  test_checkpointed_race_sweep_kill_and_resume), and its sums equal
  ``mega_race_sweep``'s log of the same seed (rtol 1e-6).
- ``save_log`` / ``load_log``: a log saved by either package reads back in
  the other under the same keys, bit for bit.
- ``SweepCheckpoint``: one file per rank per step, ``latest_step`` counts
  only a step that every rank wrote, ``keep=3``, restore onto a template.
- ``slow``: kill and resume under two spawned ranks equals an uninterrupted
  two-rank run bit for bit (tests/test_multiprocess.py::
  test_two_process_ckpt_resume).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_dist_worker as W
import autonomous_racing_lpv_mpp_mpc_tpu.core as jcore
import autonomous_racing_lpv_mpp_mpc_tpu.parallel as jparallel
import autonomous_racing_lpv_mpp_mpc_tpu.parallel.scenarios as jscen
from autonomous_racing_lpv_mpp_mpc_tpu.loop import constant_refs as jconstant_refs
from autonomous_racing_lpv_mpp_mpc_tpu.track import oval_track as joval_track
from autonomous_racing_lpv_mpp_mpc_tpu.utils.record import load_log as jload_log
from autonomous_racing_lpv_mpp_mpc_tpu.utils.record import save_log as jsave_log

from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import MPCConfig, SolverConfig, VehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import (
    ClosedLoopLog, checkpointed_race_sweep, closed_loop, constant_refs, initial_table, mega_race_sweep,
)
from autonomous_racing_lpv_mpp_mpc_tpu_torch.parallel import make_mesh, make_scenario_grid
from autonomous_racing_lpv_mpp_mpc_tpu_torch.parallel.scenarios import checkpointed_sweep
from autonomous_racing_lpv_mpp_mpc_tpu_torch.track import oval_track, racetrack
from autonomous_racing_lpv_mpp_mpc_tpu_torch.utils.record import SweepCheckpoint, load_log, save_log

CPU = "cpu"


@pytest.fixture
def group1(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    yield
    dist.destroy_process_group()


def test_kill_and_resume_equals_uninterrupted(tmp_path, group1):
    mesh = make_mesh(device=CPU)
    scen = make_scenario_grid(VehicleParams(), W.CK_CFG, n_ey=8, n_mu=1, vx0=1.0, device=CPU)
    args = (mesh, scen, W.CK_CFG, W.CK_SCFG, oval_track(device=CPU), constant_refs(W.CK_CFG, 1.4, device=CPU))
    T, K = 12, 4
    m_ref, steps = checkpointed_sweep(*args, T, checkpoint_dir=str(tmp_path / "ref"), save_every=K)
    assert steps == T
    # "killed" after two chunks, then resumed: only the last chunk runs
    _, steps = checkpointed_sweep(*args, 2 * K, checkpoint_dir=str(tmp_path / "kill"), save_every=K)
    assert steps == 2 * K
    m_res, steps = checkpointed_sweep(*args, T, checkpoint_dir=str(tmp_path / "kill"), save_every=K)
    assert steps == T - 2 * K
    assert all(torch.equal(a, b) for a, b in zip(m_res, m_ref))
    assert float(m_ref.converged_frac) > 0.9
    m_again, steps = checkpointed_sweep(*args, T, checkpoint_dir=str(tmp_path / "kill"), save_every=K)
    assert steps == 0 and all(torch.equal(a, b) for a, b in zip(m_again, m_ref))
    with pytest.raises(ValueError, match="multiple of save_every"):
        checkpointed_sweep(*args, T + 1, checkpoint_dir=str(tmp_path / "bad"), save_every=K)

    # the running sums against the closed loop's log of the same lanes
    log = closed_loop(scen.params, W.CK_CFG, W.CK_SCFG, args[4], scen.x0, args[5], T)
    X, conv, iters = (np.asarray(a, np.float64) for a in (log.X, log.converged, log.iters))
    host = [8.0, np.sqrt((X[..., 5] ** 2).mean(axis=0)).mean(), conv.mean(), iters.mean(), X[-1, :, 4].mean()]
    np.testing.assert_allclose([float(v) for v in m_ref], host, rtol=1e-6)

    # and against JAX's checkpointed_sweep on the same grid (its metrics
    # have no noise) on a one-device mesh, within the closed-loop parity
    # bound 2e-4
    j_scen = jscen.make_scenario_grid(jcore.VehicleParams(), jcore.MPCConfig(N=8, model="dynamic"),
                                      n_ey=8, n_mu=1, vx0=1.0)
    j_cfg, j_scfg = jcore.MPCConfig(N=8, model="dynamic"), jcore.SolverConfig(max_iter=15, rho_interval=0)
    m_jax, steps = jscen.checkpointed_sweep(jparallel.make_mesh(1), j_scen, j_cfg, j_scfg, joval_track(),
                                            jconstant_refs(j_cfg, 1.4), T, checkpoint_dir=str(tmp_path / "jax"),
                                            save_every=T)
    assert steps == T
    for name in m_ref._fields:
        np.testing.assert_allclose(float(getattr(m_ref, name)), float(getattr(m_jax, name)), atol=2e-4, err_msg=name)


def test_checkpointed_race_sweep_kill_and_resume(tmp_path):
    cfg = MPCConfig(N=8, tire="pacejka")
    scfg = SolverConfig(max_iter=20, rho_interval=0, early_exit=True, check_termination=2)
    track = racetrack(device=CPU)
    x0 = torch.zeros((4, 6))
    x0[:, 0] = 1.2
    x0[:, 4] = torch.tensor([0.0, 3.0, 6.0, 9.0])
    mu = torch.linspace(0.6, 1.1, 4)
    kw = dict(T=12, mu_true_b=mu, save_every=4, mu0=0.8, noise_sigma=(0.03, 0.01, 0.02, 0.01, 0.02, 0.01), seed=4)
    args = (VehicleParams(), cfg, scfg, track, initial_table(track, ds=0.05, vx0=1.2), x0)
    m_ref, n = checkpointed_race_sweep(*args, checkpoint_dir=str(tmp_path / "ref"), **kw)
    assert n == 12
    assert checkpointed_race_sweep(*args, checkpoint_dir=str(tmp_path / "kill"), **dict(kw, T=8))[1] == 8
    m_res, n = checkpointed_race_sweep(*args, checkpoint_dir=str(tmp_path / "kill"), **kw)
    assert n == 4 and m_res == m_ref and m_ref["converged_frac"] > 0.9
    # the chunks continue one noise stream and one carry: mega_race_sweep's
    log = mega_race_sweep(*args, 12, mu, mu0=0.8, noise_sigma=kw["noise_sigma"], seed=4)
    Xf = log.Xf.double()
    np.testing.assert_allclose([m_ref["converged_frac"], m_ref["ey_rms"], m_ref["mean_progress"]],
                               [log.converged.double().mean().item(),
                                Xf[..., 5].pow(2).mean(dim=1).sqrt().mean().item(), Xf[:, -1, 4].mean().item()],
                               rtol=1e-6)


def test_logs_read_back_across_packages(tmp_path):
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((5, 3, 6)).astype(np.float32), rng.standard_normal((5, 3, 2)).astype(np.float32)]
    flags = [rng.random((5, 3)) > 0.5] + [rng.standard_normal((5, 3)).astype(np.float32) for _ in range(4)]
    log = ClosedLoopLog(*(torch.tensor(a) for a in arrays + flags))
    tree = {"log": log, "mu": [torch.tensor(rng.standard_normal(3).astype(np.float32))]}
    save_log(str(tmp_path / "port.npz"), tree, meta={"T": 5})
    assert json.loads((tmp_path / "port.npz.meta.json").read_text()) == {"T": 5}
    jtree = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)
    jsave_log(str(tmp_path / "jax.npz"), jtree)
    ours, theirs = load_log(str(tmp_path / "jax.npz")), jload_log(str(tmp_path / "port.npz"))
    assert sorted(ours) == sorted(theirs) and "['log']/.X" in ours and "['mu']/[0]" in ours
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_sweep_checkpoint_counts_complete_steps_and_keeps_three(tmp_path):
    state = {"xs": torch.arange(6.0).reshape(2, 3), "acc": {"conv": torch.zeros(2)}}
    r0 = SweepCheckpoint(str(tmp_path), rank=0, world_size=2)
    r1 = SweepCheckpoint(str(tmp_path), rank=1, world_size=2)
    assert r0.latest_step() is None and r0.restore(state) == (None, None)
    for k in range(1, 6):
        nbytes, seconds = r0.save(k, {"xs": state["xs"] + k, "acc": {"conv": state["acc"]["conv"] - k}})
        assert nbytes > 0 and seconds >= 0.0
        if k < 5:
            r1.save(k, state)
    assert r0.latest_step() == 4 and r1.latest_step() == 4      # rank 1 never wrote step 5
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_2", "step_3", "step_4", "step_5"]
    assert sorted(p.name for p in (tmp_path / "step_5").iterdir()) == ["rank0.pt"]
    assert not (tmp_path / "step_2" / "rank0.pt").exists()     # rank 0 keeps its three newest
    step, got = r0.restore(state)
    assert step == 4 and torch.equal(got["xs"], state["xs"] + 4)
    assert torch.equal(got["acc"]["conv"], state["acc"]["conv"] - 4)


@pytest.mark.slow
def test_two_rank_kill_and_resume(tmp_path):
    def run(name, T):
        out = tmp_path / f"out_{name}_{T}"
        out.mkdir()
        W.spawn(W.ckpt_rank, 2, str(out / "store"), str(out), str(tmp_path / name), T, 4)
        res = [torch.load(out / f"rank{r}.pt") for r in range(2)]
        assert all(torch.equal(a, b) for a, b in zip(res[0]["metrics"], res[1]["metrics"]))
        return res[0]["steps"], res[0]["metrics"]

    steps, m_ref = run("ref", 12)
    assert steps == 12 and float(m_ref[0]) == 8.0
    assert run("kill", 8)[0] == 8
    steps, m_res = run("kill", 12)
    assert steps == 4 and all(torch.equal(a, b) for a, b in zip(m_res, m_ref))
    assert float(m_ref[2]) > 0.9
