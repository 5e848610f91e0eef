"""The port's IO layer (``autonomous_racing_lpv_mpp_mpc_tpu_torch.io``) on the
CPU: the five tests of tests/test_io_bridge.py against the port's bridge
and real-time loop.

- the seqlock survives concurrent writes, and UDP keeps the newest frame;
- two-process hardware-in-the-loop: the car is ``tests/_torch_car_worker.py``
  (the port only, on the CPU) in a child process, the controller is the
  port's ``realtime_tracking_loop`` here; the final state and every control
  are held within 1e-3 of the JAX package's in-process ``closed_loop`` on
  the same inputs (tests/test_io_bridge.py's bound): the slice against the
  reference as a whole;
- the UDP lockstep loop reproduces the port's in-process ``closed_loop``
  within the same 1e-3;
- with a noisy, glitchy car the gated EKF's estimates beat the raw frames
  by 2x on the glitched channels and both runs track (the JAX test's
  checks). Tier-1 runs 60 frames; the JAX test's 120 frames are ``slow``.

Each test skips with the port's own reason when its bridge cannot be built.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_racing_lpv_mpp_mpc_tpu.core import MPCConfig as JMPCConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import SolverConfig as JSolverConfig
from autonomous_racing_lpv_mpp_mpc_tpu.core import VehicleParams as JVehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu.loop import closed_loop as jclosed_loop
from autonomous_racing_lpv_mpp_mpc_tpu.loop import constant_refs as jconstant_refs
from autonomous_racing_lpv_mpp_mpc_tpu.track import oval_track as joval

from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import MPCConfig, SolverConfig, VehicleParams
from autonomous_racing_lpv_mpp_mpc_tpu_torch.io import bridge_available
from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import closed_loop, constant_refs
from autonomous_racing_lpv_mpp_mpc_tpu_torch.track import oval_track
from tests._torch_car_worker import NOISE_SIGMA, X0

WORKER = os.path.join(os.path.dirname(__file__), "_torch_car_worker.py")
CFG = MPCConfig(N=10, model="dynamic")
SCFG = SolverConfig(max_iter=30, rho_interval=10)
TOL = dict(rtol=0, atol=1e-3)


@pytest.fixture(autouse=True)
def _bridge():
    if not bridge_available():
        pytest.skip("the port's native IO bridge (native/libiobridge.so) cannot be built")


def _cpu_track():
    return oval_track(device="cpu")


def _open(name, timeout_s=60.0):
    """Poll-open the shm segment that the child creates."""
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.io import BridgeUnavailable, CarBridge

    t_end = time.monotonic() + timeout_s
    while True:
        try:
            return CarBridge(name)
        except BridgeUnavailable:
            if time.monotonic() > t_end:
                raise
            time.sleep(0.05)


def _hil(name, T, extra, **loop_kw):
    """The car in a child process on the shm bridge ``name``, the port's
    real-time loop here; (child's JSON result, RealtimeLog)."""
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.io import realtime_tracking_loop

    child = subprocess.Popen([sys.executable, WORKER, name, str(T), *extra],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        br = _open(name)
        try:
            log = realtime_tracking_loop(VehicleParams(), CFG, SCFG, _cpu_track(),
                                         constant_refs(CFG, 1.5, device="cpu"), br, T, **loop_kw)
        finally:
            br.close()
        out, err = child.communicate(timeout=120)
        assert child.returncode == 0, err[-2000:]
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    return json.loads(out.strip().splitlines()[-1]), log


def test_seqlock_survives_concurrent_writes():
    """A writer thread spams frames whose 8 lanes all equal the frame
    number; a torn read would show as a non-uniform payload."""
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.io import CarBridge

    with CarBridge(f"/arl_torch_seqlock_{os.getpid()}", create=True) as w, \
            CarBridge(f"/arl_torch_seqlock_{os.getpid()}") as r:
        stop = threading.Event()

        def writer():
            k = 0
            while not stop.is_set():
                k += 1
                w.write_state(float(k), np.full(8, float(k), np.float32))

        th = threading.Thread(target=writer, daemon=True)
        th.start()
        reads = torn = last = 0
        t_end = time.monotonic() + 1.0
        while time.monotonic() < t_end:
            cnt, _t, x = r.read_state(8)
            if cnt <= 0:
                continue
            reads += 1
            torn += int(not np.all(x == x[0]))
            last = max(last, cnt)
        stop.set()
        th.join(timeout=2.0)
        assert not th.is_alive()
        assert reads > 100
        assert torn == 0, f"{torn}/{reads} torn reads"
        assert last > 100


def _free_udp_ports(n):
    """n UDP port numbers the system found free (bound to port 0, then
    released), so that concurrent runs of these tests do not meet."""
    socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM) for _ in range(n)]
    try:
        for s in socks:
            s.bind(("", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def test_udp_latest_frame_wins():
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.io import UDPLink

    rx_port, tx_port = _free_udp_ports(2)
    with UDPLink(rx_port) as rx, UDPLink(tx_port) as tx:
        # out-of-order counts: the drain keeps the newest frame
        for count, val in ((1, 10.0), (3, 30.0), (2, 20.0)):
            assert tx.send("127.0.0.1", rx_port, count, float(count), np.full(4, val, np.float32))
        time.sleep(0.05)
        cnt, t, data = rx.recv_latest(4)
        assert (cnt, t) == (3, 3.0)
        assert np.all(data == 30.0)
        assert rx.recv_latest(4)[0] == -1          # drained


def test_two_process_hardware_in_the_loop_matches_jax():
    """Lockstep over the shm bridge: every frame consumed exactly once, the
    car tracks, and the loop reproduces the JAX package's in-process
    closed loop on the same inputs."""
    T = 60
    res, log = _hil(f"/arl_torch_hil_{os.getpid()}", T, [])
    x_final = np.asarray(res["x_final"])
    assert np.array_equal(log.frame_counts, np.arange(1, T + 1))
    assert x_final[0] > 1.2
    assert float(np.mean(log.converged)) > 0.9
    assert log.solve_s.shape == (T,) and (log.solve_s > 0).all()

    jcfg = JMPCConfig(N=10, model="dynamic")
    ref = jclosed_loop(JVehicleParams(), jcfg, JSolverConfig(max_iter=30, rho_interval=10), joval(),
                       jnp.asarray(X0), jconstant_refs(jcfg, 1.5), T=T)
    np.testing.assert_allclose(x_final, np.asarray(ref.X[-1]), **TOL)
    np.testing.assert_allclose(log.U, np.asarray(ref.U), **TOL)


def test_udp_lockstep_loop_matches_shm_semantics():
    """The same loop and lockstep car over UDP (car thread, controller on
    this thread) reproduce the port's in-process closed loop."""
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.io import UDPBridge, lockstep_car, realtime_tracking_loop

    T = 40
    p, track = VehicleParams(), _cpu_track()
    x_ref = constant_refs(CFG, 1.5, device="cpu")
    sp, cp = _free_udp_ports(2)
    result = {}

    def car():
        with UDPBridge("car", state_port=sp, control_port=cp) as br:
            result["x_final"] = lockstep_car("", p, CFG, track, X0, T, bridge=br)

    th = threading.Thread(target=car, daemon=True)
    ctrl = UDPBridge("controller", state_port=sp, control_port=cp)
    th.start()
    try:
        log = realtime_tracking_loop(p, CFG, SCFG, track, x_ref, ctrl, T)
    finally:
        ctrl.close()
        th.join(timeout=60)
    assert not th.is_alive()
    assert np.array_equal(log.frame_counts, np.arange(1, T + 1))
    ref = closed_loop(p, CFG, SCFG, track, torch.tensor(X0), x_ref, T=T)
    np.testing.assert_allclose(result["x_final"], ref.X[-1].numpy(), **TOL)
    np.testing.assert_allclose(log.U, ref.U.numpy(), **TOL)


@pytest.mark.parametrize("T", [60, pytest.param(120, marks=pytest.mark.slow)])
def test_hil_noisy_sensors_ekf_beats_raw(T):
    """The lockstep car publishes noisy frames with a glitch on (e_psi, e_y)
    every 8th frame; the controller runs once on the raw frames and once
    with the gated EKF. Both track; the EKF's estimates beat the raw frames
    by 2x on the glitched channels against the car's true trajectory."""
    runs = {tag: _hil(f"/arl_torch_hiln_{tag}_{os.getpid()}", T, ["shm", "noise"], use_ekf=ekf,
                      ekf_r=np.asarray(NOISE_SIGMA) ** 2)
            for tag, ekf in (("raw", False), ("ekf", True))}
    for res, log in runs.values():
        assert np.array_equal(log.frame_counts, np.arange(1, T + 1))
        assert res["x_final"][0] > 1.2
        assert res["ey_rms_true"] < 0.12, res["ey_rms_true"]

    # X_est[k] estimates frame k's state, the true state after step k-1
    def est_rms(tag, i):
        res, log = runs[tag]
        truth = np.asarray(res["traj_true"], np.float32)[: T - 1, i]
        return np.sqrt(np.mean((log.X_est[1:, i] - truth) ** 2))

    for i in (3, 5):
        assert est_rms("ekf", i) < 0.5 * est_rms("raw", i), (i, est_rms("ekf", i), est_rms("raw", i))
