"""Real-time tracking loop over the IO bridge: the deployment shape (the JAX
package's ``io/realtime.py``).

The reference's real-car loop (SURVEY.md §3.1, 30 Hz: estimate -> solve ->
apply) with the ROS layer replaced by the native shared-memory or UDP
bridge. The controller process holds the warm-started single-car MPC
(``loop.mpc.mpc_step`` on the caller's ``SolverConfig``: ``backend="fused"``
launches the fused kernel at B=1 on CUDA tensors, CPU tensors take its
plain version); the car process (real hardware, or the lockstep plant
simulator below) publishes states and consumes controls. Tensors live on
the track's device: the card by default, the CPU where the caller built the
track there.

Two timing modes:

- free-running (a real car): the controller waits for a fresh state
  frame, solves, publishes; the car integrates continuously.
  A solve whose wall time exceeds the deadline counts as a miss.
- lockstep (:func:`lockstep_car`): the car blocks until the control frame
  that answers its state frame arrives before it integrates, so a
  hardware-in-the-loop run is deterministic and can be held against the
  in-process closed loop.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.config import MPCConfig, SolverConfig, VehicleParams
from ..models import model_nx
from ..track.track import Track
from .bridge import CarBridge, monotonic

NU = 2


class RealtimeLog(NamedTuple):
    X: np.ndarray            # (T, nx) states as received (raw frames)
    U: np.ndarray            # (T, nu) controls as published
    solve_s: np.ndarray      # (T,) per-frame solve wall time, the read of u included
    missed: np.ndarray       # (T,) solve exceeded the deadline
    frame_counts: np.ndarray  # (T,) state frame numbers consumed
    converged: np.ndarray    # (T,)
    X_est: np.ndarray = None  # (T, nx) states fed to the MPC (== X when use_ekf=False)


class _GraphedFilter:
    """One EKF step replayed from a CUDA graph (the JAX loop jits its
    filter): a replay costs the step's kernels on the device instead of the
    ~10^3 eager launches of its forward-mode Jacobian. Captured from
    ``filt(ekf, u, z)`` at the given example operands, which it copies into
    its static inputs; each call copies the operands in, replays, and
    returns copies of the outputs."""

    def __init__(self, filt, ekf, u, z):
        self._in = [t.clone() for t in (ekf.x, ekf.P, u, z)]
        run = lambda: filt(type(ekf)(self._in[0], self._in[1]), self._in[2], self._in[3])
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):      # first calls: library handles, workspaces
            for _ in range(2):
                run()
        cur.wait_stream(side)
        self._graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self._graph):
            self._out = run()

    def __call__(self, ekf, u, z):
        for dst, src in zip(self._in, (ekf.x, ekf.P, u, z)):
            dst.copy_(src)
        self._graph.replay()
        return type(ekf)(*(t.clone() for t in self._out))


def _wait_frame(bridge, nx: int, newer_than: int, timeout_s: float, poll_s: float, what: str):
    """Poll ``bridge`` until a state frame newer than ``newer_than``."""
    t_end = monotonic() + timeout_s
    while True:
        cnt, t_frame, x_np = bridge.read_state(nx)
        if cnt > newer_than:
            return cnt, t_frame, x_np
        if monotonic() > t_end:
            raise TimeoutError(what)
        time.sleep(poll_s)


def realtime_tracking_loop(
    p: VehicleParams,
    cfg: MPCConfig,
    scfg: SolverConfig,
    track: Track,
    x_ref,
    bridge: CarBridge,
    T: int,
    deadline_s: Optional[float] = None,
    timeout_s: float = 30.0,
    poll_s: float = 2e-4,
    use_ekf: bool = False,
    ekf_q=None,              # (nx,) process-noise variance per state
    ekf_r=None,              # (nx,) measurement-noise variance per state
    ekf_gate_sigma: float = 3.0,   # innovation gate (sensor-glitch reject)
) -> RealtimeLog:
    """Run ``T`` control frames against a car publishing on ``bridge``.

    Per frame: poll until a state frame newer than the last one consumed
    appears, solve the warm-started MPC on the track's device, publish the
    control stamped with the consumed frame's time. ``x_ref`` ((N+1, nx) or
    a ``RefTable``) lies on the track's device. Before the first frame one
    step is solved and its carry discarded, so that building or loading the
    kernel library and the solver's constants never lands in a frame's
    ``solve_s`` and frame 0 still solves from the pristine warm start.

    ``use_ekf=True`` filters each received frame through the EKF
    (``loop.estimator.ekf_step``, same device; on the card replayed from a
    CUDA graph captured during the warm-up) before the solve: raw sensor
    frames are not the estimate. ``ekf_r`` should match the car's sensor
    noise; ``ekf_q`` defaults to ``DEFAULT_EKF_Q`` for the dynamic model and
    1e-3 per state for the kinematic one, ``ekf_r`` to 1e-4 per state.
    """
    from ..loop.estimator import DEFAULT_EKF_Q, ekf_init, ekf_step
    from ..loop.mpc import mpc_init, mpc_step

    dev = track.kappa.device
    f32 = dict(dtype=torch.float32, device=dev)
    nx = model_nx(cfg.model)
    deadline = float(deadline_s if deadline_s is not None else cfg.dt)
    if ekf_q is None:
        ekf_q = np.asarray(DEFAULT_EKF_Q) if nx == 6 else np.full(nx, 1e-3)
    if ekf_r is None:
        ekf_r = np.full(nx, 1e-4)
    Qn = torch.diag(torch.as_tensor(np.asarray(ekf_q, np.float32), **f32))
    Rn = torch.diag(torch.as_tensor(np.asarray(ekf_r, np.float32), **f32))

    def step(x, carry):
        u, carry2, diag = mpc_step(p, cfg, scfg, track, x, x_ref, carry)
        return u, carry2, diag.converged

    def filt(ekf, u_prev, z):      # one car: the filter's batch of one
        return ekf_step(p, cfg, track, ekf, u_prev[None], z[None], Qn, Rn, gate_sigma=ekf_gate_sigma)

    _, _, x_np = _wait_frame(bridge, nx, 0, timeout_s, poll_s, "no state frame from the car")
    x_first = torch.as_tensor(x_np, **f32)
    carry = mpc_init(p, cfg, track, x_first)
    ekf = ekf_init(x_first[None])
    u_prev = torch.zeros(NU, **f32)
    # warm-up: one solve (and one filter step) whose results are discarded;
    # on the card the filter is captured in a CUDA graph here
    u, _carry_warm, _ = step(x_first, carry)
    u.cpu()
    if use_ekf:
        if dev.type == "cuda":
            filt = _GraphedFilter(filt, ekf, u_prev, x_first)
        filt(ekf, u_prev, x_first).x.cpu()

    X = np.zeros((T, nx), np.float32)
    X_est = np.zeros((T, nx), np.float32)
    U = np.zeros((T, NU), np.float32)
    solve_s = np.zeros(T, np.float32)
    missed = np.zeros(T, bool)
    counts = np.zeros(T, np.int64)
    conv = np.zeros(T, bool)

    last = 0
    for k in range(T):
        cnt, t_frame, x_np = _wait_frame(bridge, nx, last, timeout_s, poll_s,
                                         f"car stopped publishing at frame {k}")
        last = cnt

        t0 = monotonic()
        x_in = torch.as_tensor(x_np, **f32)
        if use_ekf:
            ekf = filt(ekf, u_prev, x_in)
            x_in = ekf.x[0]
        u, carry, ok = step(x_in, carry)
        u_np = u.cpu().numpy()
        u_prev = u
        dt_solve = monotonic() - t0

        bridge.write_control(t_frame, u_np)
        X[k], U[k] = x_np, u_np
        X_est[k] = x_in.cpu().numpy()
        solve_s[k] = dt_solve
        missed[k] = dt_solve > deadline
        counts[k] = cnt
        conv[k] = bool(ok)
    return RealtimeLog(X, U, solve_s, missed, counts, conv, X_est)


def lockstep_car(
    bridge_name: str,
    p: VehicleParams,
    cfg: MPCConfig,
    track: Track,
    x0,
    T: int,
    sim_tire: Optional[str] = None,
    timeout_s: float = 60.0,
    poll_s: float = 2e-4,
    bridge=None,
    noise_sigma=None,
    noise_seed: int = 0,
    return_traj: bool = False,
) -> np.ndarray:
    """Plant-simulator car process: creates the bridge, publishes state
    frame k, blocks until control frame k arrives, integrates
    (``loop.closed_loop.plant_step`` on the track's device), repeats.
    Returns the final state. Run it in a process of its own (it owns the
    shm segment); the controller side runs :func:`realtime_tracking_loop`.
    ``bridge`` (e.g. a car-role :class:`.bridge.UDPBridge`) replaces the
    default shm segment named ``bridge_name``.

    ``noise_sigma`` ((nx,) per-state sigma) simulates real sensors: the
    published frame is the true state plus Gaussian noise from
    ``np.random.default_rng(noise_seed)`` (the JAX package's stream, so a
    seed publishes the same noise on both sides) while the plant integrates
    the true state. ``return_traj=True`` returns the (T, nx) true
    trajectory instead of the final state.
    """
    from ..loop.closed_loop import plant_step

    dev = track.kappa.device

    def step(x, u):
        return plant_step(p, cfg, track, x[None], u[None], sim_tire=sim_tire)[0]

    x = torch.as_tensor(np.asarray(x0, np.float32), dtype=torch.float32, device=dev)
    step(x, torch.zeros(NU, dtype=torch.float32, device=dev)).cpu()     # warm-up, discarded
    rng = np.random.default_rng(noise_seed)
    traj = []

    def published(x_true):
        z = np.asarray(x_true, np.float32)
        if noise_sigma is not None:
            z = z + (rng.standard_normal(z.shape) * np.asarray(noise_sigma)).astype(np.float32)
        return z

    with (bridge if bridge is not None else CarBridge(bridge_name, create=True)) as br:
        for k in range(T):
            br.write_state(monotonic(), published(x.cpu().numpy()))
            t_end = monotonic() + timeout_s
            while True:
                cnt, _t, u_np = br.read_control(NU)
                if cnt > k:
                    break
                if monotonic() > t_end:
                    raise TimeoutError(f"no control for frame {k + 1}")
                time.sleep(poll_s)
            x = step(x, torch.as_tensor(u_np, dtype=torch.float32, device=dev))
            if return_traj:
                traj.append(x.cpu().numpy())
        x_final = x.cpu().numpy()
        # hold the final frame so that the controller's last read never
        # races the segment's teardown
        br.write_state(monotonic(), published(x_final))
        time.sleep(0.2)
    return np.stack(traj) if return_traj else x_final
