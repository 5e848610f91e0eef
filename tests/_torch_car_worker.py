"""Subprocess worker: the simulated car of the port's IO-bridge tests.

Creates the shm bridge (or binds the UDP ports), publishes states,
lockstep-consumes controls and integrates the nonlinear plant with the
port (``io.lockstep_car``) on the CPU. It imports the port only, never
JAX, so it also runs on a machine that has no JAX. Prints the result as one
JSON line.

Usage: python _torch_car_worker.py <bridge_name | stateport:ctrlport> <T> [shm|udp] [noise|clean] [oval|racetrack]
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import MPCConfig, VehicleParams  # noqa: E402
from autonomous_racing_lpv_mpp_mpc_tpu_torch.io import CarBridge, UDPBridge, lockstep_car  # noqa: E402
from autonomous_racing_lpv_mpp_mpc_tpu_torch.track import oval_track, racetrack  # noqa: E402

# tests/_car_worker.py's sensor noise and glitches, so that a seed gives the
# same published frames on both sides
NOISE_SIGMA = [0.03, 0.01, 0.02, 0.01, 0.02, 0.015]
NOISE_SEED = 7
X0 = [1.0, 0.0, 0.0, 0.0, 0.0, 0.1]


class GlitchBridge:
    """Camera-misdetection glitches on top of the car's frames: every 8th
    frame gets an alternating-sign jump on (e_psi, e_y)."""

    def __init__(self, inner):
        self._inner = inner
        self._k = 0

    def write_state(self, t, x):
        z = np.array(x, np.float32, copy=True)
        if self._k % 8 == 7:
            sgn = 1.0 if (self._k // 8) % 2 == 0 else -1.0
            z[5] += 0.5 * sgn
            z[3] -= 0.3 * sgn
        self._k += 1
        return self._inner.write_state(t, z)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __enter__(self):
        self._inner.__enter__()
        return self

    def __exit__(self, *a):
        return self._inner.__exit__(*a)


def main():
    name, T = sys.argv[1], int(sys.argv[2])
    transport = sys.argv[3] if len(sys.argv) > 3 else "shm"
    noisy = len(sys.argv) > 4 and sys.argv[4] == "noise"
    on = sys.argv[5] if len(sys.argv) > 5 else "oval"
    track = {"oval": oval_track, "racetrack": racetrack}[on](device="cpu")
    p, cfg = VehicleParams(), MPCConfig(N=10, model="dynamic")     # the plant reads dt, model, tyre
    kw = dict(noise_sigma=NOISE_SIGMA, noise_seed=NOISE_SEED, return_traj=True) if noisy else {}
    if transport == "udp":
        sp, cp = (int(v) for v in name.split(":"))
        with UDPBridge("car", state_port=sp, control_port=cp) as br:
            out = lockstep_car("", p, cfg, track, X0, T, bridge=br, timeout_s=300, **kw)
    else:
        br = GlitchBridge(CarBridge(name, create=True)) if noisy else None
        out = lockstep_car(name, p, cfg, track, X0, T, bridge=br, **kw)
    if noisy:
        print(json.dumps({"ey_rms_true": float(np.sqrt(np.mean(out[:, 5] ** 2))),
                          "ey_max_true": float(np.abs(out[:, 5]).max()),
                          "traj_true": np.asarray(out, np.float32).tolist(),
                          "x_final": [float(v) for v in out[-1]]}))
    else:
        print(json.dumps({"x_final": [float(v) for v in out]}))


if __name__ == "__main__":
    main()
