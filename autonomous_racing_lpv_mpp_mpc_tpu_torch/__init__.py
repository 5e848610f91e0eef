"""PyTorch / CUDA port of the LPV-MPC autonomous-racing engine.

The JAX package ``autonomous_racing_lpv_mpp_mpc_tpu`` is the reference; this
package mirrors its layout and names module by module, so each function has
an obvious counterpart:

- ``core``     — frozen dataclass configs (vehicle, MPC, solver).
- ``track``    — track compiler, curvature lookup, Frenet transforms.
- ``models``   — tires, Frenet bicycle ODEs, LPV model, discretization.
- ``engine``   — horizon scheduling and block-structured QP assembly.
- ``solver``   — Riccati factor/solve, batched OSQP-semantics ADMM and
                 its production pipeline (equilibrate, polish, certificate).
- ``loop``     — receding-horizon controller, closed loop, EKF, MHE,
                 friction RLS, the world-frame loop and the composed race
                 loop.
- ``planner``  — the MPP planner, online replanning (serial, and
                 pipelined with the planner on a second CUDA stream or
                 card), reference tables and opponents.
- ``parallel`` — scenario grids and sweeps over a rank mesh
                 (``torch.distributed``: one rank per card), the
                 collectives, the horizon-sharded Riccati and ADMM.
- ``io``       — the native shared-memory / UDP bridge to a car
                 (``native/io_bridge.cpp`` over ctypes) and the 30 Hz
                 real-time tracking loop over it.
- ``utils``    — lap statistics, plots, log records and sweep
                 checkpoints; ``timed`` / ``trace_to``, the stage
                 spans and the kernels' section counters (profiling)
                 and ``enable_nan_debugging`` / ``checked_closed_loop``
                 (numerical safety).
- ``ops``      — hand-written CUDA kernels (``ops/csrc``) with their plain
                 PyTorch versions beside them.
- ``oracle``   — the CPU numpy OSQP-semantics oracle (ground truth, dense
                 float64 on the host) and its stacker, with the native C++
                 core's binding for cross-checks.
- ``convert``  — hand JAX-package objects (as numpy arrays) to the port and
                 carries back.

Everything is float32. Where JAX ``vmap``s, the batch is a written-out
dimension; where JAX ``lax.scan``s, this package loops in Python or runs a
kernel; where JAX ``shard_map``s over a device mesh, each rank of a
process group runs its shard. The package imports ``torch``, numpy and,
for the oracle, scipy only.
"""

import torch as _torch

__version__ = "0.1.0"

# A reduced-precision (TF32 / bf16) product makes the Riccati/ADMM solve
# converge to a u0 that is wrong in the third digit while its residuals
# still report convergence; every product in this package is true f32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
