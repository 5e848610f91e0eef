#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``ops/csrc`` with nvcc, holds
each against its plain PyTorch version on the card, then drives the main
path — the batched receding-horizon tracker of ``bench.py``: B=4096
scenarios of the dynamic bicycle on the racetrack, N=20, dt=1/30, constant
reference vx=1.8, ``make_scenario_grid(n_ey=64, n_mu=64, vx0=1.5)``,
``SolverConfig(max_iter=20, rho_interval=0, early_exit=True,
check_termination=2)``, 4 Euler plant sub-steps, one megastep launch per
control step — for K=500 steps, followed by a few steps of the same
controller routed through the solver-only kernel
(``mpc_step_batched(backend="admm")`` + ``plant_step``).

Every phase either passes or ends the run with a non-zero exit. The last
two lines of standard output are a JSON line with one record per kernel and
the JSON result line. ``--quick`` stops after the kernel comparisons (a
first check of freshly edited kernels) and prints no result.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "autonomous_racing_lpv_mpp_mpc_tpu_torch"
B_MAIN = 4096
N_MAIN = 20
K_MAIN = 500
K_ADMM_ROUTE = 5


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def log(*a):
    print(*a, flush=True)


def gpu_name_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, n):
    """Mean device time per call of fn over n calls (CUDA events)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def main():
    quick = "--quick" in sys.argv[1:]
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA GPU")
    sys.path.insert(0, HERE)
    try:
        port = __import__(PKG)
    except ImportError as e:
        fail(f"the port package {PKG} is not beside this script ({e})")
    check(os.path.dirname(os.path.abspath(port.__file__)) == os.path.join(HERE, PKG),
          f"{PKG} was imported from {port.__file__}, not from this checkout")

    from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import MPCConfig, SolverConfig, VehicleParams
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import (
        MPCCarry, constant_refs, mpc_init, mpc_prepare, mpc_step_batched, plant_step,
    )
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import _cuda
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops.admm_kernel import (
        admm_kernel_solve, admm_solve_plain,
    )
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops.megastep_kernel import (
        megastep, megastep_init, megastep_params, megastep_plain,
    )
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.parallel import make_scenario_grid
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.track import racetrack

    # ---- 1. environment ----
    card = gpu_name_power()
    dev = torch.device("cuda", 0)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[env] nvidia-smi: {card}")
    log(f"[env] tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32} precision={torch.get_float32_matmul_precision()}")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")

    # ---- 2. build ----
    t0 = time.perf_counter()
    lib_path = _cuda.build()
    _cuda.library()
    log(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")

    # ---- shared setup: the bench protocol's scenarios ----
    p = VehicleParams()
    cfg = MPCConfig(N=N_MAIN, model="dynamic")
    track = racetrack(device=dev)
    x_ref = constant_refs(cfg, 1.8, device=dev)
    scen = make_scenario_grid(p, cfg, n_ey=64, n_mu=B_MAIN // 64, vx0=1.5, device=dev)
    B = scen.batch
    check(B == B_MAIN, f"scenario grid has {B} lanes")
    prm = megastep_params(scen.params, B, device=dev)

    # ---- 3. kernel 1 (solver-only) vs its plain version ----
    scfg1 = SolverConfig(max_iter=20, rho_interval=0)
    carry = mpc_init(scen.params, cfg, track, scen.x0)
    qp, warm, _ = mpc_prepare(scen.params, cfg, track, scen.x0, x_ref, carry)
    ref = admm_solve_plain(qp, scfg1, warm, carry.rho)
    sol = admm_kernel_solve(qp, scfg1, warm, carry.rho)
    torch.cuda.synchronize()
    dU = (sol.U - ref.U).abs().max().item()
    dX = (sol.X - ref.X).abs().max().item()
    dr = (sol.r_prim - ref.r_prim).abs().max().item()
    n_da = int((sol.iters - ref.iters).ne(0).sum().item())
    da_max = int((sol.iters - ref.iters).abs().max().item())
    log(f"[admm] B={B} N={N_MAIN} max|dU|={dU:.3e} max|dX|={dX:.3e} max|dr_prim|={dr:.3e} "
        f"done-at differs in {n_da} lanes (max {da_max})")
    check(dU <= 2e-4 and dX <= 2e-4, "admm kernel: U/X beyond 2e-4 of the plain version")
    check(dr <= 1e-4, "admm kernel: r_prim beyond 1e-4 of the plain version")
    check(da_max <= 1, "admm kernel: done-at differs by more than 1")
    check(admm_kernel_solve.launches > 0, "admm kernel was not launched")
    admm_ms = cuda_time_ms(lambda: admm_kernel_solve(qp, scfg1, warm, carry.rho), 10)
    admm_plain_ms = cuda_time_ms(lambda: admm_solve_plain(qp, scfg1, warm, carry.rho), 3)
    log(f"[admm] {admm_ms:.3f} ms/solve kernel, {admm_plain_ms:.3f} ms/solve plain ({card})")

    # ---- 4. kernel 2 (megastep) vs its plain version, 5 closed-loop steps ----
    mega_err = {}
    for name, scfg, tol_u, tol_x in (
        ("fixed", SolverConfig(max_iter=20, rho_interval=0, early_exit=False, check_termination=2), 2e-4, 5e-4),
        ("early-exit", SolverConfig(max_iter=20, rho_interval=0, early_exit=True, check_termination=2), 5e-3, 5e-3),
    ):
        ck = megastep_init(scen.params, cfg, track, scen.x0)
        cp = ck
        du = dx = 0.0
        for _ in range(5):
            ck, uk, dk = megastep(cfg, scfg, track, prm, x_ref, ck, n_sub=4)
            cp, up, dp = megastep_plain(cfg, scfg, track, prm, x_ref, cp, n_sub=4)
            torch.cuda.synchronize()
            du = max(du, (uk - up).abs().max().item())
            dx = max(dx, (ck.x - cp.x).abs().max().item())
        dXp = (ck.X_pred - cp.X_pred).abs().max().item()
        log(f"[mega] {name}: max|du|={du:.3e} max|dx|={dx:.3e} |dX_pred|={dXp:.3e} "
            f"done-at kernel {dk[4].mean().item():.3f} plain {dp[4].mean().item():.3f}")
        check(du <= tol_u and dx <= tol_x, f"megastep {name}: beyond ({tol_u}, {tol_x}) of plain")
        mega_err[name] = max(du, dx)
    scfg = SolverConfig(max_iter=20, rho_interval=0, early_exit=True, check_termination=2)
    c0 = megastep_init(scen.params, cfg, track, scen.x0)
    megastep(cfg, scfg, track, prm, x_ref, c0, n_sub=4)            # warm-up
    mega_ms_iso = cuda_time_ms(lambda: megastep(cfg, scfg, track, prm, x_ref, c0, n_sub=4), 10)
    mega_plain_ms = cuda_time_ms(lambda: megastep_plain(cfg, scfg, track, prm, x_ref, c0, n_sub=4), 3)
    log(f"[mega] first step: {mega_ms_iso:.3f} ms kernel, {mega_plain_ms:.3f} ms plain ({card})")
    if quick:
        log("[quick] kernel checks passed; stopping before the main path")
        return

    # ---- 5. the main path ----
    admm_kernel_solve.launches = 0
    megastep.launches = 0
    car = megastep_init(scen.params, cfg, track, scen.x0)
    s_start = car.x[4].clone()
    conv = torch.empty(K_MAIN, device=dev)
    iters = torch.empty(K_MAIN, device=dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for k in range(K_MAIN):
        if k == 1:
            start.record()
        car, u0, diag = megastep(cfg, scfg, track, prm, x_ref, car, n_sub=4)
        conv[k] = diag[2].mean()
        iters[k] = diag[4].mean()
    end.record()
    torch.cuda.synchronize()
    mega_ms = start.elapsed_time(end) / (K_MAIN - 1)
    # the same controller through the solver-only kernel, from the final state
    scfg_admm = SolverConfig(max_iter=20, rho_interval=0, backend="admm",
                             polish=False, certify_infeasibility=False)
    fb = lambda t: t.movedim(-1, 0)
    xs = fb(car.x).contiguous()
    mcar = MPCCarry(X_pred=fb(car.X_pred), U_pred=fb(car.U_pred), s=fb(car.s),
                    lam=fb(car.lam), u_prev=fb(car.u_prev), rho=car.rho)
    conv_admm = []
    for _ in range(K_ADMM_ROUTE):
        ub, mcar, dg = mpc_step_batched(scen.params, cfg, scfg_admm, track, xs, x_ref, mcar)
        xs = plant_step(scen.params, cfg, track, xs, ub, n_sub=4)
        conv_admm.append(dg.converged.float().mean().item())
    torch.cuda.synchronize()
    launches = {"megastep": megastep.launches, "admm": admm_kernel_solve.launches}

    finite = all(bool(torch.isfinite(t).all()) for t in car) and bool(torch.isfinite(xs).all())
    conv_last = conv[-100:].mean().item()
    done_at = iters.mean().item()
    progress = (car.x[4] - s_start).mean().item()
    log(f"[main] K={K_MAIN} B={B} N={N_MAIN}: {mega_ms:.4f} ms/step "
        f"({B / mega_ms * 1e3:.0f} solves/s) ({card})")
    log(f"[main] converged {conv.mean().item():.4f} (last 100: {conv_last:.4f}), mean done-at "
        f"{done_at:.3f}/20 (last 100: {iters[-100:].mean().item():.3f}), mean progress "
        f"{progress:.2f} m, finite={finite}")
    log(f"[main] admm route, {K_ADMM_ROUTE} steps: converged {[round(c, 4) for c in conv_admm]}")
    log(f"[main] launches {launches}")
    check(finite, "non-finite state on the main path")
    check(launches["megastep"] == K_MAIN, f"megastep launched {launches['megastep']} times, expected {K_MAIN}")
    check(launches["admm"] == K_ADMM_ROUTE, f"admm kernel launched {launches['admm']} times")
    check(conv_last >= 0.99, f"converged fraction over the last 100 steps {conv_last:.4f} < 0.99")
    check(min(conv_admm) >= 0.99, "admm route did not converge")
    check(progress > 0.0, "the cars did not advance")

    src = f"{PKG}/ops/csrc"
    ref_pkg = "autonomous_racing_lpv_mpp_mpc_tpu/ops"
    print(json.dumps({"kernels": [
        {"name": "admm_kernel", "route": "cuda", "source": f"{src}/admm_kernel.cu",
         "replaces": f"{ref_pkg}/admm_kernel.py:342", "launches": launches["admm"],
         "max_abs_err": max(dU, dX), "ms": admm_ms, "plain_ms": admm_plain_ms},
        {"name": "megastep_kernel", "route": "cuda", "source": f"{src}/megastep_kernel.cu",
         "replaces": f"{ref_pkg}/megastep_kernel.py:1081", "launches": launches["megastep"],
         "max_abs_err": mega_err["fixed"], "ms": mega_ms, "plain_ms": mega_plain_ms},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
