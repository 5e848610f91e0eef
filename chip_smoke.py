#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``ops/csrc`` with nvcc, holds
each against its plain PyTorch version on the card, then drives two main
paths:

- the batched receding-horizon tracker of ``bench.py``: B=4096 scenarios of
  the dynamic bicycle on the racetrack, N=20, dt=1/30, constant reference
  vx=1.8, ``make_scenario_grid(n_ey=64, n_mu=64, vx0=1.5)``,
  ``SolverConfig(max_iter=20, rho_interval=0, early_exit=True,
  check_termination=2)``, 4 Euler plant sub-steps, one megastep launch per
  control step — for K=500 steps, followed by a few steps of the same
  controller routed through the solver-only kernel
  (``mpc_step_batched(backend="admm")`` + ``plant_step``);
- the composed deployment step of ``tools/racebench.py``: B=4096 cars on
  the racetrack, ``MPCConfig(N=20, tire="pacejka")``, the same solver
  config, ``initial_table(ds=0.05, vx0=1.5)`` references, plant friction
  ``linspace(0.5, 1.2, B)``, controller seed mu0=0.85, vx0=1.5 with s spread
  over the lap, sensor noise sigma = (0.03, 0.01, 0.02, 0.01, 0.02, 0.01),
  EKF with 4 sub-steps, friction adaptation, 10 world-plant sub-steps — for
  K=500 steps through ``make_racestep_scan``, one racestep launch per step.

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
K_RACE_CMP = 5
SIGMA = (0.03, 0.01, 0.02, 0.01, 0.02, 0.01)


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
        import numpy as np
        import torch
    except ImportError:
        fail("PyTorch or numpy is not installed")
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
        DEFAULT_EKF_Q, MPCCarry, constant_refs, initial_table, make_racestep_scan, mpc_init,
        mpc_prepare, mpc_step_batched, plant_step,
    )
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import _cuda
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops.admm_kernel import (
        admm_kernel_solve, admm_solve_plain,
    )
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops.megastep_kernel import (
        megastep, megastep_init, megastep_params, megastep_plain,
    )
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops.racestep_kernel import (
        racestep, racestep_init, racestep_plain,
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

    # ---- 5. kernel 3 (racestep) vs its plain version: the composed protocol ----
    rcfg = MPCConfig(N=N_MAIN, model="dynamic", tire="pacejka")
    table = initial_table(track, ds=0.05, vx0=1.5)
    mu_b = torch.linspace(0.5, 1.2, B_MAIN, device=dev)
    x0r = torch.zeros((B_MAIN, 6), device=dev)
    x0r[:, 0] = 1.5
    x0r[:, 4] = torch.arange(B_MAIN, device=dev, dtype=torch.float32) * (float(track.length) / B_MAIN)
    p_nom = p.replace(mu=0.85)
    rprm = megastep_params(p_nom, B_MAIN, device=dev)
    sig = torch.tensor(SIGMA, device=dev)
    ekq = torch.tensor(DEFAULT_EKF_Q, device=dev)
    ekr = sig ** 2
    gen = torch.Generator(device=dev).manual_seed(0)
    noises = [sig[:, None] * torch.randn((6, B_MAIN), generator=gen, device=dev) for _ in range(K_RACE_CMP)]
    # Fixed count: the kernel-parity bounds hold on the lanes whose solves converged
    # at every compared step on both sides; on a lane that has not converged
    # after 20 iterations the iterate is still moving by up to its residual
    # (~1e-3), and rho adapted from float-noise dual residuals amplifies the
    # two versions' rounding there, so every lane is held to the solver
    # tolerance of 5e-3 (the early-exit bound).
    race_err = {}
    fixed = SolverConfig(max_iter=20, rho_interval=0, early_exit=False, check_termination=2)
    tight = {"u0": 2e-4, "xg": 5e-4, "ekx": 5e-4, "X_pred": 5e-4, "z": 5e-4, "fr": 1e-4}
    loose = dict.fromkeys(tight, 5e-3)
    for name, scfg_r, refs, gate, conv_bounds in (
        ("fixed", fixed, table, 0.0, tight),
        ("early-exit", scfg, table, 0.0, loose),
        ("fixed, constant refs, gate 3", fixed, constant_refs(rcfg, 1.5, device=dev), 3.0, tight),
    ):
        ck = cp = racestep_init(p, rcfg, track, x0r, 0.85)
        lane_err = {}
        conv_lanes = torch.ones(B_MAIN, dtype=torch.bool, device=dev)
        for k in range(K_RACE_CMP):
            a = (rcfg, scfg_r, track, rprm, refs)
            ck, uk, dk, zk = racestep(*a, ck, noises[k], mu_b, ekq, ekr, gate_sigma=gate)
            cp, up, dp, zp = racestep_plain(*a, cp, noises[k], mu_b, ekq, ekr, gate_sigma=gate)
            torch.cuda.synchronize()
            conv_lanes &= (dk[2] > 0.5) & (dp[2] > 0.5)
            for key, x, y in (("u0", uk, up), ("z", zk, zp)) + tuple(
                    (f, getattr(ck, f), getattr(cp, f)) for f in ("xg", "ekx", "ekP", "fr", "X_pred")):
                d = (x - y).abs().reshape(-1, B_MAIN).amax(dim=0)
                lane_err[key] = torch.maximum(lane_err[key], d) if key in lane_err else d
        err_all = {key: v.max().item() for key, v in lane_err.items()}
        err_conv = {key: (v[conv_lanes].max().item() if bool(conv_lanes.any()) else 0.0)
                    for key, v in lane_err.items()}
        n_conv = int(conv_lanes.sum().item())
        log(f"[race] {name}: lanes converged at every step {n_conv}/{B_MAIN}: "
            + " ".join(f"max|d{key}|={v:.3e}" for key, v in err_conv.items()))
        log(f"[race] {name}: all lanes: " + " ".join(f"max|d{key}|={v:.3e}" for key, v in err_all.items())
            + f" done-at kernel {dk[4].mean().item():.3f} plain {dp[4].mean().item():.3f}")
        check(n_conv >= 0.9 * B_MAIN, f"racestep {name}: only {n_conv} lanes converged throughout")
        for key, tol in conv_bounds.items():
            check(err_conv[key] <= tol,
                  f"racestep {name}: |d{key}| {err_conv[key]:.3e} beyond {tol} of plain (converged lanes)")
        for key, tol in loose.items():
            check(err_all[key] <= tol, f"racestep {name}: |d{key}| {err_all[key]:.3e} beyond {tol} of plain")
        race_err[name] = max(err_all[key] for key in tight)
    c0r = racestep_init(p, rcfg, track, x0r, 0.85)
    race_args = (rcfg, scfg, track, rprm, table, c0r, noises[0], mu_b, ekq, ekr)
    racestep(*race_args)                                              # warm-up
    race_ms_iso = cuda_time_ms(lambda: racestep(*race_args), 10)
    race_plain_ms = cuda_time_ms(lambda: racestep_plain(*race_args), 3)
    log(f"[race] first step: {race_ms_iso:.3f} ms kernel, {race_plain_ms:.3f} ms plain ({card})")
    if quick:
        log("[quick] kernel checks passed; stopping before the main path")
        return

    # ---- 6. main path 1: the tracker step ----
    admm_kernel_solve.launches = 0
    megastep.launches = 0
    racestep.launches = 0
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
    launches = {"megastep": megastep.launches, "admm": admm_kernel_solve.launches,
                "racestep": racestep.launches}

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

    # ---- 7. main path 2: the composed deployment step ----
    run = make_racestep_scan(p_nom, rcfg, scfg, track, table, K_MAIN, mu_b, SIGMA)
    car0 = racestep_init(p, rcfg, track, x0r, 0.85)
    racestep(rcfg, scfg, track, rprm, table, car0, noises[0], mu_b, ekq, ekr)    # warm-up
    torch.cuda.synchronize()
    admm_kernel_solve.launches = 0
    megastep.launches = 0
    racestep.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    rcar, (Xg, Xf, U, mu_hat, rconv, Z, riters, _) = run(car0, torch.Generator(device=dev).manual_seed(1))
    end.record()
    torch.cuda.synchronize()
    race_launches = {"racestep": racestep.launches, "megastep": megastep.launches,
                     "admm": admm_kernel_solve.launches}
    race_ms = start.elapsed_time(end) / K_MAIN
    rfinite = all(bool(torch.isfinite(t).all()) for t in rcar) and bool(torch.isfinite(Xf).all())
    rconv_last = rconv[-100:].mean().item()
    rprogress = (Xf[-1, 4] - x0r[:, 4]).mean().item()
    mu_corr = float(np.corrcoef(mu_hat[-1].cpu().numpy(), mu_b.cpu().numpy())[0, 1])
    ey = Xf[:, 5].abs().flatten().cpu().numpy()
    ey_p99, ey_max = float(np.percentile(ey, 99)), float(ey.max())
    cp = racestep_init(p, rcfg, track, x0r, 0.85)
    t0 = time.perf_counter()
    for k in range(3):
        cp, _, _, _ = racestep_plain(rcfg, scfg, track, rprm, table, cp, noises[k], mu_b, ekq, ekr)
    torch.cuda.synchronize()
    race_plain_step_ms = (time.perf_counter() - t0) * 1e3 / 3
    log(f"[race-main] K={K_MAIN} B={B_MAIN} N={N_MAIN}: {race_ms:.4f} ms/step "
        f"({B_MAIN / race_ms * 1e3:.0f} composed solves/s) ({card})")
    log(f"[race-main] converged {rconv.mean().item():.4f} (last 100: {rconv_last:.4f}), mean done-at "
        f"{riters.mean().item():.3f}/20, mu-hat/mu-true corr {mu_corr:.3f}, |e_y| p99 {ey_p99:.4f} "
        f"max {ey_max:.4f}, mean progress {rprogress:.2f} m, finite={rfinite}")
    log(f"[race-main] racestep_plain {race_plain_step_ms:.3f} ms/step over 3 steps ({card})")
    log(f"[race-main] launches {race_launches}")
    # tools/racebench.py's own window: the runner called 5 more times from
    # the carry it left (fresh noise each), the numbers read on the last
    # 500 steps (steps 2501-3000), the time as the best of the 5 windows
    best_ms, win = float("inf"), None
    for i in range(5):
        start.record()
        rcar, win = run(rcar, torch.Generator(device=dev).manual_seed(2 + i))
        end.record()
        torch.cuda.synchronize()
        best_ms = min(best_ms, start.elapsed_time(end) / K_MAIN)
    wXf, w_mu, w_conv = win[1], win[3], win[4]
    w_corr = float(np.corrcoef(w_mu[-1].cpu().numpy(), mu_b.cpu().numpy())[0, 1])
    w_ey = wXf[:, 5].abs().flatten().cpu().numpy()
    log(f"[race-bench] steps {5 * K_MAIN + 1}-{6 * K_MAIN}: best window {best_ms:.4f} ms/step "
        f"({B_MAIN / best_ms * 1e3:.0f} composed solves/s) ({card}); converged "
        f"{w_conv.mean().item():.4f}, mu-hat/mu-true corr {w_corr:.3f}, |e_y| p99 "
        f"{float(np.percentile(w_ey, 99)):.4f} max {float(w_ey.max()):.4f}")
    check(bool(torch.isfinite(wXf).all()) and w_conv.mean().item() >= 0.99,
          "the composed protocol's last window is not finite or not converged")
    check(rfinite, "non-finite state on the composed path")
    check(race_launches["racestep"] == K_MAIN,
          f"racestep launched {race_launches['racestep']} times, expected {K_MAIN}")
    check(rconv_last >= 0.99, f"composed converged fraction over the last 100 steps {rconv_last:.4f} < 0.99")
    check(rprogress > 0.0, "the composed cars did not advance")

    src = f"{PKG}/ops/csrc"
    ref_pkg = "autonomous_racing_lpv_mpp_mpc_tpu/ops"
    print(json.dumps({"kernels": [
        {"name": "admm_kernel", "route": "cuda", "source": f"{src}/admm_kernel.cu",
         "replaces": f"{ref_pkg}/admm_kernel.py:342", "launches": launches["admm"],
         "max_abs_err": max(dU, dX), "ms": admm_ms, "plain_ms": admm_plain_ms},
        {"name": "megastep_kernel", "route": "cuda",
         "source": f"{src}/megastep_kernel.cu + {src}/mpc_core.cuh",
         "replaces": f"{ref_pkg}/megastep_kernel.py:1081", "launches": launches["megastep"],
         "max_abs_err": mega_err["fixed"], "ms": mega_ms, "plain_ms": mega_plain_ms},
        {"name": "racestep_kernel", "route": "cuda",
         "source": f"{src}/racestep_kernel.cu + {src}/mpc_core.cuh",
         "replaces": f"{ref_pkg}/racestep_kernel.py:831", "launches": race_launches["racestep"],
         "max_abs_err": race_err["fixed"], "ms": race_ms, "plain_ms": race_plain_step_ms},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
