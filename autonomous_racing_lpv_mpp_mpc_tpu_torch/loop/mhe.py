"""Moving-horizon estimation over the LPV bicycle (the JAX package's
``loop/mhe.py``), batched over one leading dim.

MHE is an LQR problem in the process noise. Over a window of the last W
measurements,

    min  ||x_start - x_prior||^2_{P0^-1}
       + sum_j ||w_j||^2_{Qw^-1} + sum_j ||z_j - H x_j||^2_{Rv^-1}
    s.t. x_{j+1} = A_j x_j + (B_j u_j + c_j) + w_j

is the equality-constrained QP that the Riccati sweep solves
(``solver.riccati.lqr_solve``), the noise w being the "control": B = I,
R = Qw^-1, Q = H' Rv^-1 H, q = -H' Rv^-1 z. The arrival cost is a virtual
leading stage x_1 = x_0 + w_0 with x_0 = x_prior fixed and R_0 = P0^-1.
Each Gauss-Newton pass re-evaluates the scheduled stage matrices along the
current estimate (the sequentially linearized LPV update) and solves again.

The arc length s is unwrapped within a window: :func:`mhe_step` lifts a
measured s onto the lap of the smoothed estimate before it enters the
window.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from ..core.config import MPCConfig, VehicleParams
from ..engine.assembly import scheduled_stages
from ..models import model_nx
from ..solver.riccati import LQRCost, LQRDynamics, lqr_solve
from ..track.track import Track


@dataclasses.dataclass(frozen=True)
class MHEConfig:
    W: int = 8                # window length
    n_gn: int = 2             # Gauss-Newton passes
    riccati: str = "scan"     # "scan" | "assoc"


def mhe_solve(p: VehicleParams, cfg: MPCConfig, mcfg: MHEConfig, track: Track, z_hist: torch.Tensor,
              u_hist: torch.Tensor, X_guess: torch.Tensor, x_prior: torch.Tensor, P0: torch.Tensor,
              H: torch.Tensor, Qw: torch.Tensor, Rv: torch.Tensor) -> torch.Tensor:
    """Solve one MHE window: z_hist (..., W+1, m) measurements oldest
    first, u_hist (..., W, nu) the inputs between them, X_guess (..., W+1,
    nx) the linearization trajectory, x_prior (..., nx) the arrival mean;
    P0, H, Qw, Rv shared. Returns the smoothed trajectory (..., W+1, nx).
    At most one leading batch dim, matching ``p``'s (B,) leaves."""
    if z_hist.dim() == 2:
        one = lambda t: t.unsqueeze(0)
        return mhe_solve(p, cfg, mcfg, track, one(z_hist), one(u_hist), one(X_guess), one(x_prior),
                         P0, H, Qw, Rv)[0]
    W = mcfg.W
    nx = model_nx(cfg.model)
    B = z_hist.shape[0]
    kw = dict(dtype=z_hist.dtype, device=z_hist.device)
    I = torch.eye(nx, **kw)
    Rv_inv = torch.linalg.inv(Rv)
    HtRH = H.T @ Rv_inv @ H
    q_meas = -(z_hist @ Rv_inv @ H)                          # (B, W+1, nx)

    # the LQR cost over N = W+1 stages, stage 0 the virtual arrival stage
    zero = torch.zeros((B, 1, nx, nx), **kw)
    Q = torch.cat([zero, HtRH.expand(B, W + 1, nx, nx)], dim=1)
    qlin = torch.cat([torch.zeros((B, 1, nx), **kw), q_meas], dim=1)
    R = torch.cat([torch.linalg.inv(P0).expand(B, 1, nx, nx), torch.linalg.inv(Qw).expand(B, W, nx, nx)], dim=1)
    cost = LQRCost(Q=Q, q=qlin, R=R, r=torch.zeros((B, W + 1, nx), **kw),
                   M=torch.zeros((B, W + 1, nx, nx), **kw))
    B_noise = I.expand(B, W + 1, nx, nx)

    X_est = X_guess
    for _ in range(mcfg.n_gn):
        # the LPV stage matrices along the current estimate
        Ad, Bd, cd = scheduled_stages(p, cfg, track, X_est, u_hist)
        c_eff = (Bd @ u_hist.unsqueeze(-1)).squeeze(-1) + cd
        dyn = LQRDynamics(A=torch.cat([I.expand(B, 1, nx, nx), Ad], dim=1), B=B_noise,
                          c=torch.cat([torch.zeros((B, 1, nx), **kw), c_eff], dim=1))
        X, _ = lqr_solve(dyn, cost, x_prior, mcfg.riccati)
        X_est = X[:, 1:]                                      # drop the virtual stage
    return X_est


class MHEState(NamedTuple):
    z_hist: torch.Tensor     # (..., W+1, m) rolling measurements
    u_hist: torch.Tensor     # (..., W, nu) rolling inputs
    X_est: torch.Tensor      # (..., W+1, nx) last smoothed trajectory
    x_prior: torch.Tensor    # (..., nx) arrival mean for the next window


def mhe_init(cfg: MPCConfig, mcfg: MHEConfig, x0: torch.Tensor, H: torch.Tensor, nu: int = 2) -> MHEState:
    """Cold start from x0 (..., nx): the window filled as if the car sat at
    x0; the estimates are trustworthy after the first W steps."""
    W = mcfg.W
    lead = x0.shape[:-1]
    z0 = x0 @ H.T
    return MHEState(z_hist=z0.unsqueeze(-2).expand(lead + (W + 1, z0.shape[-1])).clone(),
                    u_hist=torch.zeros(lead + (W, nu), dtype=x0.dtype, device=x0.device),
                    X_est=x0.unsqueeze(-2).expand(lead + (W + 1, x0.shape[-1])).clone(),
                    x_prior=x0)


def mhe_step(p: VehicleParams, cfg: MPCConfig, mcfg: MHEConfig, track: Track, st: MHEState, u: torch.Tensor,
             z: torch.Tensor, P0: torch.Tensor, H: torch.Tensor, Qw: torch.Tensor,
             Rv: torch.Tensor) -> Tuple[MHEState, torch.Tensor]:
    """Receding-horizon filter update with the input ``u`` applied since
    the last measurement and the new measurement ``z``; returns (state,
    x_hat at this time). The arrival prior of the shifted window is the
    last window's smoothed second state (P0 held fixed)."""
    # lift each measured s (a row of H that reads the state's s) onto the
    # lap of the smoothed estimate, not of the last raw measurement: one s
    # outlier (error > L/2) in the window would otherwise wrap every later
    # measurement onto the wrong lap
    s_idx = 4 if cfg.model == "dynamic" else 2
    measures_s = torch.abs(H[:, s_idx]) > 0.5
    ref = st.X_est[..., -1, :] @ H.T
    L = track.length
    z = torch.where(measures_s, z + L * torch.round((ref - z) / L), z)
    z_hist = torch.cat([st.z_hist[..., 1:, :], z.unsqueeze(-2)], dim=-2)
    u_hist = torch.cat([st.u_hist[..., 1:, :], u.unsqueeze(-2)], dim=-2)
    x_prior = st.X_est[..., 1, :]
    # shifted warm start: the last smoothed trajectory, its last state held
    X_guess = torch.cat([st.X_est[..., 1:, :], st.X_est[..., -1:, :]], dim=-2)
    X_est = mhe_solve(p, cfg, mcfg, track, z_hist, u_hist, X_guess, x_prior, P0, H, Qw, Rv)
    return MHEState(z_hist, u_hist, X_est, x_prior), X_est[..., -1, :]
