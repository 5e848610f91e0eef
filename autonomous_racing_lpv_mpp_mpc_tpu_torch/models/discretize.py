"""Discretization of continuous-time (A, B[, c]) stage matrices (the JAX
package's ``models/discretize.py``). Leading batch dims are kept."""

from __future__ import annotations

import torch


def discretize_euler(A, B, dt, c=None):
    n = A.shape[-1]
    Ad = torch.eye(n, dtype=A.dtype, device=A.device) + dt * A
    Bd = dt * B
    if c is None:
        return Ad, Bd
    return Ad, Bd, dt * c


def discretize_expm(A, B, dt, c=None, order: int = 6, squarings: int = 4):
    """Van Loan block exponential expm(dt [[A, B, c], [0, 0, 0]]): a
    fixed-order Taylor series (Horner) plus scaling and squaring."""
    n = A.shape[-1]
    m = B.shape[-1]
    extra = m + (0 if c is None else 1)
    Mtop = torch.cat([A, B] + ([] if c is None else [c[..., None]]), dim=-1)
    M = torch.cat(
        [Mtop, torch.zeros(A.shape[:-2] + (extra, n + extra), dtype=A.dtype, device=A.device)],
        dim=-2,
    )
    X = M * (dt / (2.0 ** squarings))
    I = torch.eye(n + extra, dtype=A.dtype, device=A.device)
    E = I + X / order
    for k in range(order - 1, 0, -1):
        E = I + (X @ E) / k
    for _ in range(squarings):
        E = E @ E
    Ad = E[..., :n, :n]
    Bd = E[..., :n, n:n + m]
    if c is None:
        return Ad, Bd
    return Ad, Bd, E[..., :n, n + m]


def discretize_order2(A, B, dt, c=None):
    """Second-order Taylor: Ad = I + dt A + (dt A)^2 / 2, Bd = (dt I +
    dt^2 A / 2) B (and cd likewise)."""
    n = A.shape[-1]
    I = torch.eye(n, dtype=A.dtype, device=A.device)
    dA = dt * A
    Ad = I + dA + 0.5 * dA @ dA
    Mt = dt * I + 0.5 * dt * dA
    Bd = Mt @ B
    if c is None:
        return Ad, Bd
    return Ad, Bd, (Mt @ c[..., None])[..., 0]


def discretize(A, B, dt, c=None, method: str = "euler"):
    if method == "euler":
        return discretize_euler(A, B, dt, c)
    if method == "order2":
        return discretize_order2(A, B, dt, c)
    if method == "expm":
        return discretize_expm(A, B, dt, c)
    raise ValueError(f"unknown discretization: {method!r}")
