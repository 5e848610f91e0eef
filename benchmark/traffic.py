"""The one scenario generator: a stream of sweeps drawn from ``--seed``.

A configuration fixes the grid (``grid``: n_ey x n_mu points, the e_y span
and the friction range, the initial speed) and the sweep length. Each
sweep draws every grid point's e_y and mu uniformly within its grid cell,
and each lane's start s uniformly over the track length. Each sweep takes
fresh draws from the same seeded stream, in order, on the device, so a seed
gives the same sweeps in every run. Lanes are e_y-major:
lane = i_ey * n_mu + i_mu. The program receives only the drawn tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

S_IDX, EY_IDX, NX = 4, 5, 6


class Scenarios(NamedTuple):
    x0: torch.Tensor   # (B, NX) initial states, batch-first
    mu: torch.Tensor   # (B,) friction


class ScenarioStream:
    def __init__(self, config: dict, seed: int, device, track_length: float):
        grid = config["grid"]
        self.n_ey, self.n_mu = int(grid["n_ey"]), int(grid["n_mu"])
        self.B = self.n_ey * self.n_mu
        if self.B != int(config["batch"]):
            raise ValueError(f"grid {self.n_ey} x {self.n_mu} is not the batch {config['batch']}")
        self.ey_span = float(grid["ey_span"])
        self.mu_lo, self.mu_hi = (float(v) for v in grid["mu_range"])
        self.vx0 = float(grid["vx0"])
        self.length = float(track_length)
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def _cells(self, lo, hi, u, along_ey: bool):
        """(n_ey, n_mu) values over [lo, hi] along one grid axis: each grid
        point's uniform draw ``u`` within its cell."""
        n = self.n_ey if along_ey else self.n_mu
        shape = (n, 1) if along_ey else (1, n)
        idx = torch.arange(n, dtype=torch.float32, device=self.device).reshape(shape)
        return lo + (idx + u) * ((hi - lo) / n)

    def next(self) -> Scenarios:
        """The next sweep's scenarios (one draw of the stream)."""
        u = torch.rand((3, self.n_ey, self.n_mu), generator=self.gen, device=self.device)
        ey = self._cells(-self.ey_span, self.ey_span, u[0], along_ey=True)
        mu = self._cells(self.mu_lo, self.mu_hi, u[1], along_ey=False)
        x0 = torch.zeros((self.B, NX), dtype=torch.float32, device=self.device)
        x0[:, 0] = self.vx0
        x0[:, EY_IDX] = ey.reshape(-1)
        x0[:, S_IDX] = u[2].reshape(-1) * self.length
        return Scenarios(x0=x0, mu=mu.reshape(-1).contiguous())
