"""Scenario grids (the JAX package's ``parallel/scenarios.py``, the batch
construction only; the sharded sweeps come later)."""

from __future__ import annotations

import dataclasses

import torch

from ..core.config import MPCConfig, VehicleParams
from ..core.device import resolve_device
from ..models import model_nx
from ..ops.stage_math import model_s_ey


@dataclasses.dataclass(frozen=True)
class ScenarioBatch:
    """A batch of scenarios: stacked initial states and vehicle params."""

    x0: torch.Tensor          # (B, nx)
    params: VehicleParams     # batched leaves are (B,) tensors

    @property
    def batch(self) -> int:
        return self.x0.shape[0]


def make_scenario_grid(base: VehicleParams, cfg: MPCConfig, n_ey: int = 8,
                       n_mu: int = 8, ey_span: float = 0.25, mu_range=(0.7, 1.0),
                       vx0: float = 1.0, device=None) -> ScenarioBatch:
    """(initial e_y) x (friction mu) grid, e_y-major like the JAX package,
    on ``device`` (``None``: the CUDA card)."""
    device = resolve_device(device)
    nx = model_nx(cfg.model)
    _, ey_i = model_s_ey(cfg.model)
    eys = torch.linspace(-ey_span, ey_span, n_ey, dtype=torch.float32, device=device)
    mus = torch.linspace(mu_range[0], mu_range[1], n_mu, dtype=torch.float32, device=device)
    ey_g, mu_g = torch.meshgrid(eys, mus, indexing="ij")
    ey_f, mu_f = ey_g.reshape(-1), mu_g.reshape(-1)
    B = ey_f.shape[0]
    x0 = torch.zeros((B, nx), dtype=torch.float32, device=device)
    x0[:, 0] = vx0
    x0[:, ey_i] = ey_f
    return ScenarioBatch(x0=x0, params=base.replace(mu=mu_f))
