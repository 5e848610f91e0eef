"""Reference tables indexed by arc length (the JAX package's
``planner/reftable.py``): vx_ref(s), e_y_ref(s) and the steering
feed-forward delta_ff(s) on a uniform grid, so a lookup is index arithmetic
plus a gather."""

from __future__ import annotations

import dataclasses

import torch

from ..core.config import MPCConfig
from ..models import model_nx


@dataclasses.dataclass(frozen=True)
class RefTable:
    """Uniform-grid reference table. The channels are (n,) tensors shared
    by every lane, or (B, n): one table per lane (the JAX package's table
    with leaves broadcast to (B,) + shape). ``ds`` and ``length`` are 0-d,
    or (B,) for per-lane tables."""

    ds: torch.Tensor
    length: torch.Tensor
    vx: torch.Tensor
    ey: torch.Tensor
    delta: torch.Tensor

    def replace(self, **changes) -> "RefTable":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "RefTable":
        return RefTable(*(getattr(self, f.name).to(device) for f in dataclasses.fields(self)))

    def lookup(self, s: torch.Tensor):
        """Linear-interpolated (vx_ref, ey_ref, delta_ff) at arc length s.
        With per-lane tables, s is (B, ...) and lane b reads its own row."""
        per_lane = self.vx.dim() == 2
        lane = lambda a: a.reshape(a.shape + (1,) * (s.dim() - a.dim())) if per_lane else a
        length, ds = lane(self.length), lane(self.ds)
        sm = s - length * torch.floor(s / length)
        n = self.vx.shape[-1]
        f = sm / ds
        i0 = torch.clamp(f.to(torch.int32), 0, n - 1).long()
        i1 = torch.remainder(i0 + 1, n)
        t = f - i0.to(f.dtype)
        if per_lane:
            at = lambda a, i: torch.gather(a, 1, i.reshape(i.shape[0], -1)).reshape(i.shape)
        else:
            at = lambda a, i: a[i]
        interp = lambda a: at(a, i0) * (1 - t) + at(a, i1) * t
        return interp(self.vx), interp(self.ey), interp(self.delta)


def refs_from_table(cfg: MPCConfig, table: RefTable, s_sched: torch.Tensor,
                    slope_probe: float = 0.15) -> torch.Tensor:
    """(..., N+1, nx) tracking reference at the scheduled s (..., N+1).

    The e_psi reference is the racing line's own heading, ``atan`` of the
    central difference of e_y over ``slope_probe`` metres; a slope above
    0.3 rad is a table seam, not a commanded heading, and reads as 0."""
    nx = model_nx(cfg.model)
    vx_r, ey_r, _ = table.lookup(s_sched)
    ey_p = table.lookup(s_sched + slope_probe)[1]
    ey_m = table.lookup(s_sched - slope_probe)[1]
    epsi_r = torch.atan2(ey_p - ey_m, torch.full_like(ey_p, 2.0 * slope_probe))
    epsi_r = torch.where(torch.abs(epsi_r) > 0.3, torch.zeros_like(epsi_r), epsi_r)
    ey_i, epsi_i = (5, 3) if cfg.model == "dynamic" else (3, 1)
    x_ref = torch.zeros(s_sched.shape + (nx,), dtype=s_sched.dtype, device=s_sched.device)
    x_ref[..., 0] = vx_r
    x_ref[..., ey_i] = ey_r
    x_ref[..., epsi_i] = epsi_r
    return x_ref
