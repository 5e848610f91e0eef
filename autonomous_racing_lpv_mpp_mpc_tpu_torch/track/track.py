"""Track geometry: segment spec -> dense uniform arc-length table.

Counterpart of the JAX package's ``track/track.py``. The ``(length,
curvature)`` segment spec is compiled once on the host (numpy, float64) into
a uniform-``ds`` table; runtime lookups are index arithmetic plus a gather.
The Frenet transforms take any leading batch shape on their query arrays.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from ..core.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Track:
    """Compiled track: uniform arc-length table (float32 tensors).

    ``kappa[i]`` is the curvature of the cell ``[i*ds, (i+1)*ds)``;
    ``X/Y/psi[i]`` is the centerline pose at ``s = i*ds`` (``n + 1`` rows).
    ``ds``, ``length`` and ``width`` are 0-d tensors.
    """

    ds: torch.Tensor
    length: torch.Tensor
    width: torch.Tensor
    kappa: torch.Tensor
    X: torch.Tensor
    Y: torch.Tensor
    psi: torch.Tensor

    @property
    def n_cells(self) -> int:
        return self.kappa.shape[0]

    @functools.cached_property
    def ds_host(self) -> float:
        """``ds`` as a Python float, read from the device once per track
        (sizing a search window then costs no device sync per step)."""
        return float(self.ds)


def compile_track(
    segments: Sequence[Tuple[float, float]],
    width: float = 0.8,
    ds: float = 0.02,
    x0: float = 0.0,
    y0: float = 0.0,
    psi0: float = 0.0,
    device=None,
) -> Track:
    """Compile ``(length, curvature)`` segments into a dense :class:`Track`.

    Exact arc geometry per segment; every segment holds an integer number of
    cells, then the nodes are resampled onto a truly uniform grid. The
    table lives on ``device`` (``None``: the CUDA card).
    """
    segments = [(float(L), float(k)) for (L, k) in segments]
    total = sum(L for L, _ in segments)
    cells = [max(1, int(round(L / ds))) for L, _ in segments]
    n = sum(cells)

    X = np.empty(n + 1, dtype=np.float64)
    Y = np.empty(n + 1, dtype=np.float64)
    psi = np.empty(n + 1, dtype=np.float64)
    X[0], Y[0], psi[0] = x0, y0, psi0
    i = 0
    for (L, k), nc in zip(segments, cells):
        d = L / nc
        for _ in range(nc):
            if abs(k) < 1e-12:
                X[i + 1] = X[i] + d * np.cos(psi[i])
                Y[i + 1] = Y[i] + d * np.sin(psi[i])
                psi[i + 1] = psi[i]
            else:
                psi[i + 1] = psi[i] + k * d
                X[i + 1] = X[i] + (np.sin(psi[i + 1]) - np.sin(psi[i])) / k
                Y[i + 1] = Y[i] - (np.cos(psi[i + 1]) - np.cos(psi[i])) / k
            i += 1

    s_nodes = np.concatenate(
        [[0.0], np.cumsum(np.concatenate([[L / nc] * nc for (L, _), nc in zip(segments, cells)]))]
    )
    s_uni = np.linspace(0.0, total, n + 1)
    Xu = np.interp(s_uni, s_nodes, X)
    Yu = np.interp(s_uni, s_nodes, Y)
    psiu = np.interp(s_uni, s_nodes, psi)
    seg_ends = np.cumsum([L for L, _ in segments])
    seg_kappa = np.array([k for _, k in segments])
    centers = (s_uni[:-1] + s_uni[1:]) / 2
    kap_u = seg_kappa[np.minimum(np.searchsorted(seg_ends, centers, side="right"), len(segments) - 1)]

    device = resolve_device(device)
    f32 = lambda a: torch.tensor(np.asarray(a, dtype=np.float32), device=device)
    return Track(
        ds=f32(total / n), length=f32(total), width=f32(width),
        kappa=f32(kap_u), X=f32(Xu), Y=f32(Yu), psi=f32(psiu),
    )


def wrap_s(track: Track, s: torch.Tensor) -> torch.Tensor:
    """Wrap arc length into [0, length)."""
    return s - track.length * torch.floor(s / track.length)


def _cell_index(track: Track, s: torch.Tensor) -> torch.Tensor:
    sm = wrap_s(track, s)
    return torch.clamp((sm / track.ds).to(torch.int32), 0, track.n_cells - 1).long()


def curvature_at(track: Track, s: torch.Tensor) -> torch.Tensor:
    """Piecewise-constant curvature lookup (``sm / ds`` cell index)."""
    return track.kappa[_cell_index(track, s)]


def centerline_pose(track: Track, s: torch.Tensor):
    """Interpolated centerline pose (X, Y, psi) at arc length ``s``."""
    sm = wrap_s(track, s)
    f = sm / track.ds
    i0 = torch.clamp(f.to(torch.int32), 0, track.n_cells - 1).long()
    t = f - i0.to(f.dtype)
    lerp = lambda a: a[i0] * (1 - t) + a[i0 + 1] * t
    return lerp(track.X), lerp(track.Y), lerp(track.psi)


def frenet_to_global(track: Track, s, e_y, e_psi):
    """(s, e_y, e_psi) -> global (X, Y, psi)."""
    Xc, Yc, pc = centerline_pose(track, s)
    return Xc - e_y * torch.sin(pc), Yc + e_y * torch.cos(pc), pc + e_psi


def _project(track: Track, i, X, Y, psi):
    """Tangent projection at node ``i``: (s, e_y, e_psi)."""
    tx, ty = torch.cos(track.psi[i]), torch.sin(track.psi[i])
    ddx, ddy = X - track.X[i], Y - track.Y[i]
    along = ddx * tx + ddy * ty
    e_y = -ddx * ty + ddy * tx
    s = wrap_s(track, i.to(torch.float32) * track.ds + along)
    pc = track.psi[i] + curvature_at(track, s) * along
    e_psi = torch.atan2(torch.sin(psi - pc), torch.cos(psi - pc))
    return s, e_y, e_psi


def global_to_frenet(track: Track, X, Y, psi):
    """Global pose -> (s, e_y, e_psi): nearest node over the whole table,
    then the tangent projection."""
    d2 = (X[..., None] - track.X[:-1]) ** 2 + (Y[..., None] - track.Y[:-1]) ** 2
    return _project(track, torch.argmin(d2, dim=-1), X, Y, psi)


def global_to_frenet_windowed(track: Track, X, Y, psi, s_hint, window_m: float = 3.0):
    """Hint-windowed :func:`global_to_frenet`: the nearest node among the
    cells within ``window_m`` of the hint's cell. A lane whose nearest
    windowed node is farther than ``window_m`` from the query (a wrong hint)
    takes the dense answer instead (the JAX version's ``lax.cond``, here a
    per-lane ``torch.where``)."""
    n = track.X.shape[0] - 1
    W = max(2, int(window_m / track.ds_host))
    sm = s_hint - track.length * torch.floor(s_hint / track.length)
    i_hint = (sm / track.ds).to(torch.int32).long()
    idx = torch.remainder(i_hint[..., None] + torch.arange(-W, W + 1, device=sm.device), n)
    d2 = (X[..., None] - track.X[idx]) ** 2 + (Y[..., None] - track.Y[idx]) ** 2
    i_w = torch.gather(idx, -1, torch.argmin(d2, dim=-1, keepdim=True))[..., 0]
    windowed = _project(track, i_w, X, Y, psi)
    implausible = d2.amin(dim=-1) > window_m * window_m
    if not bool(implausible.any()):
        return windowed
    dense = global_to_frenet(track, X, Y, psi)
    return tuple(torch.where(implausible, d, w) for d, w in zip(dense, windowed))
