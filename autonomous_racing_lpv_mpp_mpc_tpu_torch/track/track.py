"""Track geometry: segment spec -> dense uniform arc-length table.

Counterpart of the JAX package's ``track/track.py``. The ``(length,
curvature)`` segment spec is compiled once on the host (numpy, float64) into
a uniform-``ds`` table; runtime lookups are index arithmetic plus a gather.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch


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
    cells, then the nodes are resampled onto a truly uniform grid.
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
