"""The benchmark's own copy of the track tables: the racetrack's segment
spec compiled to a uniform arc-length curvature table (numpy, float64, then
float32), and the two cell-index forms the tracker routes look curvature up
by. Imports nothing of the program."""

from __future__ import annotations

import math

import numpy as np
import torch


def _quarter(radius: float, sign: float):
    return (math.pi / 2 * radius, sign / radius)


def _racetrack_segments():
    """The racetrack: a detour tab and an S-chicane on two long straights,
    joined by four 1.3 m corners; both chicane blocks net zero heading."""
    r_corner, r_chi, long_straight, short_straight = 1.3, 1.0, 7.0, 2.5
    tab = [_quarter(r_chi, +1.0), _quarter(r_chi, -1.0), _quarter(r_chi, -1.0), _quarter(r_chi, +1.0)]
    chi = [_quarter(r_chi, -1.0), _quarter(r_chi, +1.0), _quarter(r_chi, +1.0), _quarter(r_chi, -1.0)]
    segs = [(1.0, 0.0)] + tab + [(long_straight - 1.0 - 4 * r_chi, 0.0)]
    segs += [_quarter(r_corner, +1.0), (short_straight, 0.0), _quarter(r_corner, +1.0), (0.8, 0.0)]
    segs += chi + [(long_straight - 0.8 - 4 * r_chi, 0.0)]
    segs += [_quarter(r_corner, +1.0), (short_straight, 0.0), _quarter(r_corner, +1.0)]
    return tuple(segs)


SEGMENTS = {"racetrack": _racetrack_segments()}


def track_table(name: str, ds: float, device) -> dict:
    """{"kappa": (n,) curvature of each cell [i ds, (i+1) ds), "length",
    "ds": 0-d float32} of the named track. Every segment holds a whole
    number of cells; the cells are then laid on a uniform grid."""
    segments = [(float(L), float(k)) for L, k in SEGMENTS[name]]
    total = sum(L for L, _ in segments)
    n = sum(max(1, int(round(L / ds))) for L, _ in segments)
    s_uni = np.linspace(0.0, total, n + 1)
    centers = (s_uni[:-1] + s_uni[1:]) / 2
    seg_ends = np.cumsum([L for L, _ in segments])
    seg_kappa = np.array([k for _, k in segments])
    kap = seg_kappa[np.minimum(np.searchsorted(seg_ends, centers, side="right"), len(segments) - 1)]
    f32 = lambda a: torch.tensor(np.asarray(a, dtype=np.float32), device=device)
    return {"kappa": f32(kap), "length": f32(total), "ds": f32(total / n)}


def curvature_lookup(table: dict, form: str):
    """kap(s) by the cell index floor(wrap(s) / ds) (``form="div"``) or
    floor(wrap(s) * (1 / ds)) (``form="mul"``), clamped to the table. The
    two forms can differ by one cell exactly at a cell boundary, so each
    route is held to the form it states."""
    kappa, length, ds = table["kappa"], table["length"], table["ds"]
    inv_ds = 1.0 / ds
    n = kappa.shape[0]

    def kap(s):
        sm = s - length * torch.floor(s / length)
        f = sm / ds if form == "div" else sm * inv_ds
        return kappa[torch.clamp(f.to(torch.int32), 0, n - 1).long()]

    if form not in ("div", "mul"):
        raise ValueError(f"unknown curvature lookup form {form!r}")
    return kap
