"""Built-in track specs (the JAX package's ``track/specs.py``): the
reference oval and the longer racetrack with a detour tab and an
S-chicane. Both chicane blocks net zero heading and zero offset."""

from __future__ import annotations

import math

from .track import Track, compile_track

_R = 1.0            # oval corner radius [m]
_K = 1.0 / _R

OVAL_SEGMENTS = (
    (2.0, 0.0),
    (math.pi * _R, _K),
    (2.0, 0.0),
    (math.pi * _R, _K),
)


def _quarter(radius: float, sign: float):
    return (math.pi / 2 * radius, sign / radius)


def _tab(radius: float):
    """Detour block: +90, -90, -90, +90 quarter arcs."""
    return [_quarter(radius, +1.0), _quarter(radius, -1.0),
            _quarter(radius, -1.0), _quarter(radius, +1.0)]


def _schicane(radius: float):
    """Mirror-image detour."""
    return [_quarter(radius, -1.0), _quarter(radius, +1.0),
            _quarter(radius, +1.0), _quarter(radius, -1.0)]


def _racetrack_segments():
    r_corner = 1.3
    r_chi = 1.0
    long_straight = 7.0
    short_straight = 2.5
    segs = []
    segs += [(1.0, 0.0)]
    segs += _tab(r_chi)
    segs += [(long_straight - 1.0 - 4 * r_chi, 0.0)]
    segs += [_quarter(r_corner, +1.0)]
    segs += [(short_straight, 0.0)]
    segs += [_quarter(r_corner, +1.0)]
    segs += [(0.8, 0.0)]
    segs += _schicane(r_chi)
    segs += [(long_straight - 0.8 - 4 * r_chi, 0.0)]
    segs += [_quarter(r_corner, +1.0)]
    segs += [(short_straight, 0.0)]
    segs += [_quarter(r_corner, +1.0)]
    return tuple(segs)


RACETRACK_SEGMENTS = _racetrack_segments()


def oval_track(width: float = 0.8, ds: float = 0.02, device=None) -> Track:
    return compile_track(OVAL_SEGMENTS, width=width, ds=ds, device=device)


def racetrack(width: float = 0.8, ds: float = 0.02, device=None) -> Track:
    return compile_track(RACETRACK_SEGMENTS, width=width, ds=ds, device=device)
