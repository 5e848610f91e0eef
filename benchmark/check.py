"""The parts of the comparison that decides ``correct`` that every
reference shares: the sampled lanes, their copies, and the verdict. The
numbers themselves, what a sampled step of the timed path produced against
the plain reference stepped from the same carry, are the reference's
(``reference/<name>.py``; ``reference/tracker.py`` lists the tracker's).
"""

from __future__ import annotations

import torch


def lanes_of(groups, B: int, group: int, device):
    """The lanes of the given ``group``-lane groups (below B)."""
    g = torch.as_tensor(groups, device=device, dtype=torch.long)
    lanes = (g[:, None] * group + torch.arange(group, device=device)[None]).reshape(-1)
    return lanes[lanes < B]


def take(d: dict, lanes) -> dict:
    """The given lanes of a batch-last dict, as contiguous float32 copies."""
    return {k: v.index_select(-1, lanes).to(torch.float32).contiguous() for k, v in d.items()}


def verdict(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]) : every limited number at or below
    its limit. A number that is not finite fails."""
    rows = [(k, float(numbers[k]), float(v)) for k, v in limits.items()]
    ok = all(val == val and val <= lim for _, val, lim in rows)
    return ok, rows
