"""The comparison that decides ``correct``: what a sampled step of the
timed path produced against the plain reference stepped from the same
carry, and the program's first carry against the reference's own.

Numbers (the names a cell's ``check.limits`` use):

- ``init_gap``: the first sweep's initial carry, max |program - reference|
  over the sampled lanes (the schedule's Euler rollout; the split, duals,
  inputs and rho must start as the reference's);
- ``groups_split``: the share of sampled 128-lane groups in which the two
  sides leave the ADMM loop at another iteration or take another branch
  (solution or limp-home) on some lane; the numbers below are over the
  other groups' lanes;
- ``u0_p99``, ``u0_max``: the 99th percentile and the maximum of
  |u0 program - u0 reference| (rad, m/s^2) over those lanes;
- ``x_max``: max |next state program - reference| over those lanes;
- ``pred_max``: max |X_pred, U_pred program - reference| over those lanes
  (the next step's schedule and warm start);
- ``doneat_split``: the share of all sampled lanes whose done-at (the
  iteration at which the lane passed the termination test) differs from
  the reference's.

``doneat_gap`` (the widest done-at difference) is printed beside them; it
swings by whole chunks from a single lane at the test's threshold, so it
is not compared.
"""

from __future__ import annotations

import torch

from benchmark.reference import tracker as ref

CARRY_KEYS = ("x", "X_pred", "U_pred", "s", "lam", "u_prev", "rho")


def lanes_of(groups, B: int, device):
    """The lanes of the given 128-lane groups (below B)."""
    g = torch.as_tensor(groups, device=device, dtype=torch.long)
    lanes = (g[:, None] * ref.GROUP + torch.arange(ref.GROUP, device=device)[None]).reshape(-1)
    return lanes[lanes < B]


def take(d: dict, lanes) -> dict:
    """The given lanes of a batch-last dict, as contiguous float32 copies."""
    return {k: v.index_select(-1, lanes).to(torch.float32).contiguous() for k, v in d.items()}


def init_gap(program_carry: dict, ref_carry: dict) -> float:
    return max(float((program_carry[k] - ref_carry[k]).abs().max()) for k in CARRY_KEYS)


def _usable(S, o):
    fb = float(S.solver["eps_fallback"])
    return o["converged"].to(torch.bool) | ((o["r_prim"] < fb) & (o["r_dual"] < fb))


def step_gaps(S, prog: dict, want: dict) -> dict:
    """The numbers of one sampled step over its lanes (whole 128-lane
    groups): ``prog`` the program's outputs, ``want`` the reference's."""
    n = prog["u0"].shape[-1]
    g = n // ref.GROUP
    grp = lambda t: t.reshape(t.shape[:-1] + (g, ref.GROUP))
    exit_p = grp(prog["iters"]).amax(dim=-1)
    exit_r = grp(want["iters"]).amax(dim=-1)
    same_branch = grp(_usable(S, prog) == _usable(S, want)).all(dim=-1)
    agree = (exit_p == exit_r) & same_branch                                   # (g,)
    keep = agree.repeat_interleave(ref.GROUP)
    split = float((prog["iters"] != want["iters"]).float().mean())
    if not bool(keep.any()):
        return {"groups_split": 1.0, "n_compared": 0, "doneat_split": split}
    d = lambda k: (prog[k] - want[k]).abs()[..., keep]
    du0 = d("u0").amax(dim=0)
    return {"groups_split": float(1.0 - agree.float().mean()), "n_compared": int(keep.sum()),
            "doneat_split": split,
            "du0": du0, "x_max": float(d("x").max()),
            "pred_max": max(float(d("X_pred").max()), float(d("U_pred").max())),
            "doneat_gap": float(d("iters").max())}


def reduce(steps: list, init: float) -> dict:
    """The cell's numbers over every sampled step."""
    du0 = [s["du0"] for s in steps if "du0" in s]
    out = {"init_gap": init, "groups_split": max(s["groups_split"] for s in steps),
           "doneat_split": max(s["doneat_split"] for s in steps)}
    if du0:
        du0 = torch.cat(du0).double()
        out.update(u0_p99=float(torch.quantile(du0, 0.99)), u0_max=float(du0.max()),
                   x_max=max(s.get("x_max", 0.0) for s in steps),
                   pred_max=max(s.get("pred_max", 0.0) for s in steps),
                   doneat_gap=max(s.get("doneat_gap", 0.0) for s in steps))
    else:
        out.update(u0_p99=float("inf"), u0_max=float("inf"), x_max=float("inf"),
                   pred_max=float("inf"), doneat_gap=float("inf"))
    out["lane_steps_compared"] = sum(s["n_compared"] for s in steps)
    return out


def verdict(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]) : every limited number at or below
    its limit. A number that is not finite fails."""
    rows = [(k, float(numbers[k]), float(v)) for k, v in limits.items()]
    ok = all(val == val and val <= lim for _, val, lim in rows)
    return ok, rows
