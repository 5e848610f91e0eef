"""Per-step drivers, one file per entry into the program, found by the
route's name (``routes/<route>.py``). Each defines ``make(ctx)`` returning
an object with:

- ``kernel``: the name its kernel carries in a device trace;
- ``lookup``, ``exact_done_at``: the curvature-index form and the
  done-at recording the reference holds it to;
- ``start(scenarios) -> state``: the program's carry for a new sweep;
- ``step(state) -> state``: one closed-loop step of every lane;
- ``accumulate(acc, state)``: add each lane's converged flag and done-at
  into ``acc`` (2, B) on the device;
- ``carry(state)``, ``outputs(state)``: batch-last dicts of what a step
  starts from and what it produced, for the comparison;
- ``launches()``: the kernel launches the program has counted.

Each call into the program sits in a host span ``trace.span(ctx, name)``,
which the traced window records and the rest of a run skips.
"""
