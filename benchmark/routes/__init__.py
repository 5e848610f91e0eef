"""Per-step drivers, one file per entry into the program, found by the
route's name (``routes/<route>.py``). Each defines ``make(ctx)`` returning
an object with:

- ``kernel``: the name its kernel carries in a device trace;
- ``lookup``, ``exact_done_at``: the curvature-index form and the
  done-at recording the tracker reference holds it to (a route held to
  another reference gives what that reference reads);
- ``start(scenarios) -> state``: the program's carry for a new sweep;
- ``step(state) -> state``: one closed-loop step of every lane;
- ``accumulate(acc, state)``: add each lane's converged flag and done-at
  into ``acc`` (2, B) on the device;
- ``carry(state)``, ``outputs(state)``: batch-last dicts of what a step
  starts from and what it produced, for the comparison;
- ``launches()``: the kernel launches the program has counted.

``ctx`` holds the cell's ``config`` (the configuration file's dict),
``device``, ``trace`` (the traced window is on) and ``seed`` (the run's).
A route that draws inputs of its own on every step (sensor noise, say)
draws them from a generator of its own seeded from ``seed``, never from
the scenario stream, so that the stream's draws do not move; its
reference is handed the same draws.

Each call into the program sits in a host span ``trace.span(ctx, name)``,
which the traced window records and the rest of a run skips.
"""
