"""The plain references a cell is held to, one file per reference, found by
the name that the workload's ``check.reference`` gives
(``reference/<name>.py``); a workload that names none is held to
``tracker``. A reference is plain PyTorch or numpy, independent of the
program under test: it imports nothing of the program and takes nothing
the program made but the carries and outputs it judges. Each defines:

- ``GROUP``: the lanes that leave the solve together; the comparison
  samples whole groups of this many lanes;
- ``setup_from_config(config)``: the configuration's numbers that the
  reference needs, handed back to ``compare`` and to the metric readers
  (``run.setup``);
- ``track(config, device)``: the track table, a dict with the lap's
  ``"length"`` (0-d), over which the scenario stream draws each lane's
  start, and ``"kappa"``, one curvature per cell;
- ``compare(ctx, S, table, route, samples, scen, lanes, controls)``: once
  the window has closed, the sampled steps ``samples`` ((state before,
  state after, sweep) of the route), the sweeps' scenarios ``scen`` and
  the sampled ``lanes``, judged against the reference stepped from the
  program's own carry. Returns ``(numbers, control numbers, info)``: the
  cell's numbers (the names its ``check.limits`` use), the same numbers
  for each precision in ``controls`` with the reference in the program's
  place, and ``info``, numbers printed and not compared. ``ctx`` is the
  route's (``routes/__init__.py``), the run's seed with it.

``track.py`` holds the track tables that references share; it is no
reference.
"""
