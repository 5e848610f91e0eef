"""One reader per metric, found by the metric's name
(``metrics/<metric>.py``): ``read(run) -> float | None``. ``run`` carries
the cell's configuration, the window's steps, lanes and seconds, the
per-step intervals, the summed converged flags and done-ats, the set-up
seconds and, in a traced run, the reduced device trace. A reader that
finds nothing to read returns None, and the metric is left out."""
