"""Mean ADMM done-at per lane-step over the window: the iteration at which
each lane passed OSQP's termination test (its own, not its 128-lane
group's), ``max_iter`` where it never did; read from the kernel's
per-lane output."""


def read(run):
    if run.steps == 0:
        return None
    return run.iters_sum / (run.steps * run.lanes)
