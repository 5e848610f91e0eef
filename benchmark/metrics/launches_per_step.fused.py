"""Device operations (kernels, copies, sets) the profiler recorded in the
traced window, per closed-loop step: the eager work around the fused
kernel. A count; it repeats exactly."""


def read(run):
    if run.trace is None or run.steps == 0:
        return None
    return len(run.trace.ops) / run.steps
