"""The whole step's share of the card's float32 peak: the operations one
closed-loop step needs per lane (the solve at each lane's own done-at, or
max_iter without early exit, and the plant), over all lanes and steps of
the traced run's untraced first half, per second of that half (the
profiler's host cost would slow the rate). Whatever route computes the
step, and whichever kernels it launches, the work counted is the same."""

from benchmark import peaks
from benchmark.counts.structure import step_ops


def read(run):
    pk = peaks.for_device(run.device_kind)
    if pk is None or run.trace is None or run.plain_steps == 0 or run.steps == 0:
        return None
    sv = run.config["solver"]
    iters = run.iters_sum / (run.steps * run.lanes) if sv["early_exit"] else float(sv["max_iter"])
    return 100.0 * step_ops(run.setup, iters) * run.lanes * run.plain_steps / run.plain_s / pk.f32_flops
