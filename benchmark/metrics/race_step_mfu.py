"""The composed race step's share of the card's float32 peak: the
operations one step needs per lane (counts/racestep_kernel.py: the
measurement, the EKF, the RLS, the reference rows, the solve at each lane's
own done-at and the world-frame plant), over all lanes and steps of the
traced run's untraced first half, per second of that half (as step_mfu
reads the tracker's step)."""

from benchmark import peaks
from benchmark.counts.racestep_kernel import step_ops


def read(run):
    pk = peaks.for_device(run.device_kind)
    if pk is None or run.trace is None or run.plain_steps == 0 or run.steps == 0:
        return None
    iters = run.iters_sum / (run.steps * run.lanes)
    return 100.0 * step_ops(run.setup, iters) * run.lanes * run.plain_steps / run.plain_s / pk.f32_flops
