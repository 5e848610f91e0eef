"""95th percentile, over every step of the window, of the interval between
CUDA events recorded on the stream at consecutive step boundaries (a host
stall lands in the step that waited for it)."""

import numpy as np


def read(run):
    return float(np.percentile(run.step_ms, 95)) if len(run.step_ms) else None
