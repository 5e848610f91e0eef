"""Seconds from the process's start to the window's: imports, the CUDA
context, the kernel library (built on a checkout's first run), the inputs
and the warm-up steps."""


def read(run):
    return run.setup_s
