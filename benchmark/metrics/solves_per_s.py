"""Lane-steps completed in the window over the window's seconds (host
clock, the card synchronised at both ends): all the work over all the time."""


def read(run):
    return run.steps * run.lanes / run.window_s
