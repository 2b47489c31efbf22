"""Process start to the window's start, seconds: loading, weights, pool,
graph captures, and the traffic's own set-up (pre-roll or cache build)."""


def read(run):
    return run.setup_s
