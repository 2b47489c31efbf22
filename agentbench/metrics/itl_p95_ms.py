"""95th percentile of every gap between consecutive tokens of the window's
turns (a failed turn's gap is infinite)."""
from agentbench.view import quantile


def read(run):
    q = quantile(run.gaps_s(), 0.95)
    return None if q is None else 1e3 * q
