"""95th percentile over the window's turns of due time to first token."""
from agentbench.view import quantile


def read(run):
    q = quantile(run.ttft_s(), 0.95)
    return None if q is None else 1e3 * q
