"""95th percentile over the window's turns of due time to last token: when
the agent's tool call is complete and the tool can run."""
from agentbench.view import quantile


def read(run):
    q = quantile(run.turn_s(), 0.95)
    return None if q is None else 1e3 * q
