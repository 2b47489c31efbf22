"""95th percentile over the window's turns of due time to the dispatcher's
``begin_turn`` call for the turn (the MLFQ queue and admission)."""
from agentbench.view import INF, quantile


def read(run):
    waits = [t.log.t_begin - t.due if t.log.t_begin is not None else INF
             for t in run.measured()]
    q = quantile(waits, 0.95)
    return None if q is None else 1e3 * q
