"""Mean host wall ms of the window's steps that carried a prefilling row
(dispatch to the sampled ids on the host)."""


def read(run):
    return run.step_ms([s for s in run.window_steps() if s.prefill])
