"""Mean host wall ms of the window's steps at C = 1."""


def read(run):
    return run.step_ms([s for s in run.window_steps() if s.width == 1])
