"""Model FLOPs of the window's real tokens (the benchmark's own count) over
the steps' wall time at the card's bf16 peak, percent."""


def read(run):
    return run.mfu_percent(run.window_steps())
