"""Every output token stamped inside the window, over the window's
length."""


def read(run):
    return run.tokens_in_window() / run.seconds
