"""1 - tokens written / token slots dispatched (max_batch x C), over the
window's steps."""


def read(run):
    steps = run.window_steps()
    slots = sum(s.width for s in steps) * run.max_batch
    if not slots:
        return None
    return 1.0 - sum(s.real for s in steps) / slots
