"""K1 at C = 1 in the traced sub-window: the bytes its launches need (each
row's query and output, every live key and value once; counted over the
steps' page tables) at the card's HBM peak, over K1's device time,
percent."""
from agentbench import flops


def read(run):
    pk = flops.peaks(run.device_name)
    if run.trace is None or pk is None:
        return None
    need = took = 0.0
    for seq in run.trace.steps:
        s = run.step(seq)
        if s is None or s.width != 1 or not run.trace.k1_s.get(seq):
            continue
        need += run.kind.decode_attention_bytes(
            run.dims, [ctx for ctx, _, _ in s.rows], run.kv_itemsize) / pk[1]
        took += run.trace.k1_s[seq]
    return 100.0 * need / took if took else None
