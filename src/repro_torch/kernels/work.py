"""The work of each kernel call, and the count the dry-run and the card
both take of it.

``torch.utils.flop_counter.FlopCounterMode`` counts the aten operations of
a step by their shapes; it cannot see a kernel launched through ctypes.
Each wrapper therefore adds its call's operations here, on ``cuda`` and on
``meta`` alike, with one formula per kernel: the count ``chip_smoke.py``
hands to its bound, so the bound and the count cannot drift apart. Where
the work depends on the lengths (K1, K2, K4 with per-row lengths), the
formula counts what these lengths need; a ``meta`` tensor holds none, so
counting such a call on ``meta`` raises.

Counting is off unless a ``count_work`` is open: the serving path pays
nothing for it.

    with count_work() as w:
        step(...)
    w.flops   # {"K3": operations, ...}
    w.calls   # {"K3": calls, ...}
"""
from __future__ import annotations

from collections import Counter
from typing import Callable, List

import torch

_open: List["count_work"] = []


class count_work:
    """Adds every kernel call made while it is open (on any thread) to
    ``flops`` and ``calls``, keyed K1-K5."""

    def __init__(self):
        self.flops: Counter = Counter()
        self.calls: Counter = Counter()

    def __enter__(self):
        _open.append(self)
        return self

    def __exit__(self, *exc):
        _open.remove(self)
        return False


def add(kernel: str, flops: Callable[[], int]) -> None:
    """One call of ``kernel`` doing ``flops()`` operations, to every open
    count (``flops`` is not called when none is open)."""
    if not _open:
        return
    n = int(flops())
    for w in _open:
        w.flops[kernel] += n
        w.calls[kernel] += 1


def lengths(x, b: int, what: str) -> List[int]:
    """``x`` (an int, or a (b,) tensor) as b ints; a ``meta`` tensor holds
    no values and raises."""
    if not torch.is_tensor(x):
        return [int(x)] * b
    if x.device.type == "meta":
        raise ValueError(f"{what} is a meta tensor: the work depends on the "
                         "lengths, which meta does not hold; pass an int")
    return [int(v) for v in x.reshape(-1).tolist()]


def _min_sum(lo: int, hi: int, cap: int) -> int:
    """sum of min(j, cap) for j in [lo, hi]."""
    if hi < lo:
        return 0
    top = min(hi, cap)
    below = (lo + top) * (top - lo + 1) // 2 if top >= lo else 0
    return below + max(0, hi - max(top, lo - 1)) * cap


def k1_flops(cache_lens: List[int], valids: List[int], C: int, hq: int,
             d: int, dv: int) -> int:
    """K1, chunked prefill over pages: query i of row r (at position
    cache_lens[r] + i) sees min(cache_lens[r] + i + 1, kv_len) keys,
    kv_len = max(cache_lens[r] + valids[r], 1); 2 (d + dv) operations per
    visible key and query head."""
    total = 0
    for off, val in zip(cache_lens, valids):
        kv_len = max(off + val, 1)
        total += _min_sum(off + 1, off + C, kv_len)
    return total * hq * 2 * (d + dv)


def k2_flops(lens: List[int], hq: int, d: int, dv: int) -> int:
    """K2, paged decode: row r's query sees lens[r] keys."""
    return sum(lens) * hq * 2 * (d + dv)


def k3_flops(b: int, sq: int, skv: int, hq: int, d: int, dv: int,
             causal: bool) -> int:
    """K3, flash attention: causal query i sees min(i + 1, skv) keys, else
    every one of skv."""
    pairs = _min_sum(1, sq, skv) if causal else sq * skv
    return b * pairs * hq * 2 * (d + dv)


def k4_flops(lens: List[int], hq: int, d: int, dv: int) -> int:
    """K4, decode over a contiguous cache: row r's query sees lens[r]
    keys."""
    return sum(lens) * hq * 2 * (d + dv)


def k5_flops(b: int, s: int, h: int, p: int, g: int, n: int, L: int) -> int:
    """K5, the SSD chunked scan in chunks of L: C.B^T over the causal half
    once per (row, group, chunk), and per head M @ x over that half, C @ S,
    the state update, and the three products that make each entry of M."""
    nc = s // L
    half = L * (L + 1) // 2
    return (b * nc * g * half * 2 * n
            + b * nc * h * (half * (2 * p + 3) + 2 * 2 * L * n * p))
