"""What a run recorded, as the metric readers see it.

Turns are measured when they fell due inside the window; a turn that
failed or never finished counts as missing every limit (its latencies are
infinite). Steps are the window's when their span lies inside it and they
closed before the traced sub-window opens. Every tail is taken over all measured turns or all their
gaps, nearest rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

from agentbench import flops

INF = float("inf")


def quantile(values: List[float], q: float) -> Optional[float]:
    """Nearest-rank quantile; None for no values."""
    if not values:
        return None
    xs = sorted(values)
    return xs[max(0, math.ceil(q * len(xs)) - 1)]


@dataclasses.dataclass
class RunView:
    dims: Dict                      # the kind's ``dims`` of the config
    kind: object                    # the module ``kinds/<kind>.py``
    window: object                  # client.Window
    steps: List                     # stack.StepLog, every step of the run
    setup_s: float
    device_name: str
    max_batch: int
    kv_itemsize: int
    trace: Optional[object] = None  # trace.Reading

    def __post_init__(self):
        self._by_seq = {s.seq: s for s in self.steps}

    def step(self, seq: int):
        return self._by_seq.get(seq)

    @property
    def seconds(self) -> float:
        return self.window.end - self.window.start

    def measured(self) -> List:
        w = self.window
        return [t for t in w.turns if w.start <= t.due < w.end]

    def window_steps(self) -> List:
        w = self.window
        return [s for s in self.steps
                if w.start <= s.t0 and s.t1 <= w.end]

    def ttft_s(self) -> List[float]:
        return [t.log.stamps[0] - t.due if t.delivered is not None
                and t.log.stamps else INF for t in self.measured()]

    def turn_s(self) -> List[float]:
        return [t.log.stamps[-1] - t.due if t.delivered is not None
                and t.log.stamps else INF for t in self.measured()]

    def gaps_s(self) -> List[float]:
        out: List[float] = []
        for t in self.measured():
            if t.delivered is None:
                out.append(INF)
                continue
            s = t.log.stamps
            out.extend(b - a for a, b in zip(s, s[1:]))
        return out

    def tokens_in_window(self) -> int:
        w = self.window
        return sum(1 for t in w.turns for s in t.log.stamps
                   if w.start <= s < w.end)

    def step_ms(self, steps: List) -> Optional[float]:
        if not steps:
            return None
        return 1e3 * sum(s.t1 - s.t0 for s in steps) / len(steps)

    def mfu_percent(self, steps: List) -> Optional[float]:
        """Model FLOPs of the steps' real tokens over their wall time at
        the card's bf16 peak."""
        pk = flops.peaks(self.device_name)
        if not steps or pk is None:
            return None
        work = sum(self.kind.step_flops(self.dims, s.rows) for s in steps)
        return 100.0 * work / (sum(s.t1 - s.t0 for s in steps) * pk[0])
