"""The traced sub-window of a ``--trace 1`` run, and what is read from it.

``Tracer`` runs ``torch.profiler`` (CPU and CUDA activity) from the client's
thread over ``seconds`` once its start time has come, and notes where the
trace's clock (nanoseconds since the epoch) stands against the benchmark's.
It starts and stops the profiler holding ``lock`` (the backend's step lock)
with the card idle, so no step's launches run while the profiler turns its
device tracing on or off. ``warm`` runs one profiler over a single kernel
in set-up, so that the profiler's first start, which loads and sets up
CUPTI for seconds, is not paid inside the load; ``pause_s`` is how long the
start in the load still held the steps and the submissions back, and
``stop_s`` how long the stop did (after the sub-window).
``read`` maps each step the backend timed into the trace by that anchor,
then gives the seconds the device was busy (the union of its operations'
intervals), the sub-window's length, the device operations that took most
time, the idle gaps labelled by what the host was doing (inside a step:
before its first kernel, between kernels, after its last; or between
steps), and each traced step's device seconds by kernel name, from which a
roofline reader takes its kernel's (K1's: ``Reading.k1_s``). A kernel
belongs to the step whose host span holds its start: a step ends once its
ids are on the host, so its kernels have run by then.
"""
from __future__ import annotations

import bisect
import dataclasses
import functools
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch

# the kernel names of K1, the paged attention of the megastep: at C = 1 the
# split route (partials, then their merge), at C > 1 the tensor-core tiles
K1_NAMES = ("paged_split_kernel", "paged_merge_kernel", "paged_tc_kernel",
            "paged_walk_kernel")


class Tracer:

    def __init__(self, seconds: float, clock, lock):
        self.seconds, self.clock, self.lock = seconds, clock, lock
        self.start_at: Optional[float] = None
        self.prof = None
        self.t_start = self.t_stop = None
        self.anchor: Tuple[int, float] = (0, 0.0)
        self.pause_s: Optional[float] = None
        self.stop_s: Optional[float] = None

    @staticmethod
    def warm(device):
        """One profiler started and stopped over one kernel (set-up)."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1, device=device).add_(1)
            _idle()

    @property
    def done(self) -> bool:
        return self.t_stop is not None

    def tick(self, now: float):
        if self.start_at is None or self.done or now < self.start_at:
            return
        if self.prof is None:
            from torch.profiler import ProfilerActivity, profile
            with self.lock:
                t = self.clock()
                _idle()
                self.prof = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                self.prof.start()
                self.t_start = self.clock()
                self.anchor = (time.time_ns(), self.t_start)
                self.pause_s = self.t_start - t
        elif now >= self.t_start + self.seconds:
            self.stop()

    def stop(self):
        if self.prof is None or self.done:
            return
        with self.lock:
            _idle()
            self.t_stop = self.clock()
            self.prof.stop()
            self.stop_s = self.clock() - self.t_stop


def _idle():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@dataclasses.dataclass
class Reading:
    busy_s: float
    window_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    # step seq -> {kernel name: device seconds}, every traced step
    kernel_s: Dict[int, Dict[str, float]]
    steps: List[int]                # the traced steps' seqs
    attributed: float               # share of device time inside steps

    def seconds(self, seq: int, names: Iterable[str]) -> float:
        """Step ``seq``'s device seconds in kernels whose name holds one
        of ``names``."""
        return sum((t for k, t in self.kernel_s.get(seq, {}).items()
                    if any(n in k for n in names)), 0.0)

    @functools.cached_property
    def k1_s(self) -> Dict[int, float]:
        """step seq -> K1 device seconds."""
        return {seq: self.seconds(seq, K1_NAMES) for seq in self.kernel_s}


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class _Spans:
    """Steps' host spans on the trace's clock, found by time."""

    def __init__(self, spans: List[Tuple[int, float, float]]):
        self.spans = sorted(spans, key=lambda s: s[1])
        self.starts = [a for _, a, _ in self.spans]

    def at(self, t: float) -> Optional[int]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t <= self.spans[i][2]:
            return self.spans[i][0]
        return None


def _label(a: float, b: float, spans: _Spans, first: Dict[int, float],
           last: Dict[int, float]) -> str:
    seq = spans.at((a + b) / 2)
    if seq is None:
        return "between steps (AgentRM pass, waiting for arrivals)"
    if seq not in first or b <= first[seq]:
        return "step: before its first kernel (admit, pack, stage)"
    if a >= last[seq]:
        return "step: after its last kernel (readback, bookkeeping)"
    return "step: between its kernels (host launches)"


def read(tracer: Tracer, steps: List) -> Optional[Reading]:
    """``steps``: the backend's StepLogs. None where nothing ran on the
    device in the sub-window."""
    if tracer.prof is None or not tracer.done:
        return None
    from torch.autograd import DeviceType
    base_ns = tracer.prof.profiler.kineto_results.trace_start_ns()
    wall_ns, perf = tracer.anchor

    def on_trace(t: float) -> float:
        return (wall_ns + (t - perf) * 1e9 - base_ns) / 1e9

    traced = [s for s in steps if tracer.t_start <= s.t0
              and s.t1 <= tracer.t_stop]
    ops = [(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
           for e in tracer.prof.events() if e.device_type == DeviceType.CUDA]
    return reduce(ops, [(s.seq, on_trace(s.t0), on_trace(s.t1))
                        for s in traced],
                  on_trace(tracer.t_start), on_trace(tracer.t_stop))


def reduce(ops: List[Tuple[str, float, float]],
           spans: List[Tuple[int, float, float]], lo: float,
           hi: float) -> Optional[Reading]:
    """The reading of device operations ``ops`` (name, start, end) and the
    traced steps' host ``spans`` (seq, start, end) in the sub-window
    [lo, hi], all in seconds on the trace's clock. None where no operation
    ran in it."""
    busy = _union([(max(a, lo), min(b, hi)) for _, a, b in ops
                   if b > lo and a < hi])
    if not busy:
        return None
    found = _Spans(spans)
    by_name: Dict[str, float] = {}
    first: Dict[int, float] = {}
    last: Dict[int, float] = {}
    kernel_s: Dict[int, Dict[str, float]] = {seq: {} for seq, _, _ in spans}
    inside = total = 0.0
    for name, a, b in ops:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        total += b - a
        seq = found.at(a)
        if seq is None:
            continue
        inside += b - a
        first[seq] = min(first.get(seq, a), a)
        last[seq] = max(last.get(seq, b), b)
        kernel_s[seq][name] = kernel_s[seq].get(name, 0.0) + (b - a)
    gaps: Dict[str, float] = {}
    longest: Dict[str, float] = {}
    edges = [(lo, lo)] + busy + [(hi, hi)]
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b > a:
            lab = _label(a, b, found, first, last)
            gaps[lab] = gaps.get(lab, 0.0) + (b - a)
            longest[lab] = max(longest.get(lab, 0.0), b - a)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])
    idle += sorted(((f"longest single gap, {k}", v)
                    for k, v in longest.items()), key=lambda kv: -kv[1])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return Reading(busy_s=sum(b - a for a, b in busy), window_s=hi - lo,
                   device_ops=[(n[:120], s) for n, s in top],
                   idle_gaps=idle[:10], kernel_s=kernel_s,
                   steps=[seq for seq, _, _ in spans],
                   attributed=inside / total if total else 0.0)
