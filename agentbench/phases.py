"""The program's flight recorder read beside the device trace: where the
device's idle time goes, host phase by host phase, and the turns' waits as
the program stamps them.

    python3 -m agentbench.phases --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

runs ``agentbench.run``'s run of the cell with the program's flight
recorder on (``repro_torch.obs``, sized to hold the whole run), prints the
run's own result line, and then one JSON object on standard error that
begins ``{"phases":``. ``run.py`` and ``stack.py`` take no recorder, so
this entry point hands the engine one by wrapping the names they call
(``recording``); the readers below are plain functions of the recorder's
events (``FlightRecorder.events()``: times on the host's
``perf_counter``, the benchmark's clock) and of the profiler's kernel
intervals.

  * ``idle_split``: each idle interval of the traced sub-window (no kernel
    running) put down to the innermost dispatcher-thread span covering it:
    the engine's phases (``engine.admit`` .. ``engine.bookkeep``) and the
    dispatcher's pass (``sched.pass``, ``sched.charge``, ``sched.wait``);
    what no span covers (the benchmark's own wrapper around a step) is
    ``uncovered``. ``shares`` groups it: host (admit, pack, stage, launch,
    bookkeep, pass, charge), replay (readback: the host waits on the
    device, so the gap lies inside the replay), wait, uncovered; the four
    add up to the device's idle share.
  * ``step_phases``: each phase's host milliseconds over the window's
    steps, by step kind (decode: C = 1; mixed: C > 1), and
    ``step_host_ms``: admit + pack + stage + launch + bookkeep a step.
  * ``mlfq_queued_s``: each window turn's MLFQ waits summed over its
    ``sched.admitted`` episodes (the first admission, and one after each
    preemption).
  * ``engine_ttft_s``: each window turn's ``session.enqueued`` to its first
    ``session.token``, joined by ``sched.started`` (tid, rid).
  * ``preemptions_per_turn``: ``rm.preemptions`` over the window, a turn.

A window turn is one whose ``sched.submitted`` lies inside the window.
Every reader gives None where the recorder dropped events.
"""
from __future__ import annotations

import contextlib
import heapq
import json
import math
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from agentbench.spec import ROOT
from agentbench.view import INF, quantile

CAPACITY = 1 << 21          # events: the longest cell's run holds ~0.3M
ENGINE = ("admit", "pack", "stage", "launch", "readback", "bookkeep")
SCHED = ("pass", "charge", "wait")
HOST = ("admit", "pack", "stage", "launch", "bookkeep", "pass", "charge")
STEP_HOST = ("admit", "pack", "stage", "launch", "bookkeep")
LABELS = {**{f"engine.{p}": p for p in ENGINE},
          **{f"sched.{p}": p for p in SCHED}}

Interval = Tuple[float, float]


# ------------------------------------------------------------ the idle split
def idle_intervals(busy: Sequence[Interval], lo: float, hi: float
                   ) -> List[Interval]:
    """The gaps of ``busy`` (sorted, disjoint) inside [lo, hi]."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


def timeline(spans: Sequence[Tuple[float, float, str]]
             ) -> List[Tuple[float, float, str]]:
    """``spans`` (start, end, label), possibly nested, as disjoint
    segments each labelled by the innermost span covering it (the one that
    started last)."""
    spans = sorted(s for s in spans if s[1] > s[0])
    points = sorted({p for a, b, _ in spans for p in (a, b)})
    out: List[Tuple[float, float, str]] = []
    live: List[Tuple[float, float, str]] = []      # (-start, end, label)
    i = 0
    for p, q in zip(points, points[1:]):
        while i < len(spans) and spans[i][0] <= p:
            a, b, lab = spans[i]
            heapq.heappush(live, (-a, b, lab))
            i += 1
        # a span that ended under a later one stays in the heap until it
        # surfaces; the top is then the innermost still open
        while live and live[0][1] <= p:
            heapq.heappop(live)
        if live:
            lab = live[0][2]
            if out and out[-1][2] == lab and out[-1][1] == p:
                out[-1] = (out[-1][0], q, lab)
            else:
                out.append((p, q, lab))
    return out


def idle_split(busy: Sequence[Interval], lo: float, hi: float,
               spans: Sequence[Tuple[float, float, str]]) -> Dict[str, float]:
    """Seconds of [lo, hi] with no interval of ``busy`` (sorted, disjoint)
    running, by the label of the innermost span covering them;
    ``uncovered`` where none does."""
    idle = idle_intervals(busy, lo, hi)
    segs = timeline(spans)
    out = {lab: 0.0 for lab in (*ENGINE, *SCHED, "uncovered")}
    j = 0
    for a, b in idle:
        covered = 0.0
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            s0, s1, lab = segs[k]
            d = min(b, s1) - max(a, s0)
            if d > 0:
                out[lab] = out.get(lab, 0.0) + d
                covered += d
            k += 1
        out["uncovered"] += (b - a) - covered
    return out


def shares(split: Dict[str, float], window_s: float) -> Dict[str, float]:
    """The split as percent of the sub-window: host, replay, wait,
    uncovered, and their sum (the device's idle share)."""
    pct = {"host": sum(split.get(p, 0.0) for p in HOST),
           "replay": split.get("readback", 0.0),
           "wait": split.get("wait", 0.0),
           "uncovered": split.get("uncovered", 0.0)}
    pct = {k: 100.0 * v / window_s for k, v in pct.items()}
    pct["idle"] = sum(pct.values())
    return pct


def dispatcher_spans(events: List[Dict], on_trace) -> List[
        Tuple[float, float, str]]:
    """The dispatcher thread's spans, on the trace's clock."""
    return [(on_trace(e["ts"]), on_trace(e["ts"] + e["dur"]),
             LABELS[e["name"]]) for e in events
            if e["ph"] == "X" and e["name"] in LABELS]


# --------------------------------------------------------------- host phases
def window_steps(events: List[Dict], start: float, end: float
                 ) -> Dict[int, Dict]:
    """seq -> {"C", phase: seconds} for the megasteps inside [start, end]."""
    steps = {int(e["args"]["seq"]): {"C": int(e["args"]["C"])}
             for e in events if e["name"] == "engine.megastep"
             and start <= e["ts"] and e["ts"] + e["dur"] <= end}
    for e in events:
        p = LABELS.get(e["name"])
        if p in ENGINE:
            s = steps.get(int(e["args"]["seq"]))
            if s is not None:
                s[p] = e["dur"]
    return steps


def step_phases(steps: Dict[int, Dict]) -> Dict[str, Dict[str, List[float]]]:
    """kind -> phase -> [mean ms, p95 ms], kinds ``decode`` (C = 1) and
    ``mixed``; phase ``host`` is ``STEP_HOST`` summed."""
    out: Dict[str, Dict[str, List[float]]] = {}
    for kind in ("decode", "mixed"):
        group = [s for s in steps.values() if (s["C"] == 1) == (
            kind == "decode")]
        if not group:
            continue
        out[kind] = {}
        for p in (*ENGINE, "host"):
            xs = [1e3 * (sum(s.get(q, 0.0) for q in STEP_HOST)
                         if p == "host" else s.get(p, 0.0)) for s in group]
            out[kind][p] = [sum(xs) / len(xs), quantile(xs, 0.95)]
        out[kind]["steps"] = len(group)
    return out


def step_host_ms(steps: Dict[int, Dict]) -> Optional[float]:
    """Mean over the steps of admit + pack + stage + launch + bookkeep."""
    if not steps:
        return None
    return 1e3 * sum(sum(s.get(p, 0.0) for p in STEP_HOST)
                     for s in steps.values()) / len(steps)


# --------------------------------------------------------------------- turns
def window_tids(events: List[Dict], start: float, end: float) -> List[int]:
    return [int(e["args"]["tid"]) for e in events
            if e["name"] == "sched.submitted" and start <= e["ts"] < end]


def mlfq_queued_s(events: List[Dict], start: float, end: float
                  ) -> List[float]:
    """Each window turn's ``wait_s`` summed over its admissions; a turn
    never admitted waits forever."""
    waits: Dict[int, float] = {}
    for e in events:
        if e["name"] == "sched.admitted":
            tid = int(e["args"]["tid"])
            waits[tid] = waits.get(tid, 0.0) + e["args"]["wait_s"]
    return [waits.get(t, INF) for t in window_tids(events, start, end)]


def engine_ttft_s(events: List[Dict], start: float, end: float
                  ) -> List[float]:
    """Each window turn's engine enqueue to its first token, on the
    engine's stamps; a turn with no first token is infinite."""
    began: Dict[int, Tuple[int, float]] = {}
    enq: Dict[int, List[float]] = {}
    first: Dict[int, List[float]] = {}
    for e in events:
        n, a = e["name"], e["args"]
        if n == "sched.started" and not a["resumed"]:
            began.setdefault(int(a["tid"]), (int(a["rid"]), e["ts"]))
        elif n == "session.enqueued":
            enq.setdefault(int(a["rid"]), []).append(e["ts"])
        elif n == "session.token" and a["n_out"] == 1:
            first.setdefault(int(a["rid"]), []).append(e["ts"])
    out = []
    for tid in window_tids(events, start, end):
        if tid not in began:
            out.append(INF)
            continue
        rid, t = began[tid]
        q = [x for x in enq.get(rid, ()) if x <= t]
        if not q:
            out.append(INF)
            continue
        tok = [x for x in first.get(rid, ()) if x > q[-1]]
        out.append(tok[0] - q[-1] if tok else INF)
    return out


def preemptions_per_turn(at_start: Dict[str, float], at_end: Dict[str, float],
                         turns: int) -> Optional[float]:
    if not turns:
        return None
    return (at_end["rm.preemptions"] - at_start["rm.preemptions"]) / turns


def p95_ms(values: List[float]) -> Optional[float]:
    q = quantile(values, 0.95)
    return None if q is None or not math.isfinite(q) else 1e3 * q


# ---------------------------------------------------------------- the run
def counters(metrics) -> Dict[str, float]:
    return {n: s["value"] for n, s in metrics.snapshot().items()
            if s["type"] == "counter"}


@contextlib.contextmanager
def recording(capacity: int = CAPACITY):
    """``agentbench.run``'s run with the engine built on a flight recorder
    of ``capacity`` events. Yields a dict that the run fills: ``engine``,
    ``tracer`` (traced runs), ``window`` (start, end), the registry's
    counters ``at_start`` / ``at_end`` of the window (the latter read on
    the client's first pass past the close), and ``out`` (``execute``'s
    result)."""
    from repro_torch.obs import Observability, TraceConfig

    from agentbench import client, run, stack, trace
    got: Dict = {}
    real = (stack.PagedInferenceEngine, trace.read, client.drive,
            run.execute)

    def engine(*a, **kw):
        kw["obs"] = Observability(TraceConfig(enabled=True,
                                              capacity=capacity))
        got["engine"] = real[0](*a, **kw)
        return got["engine"]

    def read(tracer, steps):
        got["tracer"] = tracer
        return real[1](tracer, steps)

    def drive(rm, backend, sessions, *, on_window=None, on_tick=None, **kw):
        m = rm.obs.metrics

        def window(start, end):
            got["window"] = (start, end)
            got["at_start"] = counters(m)
            if on_window is not None:
                on_window(start, end)

        def tick(now):
            w = got.get("window")
            if w is not None and now >= w[1] and "at_end" not in got:
                got["at_end"] = counters(m)
            if on_tick is not None:
                on_tick(now)
        return real[2](rm, backend, sessions, on_window=window,
                       on_tick=tick, **kw)

    def execute(*a, **kw):
        got["out"] = real[3](*a, **kw)
        return got["out"]

    stack.PagedInferenceEngine, trace.read = engine, read
    client.drive, run.execute = drive, execute
    try:
        yield got
    finally:
        (stack.PagedInferenceEngine, trace.read, client.drive,
         run.execute) = real


def device_busy(tracer):
    """The traced sub-window's kernel intervals (their union, clipped),
    its edges, and the map from the benchmark's clock onto the trace's,
    as ``trace.read`` takes them; None without device work."""
    from torch.autograd import DeviceType

    from agentbench.trace import _union
    base_ns = tracer.prof.profiler.kineto_results.trace_start_ns()
    wall_ns, perf = tracer.anchor

    def on_trace(t: float) -> float:
        return (wall_ns + (t - perf) * 1e9 - base_ns) / 1e9

    lo, hi = on_trace(tracer.t_start), on_trace(tracer.t_stop)
    ops = [(e.time_range.start / 1e6, e.time_range.end / 1e6)
           for e in tracer.prof.events() if e.device_type == DeviceType.CUDA]
    busy = _union([(max(a, lo), min(b, hi)) for a, b in ops
                   if b > lo and a < hi])
    return (busy, lo, hi, on_trace) if busy else None


def report(got: Dict) -> Dict:
    """What the run recorded, read: the nine quantities, the idle split
    and the host phases by step kind; None for each that has nothing to
    read (or where the recorder dropped events, with the reason)."""
    rec = got["engine"].obs.recorder
    view = got["out"]["view"]
    start, end = got["window"]
    out: Dict = {"dropped": rec.dropped, "recorded": rec.recorded}
    if rec.dropped:
        out["why_none"] = (f"the recorder dropped {rec.dropped} events of "
                           f"{rec.total}: its window is not whole")
        return out
    events = rec.events()
    steps = window_steps(events, start, end)
    out["step_phases_ms"] = step_phases(steps)
    out["step_host_ms"] = step_host_ms(steps)
    out["mlfq_queued_p95_ms"] = p95_ms(mlfq_queued_s(events, start, end))
    out["engine_ttft_p95_ms"] = p95_ms(engine_ttft_s(events, start, end))
    turns = len(window_tids(events, start, end))
    out["window_turns"] = turns
    out["preemptions_per_turn"] = preemptions_per_turn(
        got["at_start"], got["at_end"], turns) if "at_end" in got else None
    out["preempted_instants"] = sum(
        1 for e in events if e["name"] == "sched.preempted"
        and start <= e["ts"] < end)
    win = view.window_steps()
    out["step_wall_ms"] = {"window": view.step_ms(win)}
    tracer = got.get("tracer")
    if tracer is None or tracer.prof is None or not tracer.done:
        return out
    dev = device_busy(tracer)
    if dev is None:
        return out
    busy, lo, hi, on_trace = dev
    spans = [s for s in dispatcher_spans(events, on_trace)
             if s[1] > lo and s[0] < hi]
    split = idle_split(busy, lo, hi, spans)
    pct = shares(split, hi - lo)
    busy_s = sum(b - a for a, b in busy)
    out["idle_s"] = split
    out["shares_pct"] = pct
    out["device_idle_pct"] = 100.0 * (1.0 - busy_s / (hi - lo))
    out["identity_pp"] = abs(pct["idle"] - out["device_idle_pct"])
    traced = [view.step(s) for s in view.trace.steps] if view.trace else []
    out["step_wall_ms"]["sub_window"] = view.step_ms(
        [s for s in traced if s is not None])
    sub = window_steps(events, tracer.t_start, tracer.t_stop)
    out["sub_window_step_phases_ms"] = step_phases(sub)
    return out


def main(argv=None, *, device=None, root: Path = ROOT) -> int:
    from agentbench import run
    argv = list(sys.argv[1:] if argv is None else argv)
    run.prepare_process(root)           # the program on the path
    with recording() as got:
        rc = run.main(argv, device=device, root=root)
    if rc == 0:
        print(json.dumps({"phases": report(got)}), file=sys.stderr,
              flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
