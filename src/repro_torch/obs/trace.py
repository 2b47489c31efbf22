"""Flight-recorder tracing (DESIGN.md §12).

A ring-buffer event log for the fused serving stack:

  * **Fixed capacity.** Events live in parallel Python lists sized at
    construction (timestamp, duration, interned name id, interned track
    id, up to four numeric args); recording an event is a handful of list
    slot stores, with no string hashing and no growth. The stored floats
    are the objects the caller's clock read and arguments already made.
    When the ring is full the oldest events are overwritten —
    flight-recorder semantics — and ``dropped`` counts the casualties, so
    a reader always knows whether the window is complete.
  * **One clock.** Every timestamp is host ``time.perf_counter()``
    (monotonic, sub-microsecond). There are deliberately NO device-side
    timestamps: a device clock read would need a host sync inside the
    captured step. At construction and at ``reset()`` the recorder takes
    a pair (``perf_counter``, ``time.time_ns()``); ``epoch_ns(t)`` puts a
    timestamp on the Unix epoch, the clock a device trace of
    ``torch.profiler`` also reads (its Chrome export writes ``ts`` as
    microseconds after its ``baseTimeNanoseconds``; base plus ``ts`` is
    the epoch time).
  * **Spans and instants.** A span is a Chrome "complete" event recorded
    at its end, from a begin timestamp the caller took with ``now()``
    (``complete``), or from both ends (``interval``, for a chain of phases
    whose boundaries the caller stamped once each); an instant is a point
    event. Interning (``name()``, ``track()``) happens once at
    instrumentation-setup time.
  * **Export.** ``chrome()`` / ``export_chrome`` give Chrome trace-event
    JSON that loads in Perfetto / chrome://tracing, ``ts`` in microseconds
    since the Unix epoch; tracks are (pid, tid) pairs derived from the
    registered track groups (one process row per group: engine, engine
    rows, sessions, mlfq, sched). ``validate_chrome`` is its schema check.

A disabled recorder (``TraceConfig(enabled=False)``, the default) keeps
the full API but drops every event before touching the buffer; hot paths
also test ``enabled`` themselves, so that with the recorder off they read
no clock for it.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["TraceConfig", "FlightRecorder", "validate_chrome"]

_INSTANT, _SPAN = 0, 1


@dataclasses.dataclass
class TraceConfig:
    """Gates the flight recorder. Off by default; its budget when on is
    <= 2% of a step's wall time (DESIGN.md §12)."""
    enabled: bool = False
    capacity: int = 1 << 16      # events; 9 list slots (72 B) each

    def __post_init__(self):
        if self.capacity < 16:
            raise ValueError(
                f"trace capacity {self.capacity} too small: the ring must "
                "hold at least 16 events (one megastep's worth with "
                "headroom) to be a usable flight recorder")
        if self.capacity > (1 << 24):
            raise ValueError(
                f"trace capacity {self.capacity} too large: the ring is "
                "preallocated host memory; cap it at 2^24 events (~700 MB)")


class FlightRecorder:
    """Preallocated ring-buffer trace log with drop-oldest semantics."""

    def __init__(self, config: Optional[TraceConfig] = None):
        self.config = config or TraceConfig()
        self.enabled = self.config.enabled
        n = self.config.capacity
        self.capacity = n
        # Hot-path ring: parallel preallocated Python lists. A plain list
        # slot store is ~2.5x cheaper than a numpy scalar assignment; the
        # values stored are the caller's (floats from perf_counter() and
        # args, interned small ints). Decoded only at export, in events().
        self._ts = [0.0] * n
        self._dur = [0.0] * n
        self._ph = [0] * n
        self._name = [0] * n
        self._track = [0] * n
        self._a0 = [0.0] * n
        self._a1 = [0.0] * n
        self._a2 = [0.0] * n
        self._a3 = [0.0] * n
        self._total = 0                       # events ever recorded
        # interning tables: id 0 is reserved for "unnamed"/"main" so a
        # disabled recorder can hand out 0 without registering anything
        self._names: List[Tuple[str, Tuple[str, ...]]] = [("event", ())]
        self._name_ids: Dict[str, int] = {"event": 0}
        self._tracks: List[Tuple[str, str]] = [("main", "main")]
        self._track_ids: Dict[Tuple[str, str], int] = {("main", "main"): 0}
        self._anchor()

    def _anchor(self):
        """The (perf_counter, epoch ns) pair ``epoch_ns`` maps by: the
        epoch read between two perf_counter reads, set at their middle."""
        a = time.perf_counter()
        wall = time.time_ns()
        self._epoch = ((a + time.perf_counter()) / 2, wall)

    def epoch_ns(self, t: float) -> int:
        """A ``now()`` timestamp as nanoseconds since the Unix epoch."""
        perf, wall = self._epoch
        return wall + round((t - perf) * 1e9)

    # ------------------------------------------------------ interning
    def name(self, label: str, arg_labels: Sequence[str] = ()) -> int:
        """Intern an event name (+ the labels its numeric args carry in
        exports). Call once at instrumentation-setup time."""
        nid = self._name_ids.get(label)
        if nid is None:
            nid = len(self._names)
            self._names.append((label, tuple(arg_labels)))
            self._name_ids[label] = nid
        return nid

    def track(self, label: str, group: str = "main") -> int:
        """Intern a display track. ``group`` becomes the Perfetto process
        row (pid); each track in it a thread row (tid)."""
        key = (group, label)
        tid = self._track_ids.get(key)
        if tid is None:
            tid = len(self._tracks)
            self._tracks.append((label, group))
            self._track_ids[key] = tid
        return tid

    # ------------------------------------------------------- recording
    @staticmethod
    def now() -> float:
        return time.perf_counter()

    def _emit(self, ph: int, name_id: int, track_id: int, ts: float,
              dur: float, a0: float, a1: float, a2: float, a3: float):
        i = self._total % self.capacity
        self._ts[i] = ts
        self._dur[i] = dur
        self._ph[i] = ph
        self._name[i] = name_id
        self._track[i] = track_id
        self._a0[i] = a0
        self._a1[i] = a1
        self._a2[i] = a2
        self._a3[i] = a3
        self._total += 1

    # instant/complete inline the _emit body: one less call frame per
    # event on the per-token hot path (the default-arg _clock binding
    # skips the time-module attribute lookup each call)
    def instant(self, name_id: int, track_id: int, a0: float = 0.0,
                a1: float = 0.0, a2: float = 0.0, a3: float = 0.0,
                _clock=time.perf_counter):
        if not self.enabled:
            return
        i = self._total % self.capacity
        self._ts[i] = _clock()
        self._dur[i] = 0.0
        self._ph[i] = _INSTANT
        self._name[i] = name_id
        self._track[i] = track_id
        self._a0[i] = a0
        self._a1[i] = a1
        self._a2[i] = a2
        self._a3[i] = a3
        self._total += 1

    def complete(self, name_id: int, track_id: int, t0: float,
                 a0: float = 0.0, a1: float = 0.0, a2: float = 0.0,
                 a3: float = 0.0, _clock=time.perf_counter):
        """Record a span that began at ``t0`` (from ``now()``) and ends
        now."""
        if not self.enabled:
            return
        dur = _clock() - t0
        i = self._total % self.capacity
        self._ts[i] = t0
        self._dur[i] = dur if dur > 0.0 else 0.0
        self._ph[i] = _SPAN
        self._name[i] = name_id
        self._track[i] = track_id
        self._a0[i] = a0
        self._a1[i] = a1
        self._a2[i] = a2
        self._a3[i] = a3
        self._total += 1

    def interval(self, name_id: int, track_id: int, t0: float, t1: float,
                 a0: float = 0.0, a1: float = 0.0, a2: float = 0.0,
                 a3: float = 0.0):
        """Record a span from ``t0`` to ``t1`` (both from ``now()``)."""
        if not self.enabled:
            return
        self._emit(_SPAN, name_id, track_id, t0,
                   t1 - t0 if t1 > t0 else 0.0, a0, a1, a2, a3)

    # ------------------------------------------------------ accounting
    @property
    def recorded(self) -> int:
        """Events currently held in the ring."""
        return min(self._total, self.capacity)

    @property
    def total(self) -> int:
        return self._total

    @property
    def dropped(self) -> int:
        """Events overwritten by drop-oldest wraparound."""
        return max(0, self._total - self.capacity)

    def reset(self):
        self._total = 0
        self._anchor()

    # ------------------------------------------------------- exporting
    def events(self) -> List[dict]:
        """Decode the ring into dicts sorted by timestamp (the ring is not
        time-ordered after wraparound). Allocation-heavy; export-time
        only."""
        n = self.recorded
        if n == 0:
            return []
        if self._total <= self.capacity:
            idx = list(range(n))
        else:                       # ring wrapped: oldest is at write head
            head = self._total % self.capacity
            idx = list(range(head, self.capacity)) + list(range(head))
        idx.sort(key=self._ts.__getitem__)       # stable, like the ring
        av = (self._a0, self._a1, self._a2, self._a3)
        out = []
        for i in idx:
            name, labels = self._names[self._name[i]]
            tlabel, group = self._tracks[self._track[i]]
            args = {lab: av[j][i] for j, lab in enumerate(labels)}
            out.append({
                "name": name, "track": tlabel, "group": group,
                "ph": "X" if self._ph[i] == _SPAN else "i",
                "ts": self._ts[i], "dur": self._dur[i],
                "args": args,
            })
        return out

    def _pids_tids(self) -> Dict[int, Tuple[int, int]]:
        """track id -> (pid, tid): pid per group, tid per track within."""
        groups: Dict[str, int] = {}
        per_group: Dict[str, int] = {}
        mapping = {}
        for tid_, (label, group) in enumerate(self._tracks):
            pid = groups.setdefault(group, len(groups) + 1)
            per_group[group] = per_group.get(group, 0) + 1
            mapping[tid_] = (pid, per_group[group])
        return mapping

    def chrome(self) -> dict:
        """Chrome trace-event JSON object: ``ts`` in microseconds since the
        Unix epoch (``epoch_ns``), ``dur`` in microseconds; metadata rows
        name each group/track."""
        mapping = self._pids_tids()
        evs: List[dict] = []
        seen_groups = set()
        for tid_, (label, group) in enumerate(self._tracks):
            pid, tid = mapping[tid_]
            if group not in seen_groups:
                seen_groups.add(group)
                evs.append({"ph": "M", "name": "process_name", "pid": pid,
                            "tid": 0, "args": {"name": group}})
            evs.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {"name": label}})
        for e in self.events():
            pid, tid = mapping[self._track_ids[(e["group"], e["track"])]]
            ev = {"name": e["name"], "ph": e["ph"], "pid": pid, "tid": tid,
                  "ts": self.epoch_ns(e["ts"]) / 1e3, "cat": e["group"],
                  "args": e["args"]}
            if e["ph"] == "X":
                ev["dur"] = e["dur"] * 1e6
            else:
                ev["s"] = "t"
            evs.append(ev)
        return {"traceEvents": evs, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped,
                              "clock_domain": "unix_epoch_us: host "
                              "perf_counter anchored to time.time_ns"}}

    def export_chrome(self, path: str):
        with open(path, "w") as f:
            json.dump(self.chrome(), f)


def validate_chrome(obj: dict) -> List[str]:
    """Schema check for an exported Chrome trace: returns a list of
    problems (empty = valid)."""
    problems = []
    evs = obj.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        return ["traceEvents missing or empty"]
    last_ts = -np.inf
    for i, e in enumerate(evs):
        ph = e.get("ph")
        if ph not in ("X", "i", "M"):
            problems.append(f"event {i}: unknown ph {ph!r}")
            continue
        if not isinstance(e.get("name"), str) or not e["name"]:
            problems.append(f"event {i}: missing name")
        if not isinstance(e.get("pid"), int) \
                or not isinstance(e.get("tid"), int):
            problems.append(f"event {i}: pid/tid must be ints")
        if ph == "M":
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)):
            problems.append(f"event {i}: non-numeric ts")
            continue
        if ts < last_ts:
            problems.append(f"event {i}: ts {ts} < previous {last_ts} "
                            "(export must be time-sorted)")
        last_ts = ts
        if ph == "X" and (not isinstance(e.get("dur"), (int, float))
                          or e["dur"] < 0):
            problems.append(f"event {i}: X event needs dur >= 0")
    return problems
