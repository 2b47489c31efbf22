"""Unified metrics registry (DESIGN.md §12).

One process-wide-ish registry per serving stack instance absorbs the
counters that used to live scattered across ``ResourceMonitor``,
``PagedInferenceEngine.step_stats()``, ``kv_stats()``, and per-benchmark
Python lists. Three metric kinds, all bounded-memory by construction:

  * ``Counter`` — monotonic accumulator (tokens, dispatches, reaps).
  * ``Gauge``   — last-write-wins level (queue depth, blocks in use).
  * ``Histogram`` — fixed log-spaced buckets for latency-shaped data
    (TTFT / ITL / step time). Quantiles are estimated from the bucket
    cumulative counts with linear interpolation inside the containing
    bucket, so the relative error is bounded by the bucket ratio
    (``10**(1/per_decade) - 1``) no matter how many samples stream in.
    An optional bounded reservoir (Vitter's Algorithm R) keeps up to
    ``reservoir`` raw samples: while nothing has been evicted the
    quantile is exact — which is what the benchmarks' small runs want —
    and once the stream outgrows it the histogram estimate takes over.

This replaces the engine's unbounded per-token ``ttft_s``/``itl_s``
Python lists — the exact "unbounded memory growth" failure mode the
paper catalogs for long-lived agent processes.

Writers are expected to be serialized by their caller's lock (the engine
runs under the backend lock, the middleware under its own); the registry
lock only guards metric creation.
"""
from __future__ import annotations

import json
import math
import random
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "log_buckets", "LATENCY_BUCKETS_S"]


def log_buckets(lo: float, hi: float, per_decade: int = 12
                ) -> Tuple[float, ...]:
    """Geometric bucket upper bounds covering [lo, hi]: ``per_decade``
    buckets per factor of 10. Memory is fixed at construction; relative
    quantile error is bounded by ``10**(1/per_decade) - 1``."""
    assert 0 < lo < hi and per_decade > 0
    n = int(math.ceil(math.log10(hi / lo) * per_decade))
    return tuple(lo * 10 ** (i / per_decade) for i in range(n + 1))


# default latency buckets: 10 µs .. 100 s at 12 per decade (85 buckets) —
# covers a Pallas kernel dispatch through a CI-box compile stall, with
# ~21% worst-case relative quantile error from the buckets alone
LATENCY_BUCKETS_S = log_buckets(1e-5, 100.0, 12)


class Counter:
    """Monotonic accumulator. ``set`` exists only so benchmarks can zero a
    measurement window; live instrumentation must use ``inc``."""

    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0):
        self.value += n

    def set(self, v: float):
        self.value = float(v)

    def reset(self):
        self.value = 0.0

    def snapshot(self) -> dict:
        return {"type": self.kind, "value": self.value}


class Gauge(Counter):
    kind = "gauge"


class Histogram:
    """Fixed-bucket histogram with bounded-error quantiles and an optional
    bounded exact-sample reservoir."""

    kind = "histogram"

    # ring capacity for the recency window every histogram keeps (see
    # ``windowed_quantile``) — bounded regardless of stream length
    WINDOW_CAP = 512

    def __init__(self, name: str, bounds: Sequence[float] = LATENCY_BUCKETS_S,
                 reservoir: int = 0, seed: int = 0):
        self.name = name
        self.bounds = np.asarray(bounds, np.float64)
        assert self.bounds.ndim == 1 and len(self.bounds) >= 2 \
            and bool(np.all(np.diff(self.bounds) > 0)), \
            f"histogram {name}: bounds must be increasing"
        # counts[i] holds observations v <= bounds[i]; the final slot is
        # the overflow bucket (v > bounds[-1])
        self.counts = np.zeros(len(self.bounds) + 1, np.int64)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._res_cap = int(reservoir)
        self._res: List[float] = []
        self._rng = random.Random(seed)
        # (t, v) recency ring: lifetime buckets answer "how has this run
        # gone", the ring answers "how is it going RIGHT NOW" — the SLO
        # autopilot's control signal. Timestamps are host perf_counter
        # (the obs clock domain), overridable for virtual-clock callers.
        self._win: deque = deque(maxlen=self.WINDOW_CAP)

    def observe(self, v: float, now: Optional[float] = None):
        self.counts[int(np.searchsorted(self.bounds, v, side="left"))] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        self._win.append((time.perf_counter() if now is None else now, v))
        if self._res_cap:
            if len(self._res) < self._res_cap:
                self._res.append(v)
            else:
                j = self._rng.randrange(self.count)
                if j < self._res_cap:
                    self._res[j] = v

    @property
    def samples(self) -> List[float]:
        """Bounded reservoir contents (all observations, while the stream
        fits; a uniform sample once it doesn't)."""
        return list(self._res)

    @property
    def exact(self) -> bool:
        """True while the reservoir still holds every observation."""
        return bool(self._res_cap) and self.count <= self._res_cap

    def quantile(self, q: float) -> float:
        """q-quantile: exact from the reservoir while nothing has been
        evicted, else interpolated from the buckets (error bounded by the
        bucket ratio)."""
        if self.count == 0:
            return 0.0
        if self.exact:
            return float(np.percentile(np.asarray(self._res), 100.0 * q))
        target = max(q * self.count, 1.0)
        cum = np.cumsum(self.counts)
        idx = int(np.searchsorted(cum, target, side="left"))
        lower = float(self.bounds[idx - 1]) if idx > 0 else \
            min(self.min, float(self.bounds[0]))
        upper = float(self.bounds[idx]) if idx < len(self.bounds) else self.max
        prev = int(cum[idx - 1]) if idx > 0 else 0
        in_bucket = int(cum[idx]) - prev
        frac = (target - prev) / max(in_bucket, 1)
        return float(min(max(lower + frac * (upper - lower), self.min),
                         self.max))

    def windowed_count(self, horizon_s: float,
                       now: Optional[float] = None) -> int:
        """Observations recorded within the last ``horizon_s`` seconds
        (clamped to the ring capacity — a firehose stream ages out)."""
        t = time.perf_counter() if now is None else now
        return sum(1 for ts, _ in self._win if ts >= t - horizon_s)

    def windowed_quantile(self, q: float, horizon_s: float,
                          now: Optional[float] = None) -> Optional[float]:
        """q-quantile over ONLY the observations of the last ``horizon_s``
        seconds. Returns None when the window is empty — "no signal",
        which a feedback controller must treat as hold-not-act (an idle
        engine's stale lifetime p95 would otherwise trip it forever)."""
        t = time.perf_counter() if now is None else now
        recent = [v for ts, v in self._win if ts >= t - horizon_s]
        if not recent:
            return None
        return float(np.percentile(np.asarray(recent), 100.0 * q))

    def reset(self):
        self.counts[:] = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._res.clear()
        self._win.clear()

    def snapshot(self) -> dict:
        return {
            "type": self.kind,
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
            "exact": self.exact,
        }


class MetricsRegistry:
    """Name -> metric store with get-or-create accessors, a single
    ``snapshot()`` for benchmarks/JSON dumps, and a Prometheus-style text
    exposition. ``reset()`` zeroes every metric — benchmarks call it after
    warmup so every reported column describes the same window."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, factory, kind: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            elif m.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"not {kind}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, lambda: Counter(name), "counter")

    def gauge(self, name: str) -> Gauge:
        return self._get(name, lambda: Gauge(name), "gauge")

    def histogram(self, name: str,
                  bounds: Sequence[float] = LATENCY_BUCKETS_S,
                  reservoir: int = 0, seed: int = 0) -> Histogram:
        return self._get(
            name, lambda: Histogram(name, bounds, reservoir, seed),
            "histogram")

    def get(self, name: str) -> Optional[object]:
        return self._metrics.get(name)

    def __getitem__(self, name: str):
        return self._metrics[name]

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def reset(self):
        with self._lock:
            for m in self._metrics.values():
                m.reset()

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {name: m.snapshot()
                    for name, m in sorted(self._metrics.items())}

    def dump_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2)
