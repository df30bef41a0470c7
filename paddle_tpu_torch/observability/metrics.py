"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

The runtime analog of the reference's profiler statistic tables
(python/paddle/profiler/profiler_statistic.py) generalized into a
Prometheus-style instrument set that every hot subsystem shares:
core/dispatch (op + executable-cache counters), inference/engine
(occupancy/latency), distributed/resilient + checkpoint (recovery),
distributed/communication (per-collective traffic) and io (loader queue).

Design constraints:

- **process-wide**: one registry (`REGISTRY`); instruments are keyed by
  (name, sorted label items) so any module can re-request the same series
  and get the same object. Subsystems cache the instrument object at
  module scope, so the hot path is one method call — no dict lookup.
- **thread-safe**: every mutation takes the instrument's own lock
  (engine steps, checkpoint writer threads, DataLoader workers and the
  elastic watchdog all report concurrently). Locks are per-instrument,
  so unrelated series never contend.
- **near-zero overhead when disabled**: `inc`/`set`/`observe` check one
  module-global flag before touching the lock; `disable()` turns every
  instrument into a single-compare no-op (measured ~40ns/call).

Stdlib-only on purpose: core/dispatch imports this at module load, so it
must never pull jax/numpy into the import graph.
"""

from __future__ import annotations

import bisect
import threading
import time
from contextlib import contextmanager

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "counter", "gauge", "histogram", "enable", "disable", "enabled",
    "disabled_scope", "DEFAULT_LATENCY_BUCKETS",
]

# mutable cell, not a bare bool: instruments capture the cell once and the
# flag flips without any cross-module attribute rebinding hazards
_ENABLED = [True]


def enabled():
    """True when instruments record (the process-wide default)."""
    return _ENABLED[0]


def enable():
    _ENABLED[0] = True


def disable():
    """Freeze every instrument and the event log: mutations become a
    single flag compare (the near-zero-overhead-when-disabled contract)."""
    _ENABLED[0] = False


@contextmanager
def disabled_scope():
    prev = _ENABLED[0]
    _ENABLED[0] = False
    try:
        yield
    finally:
        _ENABLED[0] = prev


# seconds-denominated latency buckets: 100µs .. 60s, roughly 1-2.5-5 per
# decade — wide enough for a prefill (~ms) and a checkpoint save (~s)
DEFAULT_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class _Instrument:
    __slots__ = ("name", "description", "labels", "_lock")

    def __init__(self, name, description="", labels=None):
        self.name = name
        self.description = description
        self.labels = dict(labels or {})
        self._lock = threading.Lock()

    @property
    def label_key(self):
        return tuple(sorted(self.labels.items()))

    def _series_head(self):
        return {"name": self.name, "type": self.kind,
                "labels": self.labels, "description": self.description}


class Counter(_Instrument):
    """Monotonic counter."""

    __slots__ = ("_value",)
    kind = "counter"

    def __init__(self, name, description="", labels=None):
        super().__init__(name, description, labels)
        self._value = 0

    def inc(self, n=1):
        if not _ENABLED[0]:
            return
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def reset(self):
        with self._lock:
            self._value = 0

    def series(self):
        s = self._series_head()
        s["value"] = self._value
        return s


class Gauge(_Instrument):
    """Point-in-time value (set/inc/dec)."""

    __slots__ = ("_value",)
    kind = "gauge"

    def __init__(self, name, description="", labels=None):
        super().__init__(name, description, labels)
        self._value = 0.0

    def set(self, v):
        if not _ENABLED[0]:
            return
        with self._lock:
            self._value = v

    def inc(self, n=1):
        if not _ENABLED[0]:
            return
        with self._lock:
            self._value += n

    def dec(self, n=1):
        self.inc(-n)

    @property
    def value(self):
        return self._value

    def reset(self):
        with self._lock:
            self._value = 0.0

    def series(self):
        s = self._series_head()
        s["value"] = self._value
        return s


class Histogram(_Instrument):
    """Fixed-bucket histogram (Prometheus cumulative-bucket semantics on
    export; per-bucket counts internally). Buckets are upper bounds; an
    implicit +Inf bucket catches the tail."""

    __slots__ = ("buckets", "_counts", "_sum", "_count", "_min", "_max")
    kind = "histogram"

    def __init__(self, name, description="", labels=None, buckets=None):
        super().__init__(name, description, labels)
        b = tuple(sorted(buckets if buckets is not None
                         else DEFAULT_LATENCY_BUCKETS))
        if not b:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = b
        self._counts = [0] * (len(b) + 1)     # [..., +Inf]
        self._sum = 0.0
        self._count = 0
        self._min = None
        self._max = None

    def observe(self, v):
        if not _ENABLED[0]:
            return
        v = float(v)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    @contextmanager
    def time(self):
        """Observe the wall time of a with-block."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0)

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    def percentile(self, q):
        """Approximate quantile (0..1) by linear interpolation inside the
        owning bucket — good enough for reports; exact values need a trace."""
        with self._lock:
            total = self._count
            counts = list(self._counts)
            lo_seen, hi_seen = self._min, self._max
        if not total:
            return None
        target = q * total
        cum = 0.0
        prev_bound = 0.0 if (lo_seen is None or lo_seen >= 0) else lo_seen
        for i, c in enumerate(counts):
            if c == 0:
                if i < len(self.buckets):
                    prev_bound = self.buckets[i]
                continue
            if cum + c >= target:
                if i >= len(self.buckets):        # +Inf bucket
                    return hi_seen
                bound = self.buckets[i]
                frac = (target - cum) / c
                return prev_bound + frac * (bound - prev_bound)
            cum += c
            prev_bound = self.buckets[i] if i < len(self.buckets) else None
        return hi_seen

    def reset(self):
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._sum = 0.0
            self._count = 0
            self._min = None
            self._max = None

    def series(self):
        with self._lock:
            counts = list(self._counts)
            s = self._series_head()
            s.update({"buckets": list(self.buckets), "counts": counts,
                      "sum": self._sum, "count": self._count,
                      "min": self._min, "max": self._max})
        return s

    def summary(self):
        """Compact {count,sum,min,max,p50,p90,p99} for snapshots."""
        return {"count": self._count, "sum": round(self._sum, 6),
                "min": self._min, "max": self._max,
                "p50": self.percentile(0.5), "p90": self.percentile(0.9),
                "p99": self.percentile(0.99)}


class MetricsRegistry:
    """Get-or-create instrument store + collection point for exporters."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics = {}      # (name, label items) -> instrument
        self._collectors = []   # callables -> iterable of series dicts
        self._collector_resets = []

    # -- get-or-create ---------------------------------------------------
    def _get(self, cls, name, description, labels, **kw):
        key = (name, tuple(sorted((labels or {}).items())))
        inst = self._metrics.get(key)       # lock-free fast path (GIL)
        if inst is None:
            with self._lock:
                inst = self._metrics.get(key)
                if inst is None:
                    inst = cls(name, description, labels, **kw)
                    self._metrics[key] = inst
        if not isinstance(inst, cls):
            raise TypeError(
                f"metric '{name}' already registered as {inst.kind}, "
                f"requested {cls.kind}")
        return inst

    def counter(self, name, description="", labels=None) -> Counter:
        return self._get(Counter, name, description, labels)

    def gauge(self, name, description="", labels=None) -> Gauge:
        return self._get(Gauge, name, description, labels)

    def histogram(self, name, description="", labels=None,
                  buckets=None) -> Histogram:
        return self._get(Histogram, name, description, labels,
                         buckets=buckets)

    def get(self, name, labels=None):
        """Existing instrument or None (never creates)."""
        return self._metrics.get(
            (name, tuple(sorted((labels or {}).items()))))

    # -- collection ------------------------------------------------------
    def register_collector(self, fn, reset=None):
        """`fn() -> iterable of series dicts` pulled at collect() time —
        how externally-owned stores (dispatch's OP_STATS per-op counts)
        fold into the registry without moving their hot-path writes.
        `reset` (optional) zeroes the backing store when the registry is
        reset, so collector-backed series honor test/bench isolation."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)
                if reset is not None:
                    self._collector_resets.append(reset)

    def collect(self):
        """Every live series (instruments + collectors), exporter-ready."""
        with self._lock:
            instruments = list(self._metrics.values())
            collectors = list(self._collectors)
        out = [inst.series() for inst in instruments]
        for fn in collectors:
            try:
                out.extend(fn())
            except Exception:  # noqa: BLE001 — a broken collector must not
                pass           # take down metric export
        return out

    def snapshot(self):
        """JSON-ready compact snapshot: {counters:{}, gauges:{},
        histograms:{name: summary}}. Labeled series render as
        `name{k=v,...}` keys."""
        snap = {"counters": {}, "gauges": {}, "histograms": {}}
        for s in self.collect():
            key = s["name"]
            if s.get("labels"):
                inner = ",".join(f"{k}={v}"
                                 for k, v in sorted(s["labels"].items()))
                key = f"{key}{{{inner}}}"
            if s["type"] == "counter":
                snap["counters"][key] = snap["counters"].get(key, 0) \
                    + s["value"]
            elif s["type"] == "gauge":
                snap["gauges"][key] = s["value"]
            else:
                snap["histograms"][key] = {
                    "count": s["count"], "sum": round(s["sum"], 6),
                    "min": s["min"], "max": s["max"]}
                inst = self.get(s["name"], s.get("labels"))
                if isinstance(inst, Histogram):
                    snap["histograms"][key].update(
                        p50=inst.percentile(0.5),
                        p99=inst.percentile(0.99))
        return snap

    def reset(self):
        """Zero every instrument and collector-backed store
        (registrations survive) — bench/test isolation."""
        with self._lock:
            instruments = list(self._metrics.values())
            resets = list(self._collector_resets)
        for inst in instruments:
            inst.reset()
        for fn in resets:
            try:
                fn()
            except Exception:  # noqa: BLE001 — isolation is best-effort
                pass


REGISTRY = MetricsRegistry()

counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
