"""Structured event log: a bounded in-memory ring + optional JSONL sink.

Where the metrics registry answers "how many / how long", the event log
answers "what happened when": recompiles with the offending shapes,
engine admissions/preemptions, fault→recovery episodes, DataLoader
stalls. Events are plain dicts carrying BOTH clocks:

- ``ts``      — epoch seconds (correlate across processes/hosts),
- ``mono_us`` — perf_counter microseconds (the clock profiler RecordEvent
  spans use, so exporters can interleave events with host spans in one
  chrome trace without skew).

The ring is bounded (drop-oldest) so an unobserved long run can never
OOM on its own telemetry; ``dropped`` counts what fell off. A sink file
turns the ring into a durable JSONL stream for tools/obs_report.py.
Recording honors the same process-wide enable flag as the metrics
registry.
"""

from __future__ import annotations

import collections
import json
import threading
import time

from .metrics import _ENABLED, REGISTRY

__all__ = ["EventLog", "EVENTS", "record_event"]

# ring-drop accounting: the drop-oldest ring used to
# discard silently — a trace with a hole looked identical to a trace
# that never had those spans. The counter makes the loss scrapeable;
# the per-event ``dropped_before`` stamp (see record()) makes it
# attributable to a POSITION in the surviving timeline.
_C_DROPPED = REGISTRY.counter(
    "obs_events_dropped_total",
    "events dropped from the bounded ring (drop-oldest) — nonzero "
    "means trace/event timelines have holes at the head")


def _json_default(o):
    # numpy scalars / dtypes / tuples-of-shapes etc. — never let a
    # telemetry write raise on an exotic field type
    try:
        return int(o)
    except (TypeError, ValueError):
        try:
            return float(o)
        except (TypeError, ValueError):
            return str(o)


class EventLog:
    def __init__(self, capacity=8192):
        self._lock = threading.Lock()
        self._buf = collections.deque(maxlen=capacity)
        self._sink = None
        self.dropped = 0
        self._pending_dropped = 0   # drops since the last stamped event

    def record(self, kind, **fields):
        """Append one event. Returns the event dict (None when disabled).
        When the append evicts ring history, THIS event (the next
        survivor) is stamped with ``dropped_before`` = how many events
        fell out since the last stamp, so a reader walking the ring
        sees the gap instead of a seamless-looking timeline."""
        if not _ENABLED[0]:
            return None
        ev = {"ts": time.time(),
              "mono_us": time.perf_counter_ns() / 1000.0,
              "kind": kind}
        ev.update(fields)
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1
                self._pending_dropped += 1
                _C_DROPPED.inc()
            if self._pending_dropped:
                ev["dropped_before"] = self._pending_dropped
                self._pending_dropped = 0
            self._buf.append(ev)
            if self._sink is not None:
                # write under the lock: text-mode file objects are not
                # thread-safe, and a spliced line would corrupt the JSONL
                # stream obs_report parses
                try:
                    self._sink.write(
                        json.dumps(ev, default=_json_default) + "\n")
                except (OSError, ValueError):   # closed/full sink: drop
                    pass
        return ev

    def events(self, kind=None):
        """Snapshot of buffered events, optionally filtered by kind
        (exact string or prefix ending in '*')."""
        with self._lock:
            evs = list(self._buf)
        if kind is None:
            return evs
        if kind.endswith("*"):
            pre = kind[:-1]
            return [e for e in evs if e["kind"].startswith(pre)]
        return [e for e in evs if e["kind"] == kind]

    def clear(self):
        with self._lock:
            self._buf.clear()
            self.dropped = 0
            self._pending_dropped = 0

    # -- durable sink ----------------------------------------------------
    def open_sink(self, path):
        """Start appending every future event to `path` as JSONL.
        Line-buffered: the events just before a crash are the ones a
        post-mortem needs, so they must hit the file per record, not at
        close."""
        f = open(path, "a", buffering=1)
        with self._lock:
            old, self._sink = self._sink, f
        if old is not None:
            try:
                old.close()
            except OSError:
                pass

    def close_sink(self):
        with self._lock:
            old, self._sink = self._sink, None
        if old is not None:
            try:
                old.flush()
                old.close()
            except OSError:
                pass

    def export_jsonl(self, path):
        """Write the current ring buffer to `path` (one JSON per line).
        When the ring overflowed, the FIRST line is an ``events_dropped``
        marker — a reader must know the timeline's head is missing."""
        with self._lock:
            evs = list(self._buf)
            dropped = self.dropped
        with open(path, "w") as f:
            if dropped:
                f.write(json.dumps(
                    {"ts": evs[0]["ts"] if evs else time.time(),
                     "mono_us": evs[0]["mono_us"] if evs else 0.0,
                     "kind": "events_dropped", "dropped": dropped}) + "\n")
            for ev in evs:
                f.write(json.dumps(ev, default=_json_default) + "\n")
        return len(evs)


EVENTS = EventLog()
record_event = EVENTS.record
