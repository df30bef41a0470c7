"""Collective flight recorder: a fixed-size per-rank ring of collective
launch records for post-mortem hang analysis.

The NCCL-flight-recorder line of work (PAPERS.md) answers the question
the round-5 all-HUNG TPU window could not: *which rank failed to join
which collective*. Every collective issued through
``distributed.parallel_base`` records a two-phase entry here:

- ``begin(op, nbytes) -> seq`` when the collective is launched (the
  per-rank sequence number is the matching key across ranks: SPMD ranks
  issue collectives in the same order, so seq N on rank 0 IS seq N on
  rank 3 — a desync of ops at the same seq is itself the classic
  collectives-issued-in-different-orders bug);
- ``commit(seq)`` when it returns. A hung collective never commits, so
  a dump shows exactly which op each rank is stuck inside.

The ring is bounded (drop-oldest) like the event log: a week-long run
keeps only the tail that matters for a post-mortem. ``dump()`` writes
``flight_<rank>.json``; the watchdog timeout path and the resilient
fault path call ``dump_on_timeout``/``dump_active`` automatically when a
recorder is active, and ``tools/flight_analyze.py`` merges the per-rank
dumps to name the last fully-matched seq, the straggler ranks that never
arrived, and the per-seq launch skew.

Stdlib-only on purpose (same constraint as metrics.py): the distributed
substrate imports this at module load.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time

from .events import EVENTS as _EVENTS
from .metrics import _ENABLED

__all__ = [
    "FlightRecorder", "RECORDER", "enable_flight_recorder",
    "disable_flight_recorder", "get_recorder", "active",
    "dump_active", "dump_on_timeout",
]

DEFAULT_CAPACITY = 4096


def _now_us():
    return time.perf_counter_ns() / 1000.0


def _env_rank():
    for k in ("PADDLE_TRAINER_ID", "RANK", "PADDLE_TPU_FLIGHT_RANK"):
        v = os.environ.get(k)
        if v is not None:
            try:
                return int(v)
            except ValueError:
                pass
    return 0


def _env_world():
    for k in ("PADDLE_TRAINERS_NUM", "WORLD_SIZE"):
        v = os.environ.get(k)
        if v is not None:
            try:
                return int(v)
            except ValueError:
                pass
    return 1


class FlightRecorder:
    """Fixed-size ring of (op, seq, bytes, start_us, end_us) entries.

    ``seq`` is a per-recorder monotonic counter assigned at ``begin``;
    evicted entries bump ``dropped`` so the analyzer knows the window's
    head is missing. Thread-safe: collectives may be issued from worker
    threads (checkpoint writers, the elastic watchdog).
    """

    def __init__(self, capacity=DEFAULT_CAPACITY, rank=None, world=None,
                 out_dir=None):
        self.capacity = int(capacity)
        self.rank = _env_rank() if rank is None else int(rank)
        self.world = _env_world() if world is None else int(world)
        self.out_dir = out_dir
        self.dropped = 0
        self._lock = threading.Lock()
        # OrderedDict keyed by seq: O(1) commit + drop-oldest eviction
        self._entries = collections.OrderedDict()
        self._next_seq = 0
        self._last_committed = -1

    # -- recording -------------------------------------------------------
    def begin(self, op, nbytes=0):
        """Record a collective launch; returns the seq to commit later."""
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
            if len(self._entries) >= self.capacity:
                self._entries.popitem(last=False)
                self.dropped += 1
            self._entries[seq] = {"op": op, "seq": seq,
                                  "bytes": int(nbytes),
                                  "start_us": _now_us(), "end_us": None}
        return seq

    def commit(self, seq):
        """Mark a begun collective complete (no-op if it aged out)."""
        with self._lock:
            e = self._entries.get(seq)
            if e is not None and e["end_us"] is None:
                e["end_us"] = _now_us()
                if seq > self._last_committed:
                    self._last_committed = seq

    def record(self, op, nbytes=0, start_us=None, end_us=None):
        """One-shot committed entry (scripted tests / non-span sources)."""
        seq = self.begin(op, nbytes)
        with self._lock:
            e = self._entries.get(seq)
            if e is not None:
                if start_us is not None:
                    e["start_us"] = float(start_us)
                e["end_us"] = _now_us() if end_us is None else float(end_us)
                if seq > self._last_committed:
                    self._last_committed = seq
        return seq

    # -- inspection ------------------------------------------------------
    def entries(self):
        with self._lock:
            return [dict(e) for e in self._entries.values()]

    @property
    def last_committed_seq(self):
        return self._last_committed

    @property
    def next_seq(self):
        return self._next_seq

    def pending(self):
        """Entries begun but never committed — the op the rank is stuck
        inside (or abandoned via an exception) at dump time."""
        with self._lock:
            return [dict(e) for e in self._entries.values()
                    if e["end_us"] is None]

    def clear(self):
        with self._lock:
            self._entries.clear()
            self.dropped = 0
            self._next_seq = 0
            self._last_committed = -1

    # -- durable dump ----------------------------------------------------
    def dump_path(self, out_dir=None):
        d = out_dir or self.out_dir or "."
        return os.path.join(d, f"flight_{self.rank}.json")

    def dump(self, path=None, reason="manual"):
        """Write the ring as ``flight_<rank>.json``. Returns the path.
        The write is tmp+replace so a crash mid-dump can never leave a
        truncated JSON where the post-mortem tool expects evidence."""
        path = path or self.dump_path()
        doc = {"rank": self.rank, "world": self.world,
               "capacity": self.capacity, "dropped": self.dropped,
               "next_seq": self._next_seq,
               "last_committed_seq": self._last_committed,
               "reason": reason, "ts": time.time(),
               "mono_us": _now_us(),
               "entries": self.entries()}
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path


# -- process-wide recorder --------------------------------------------------
# A mutable cell like metrics._ENABLED: call sites capture the cell once
# and read [0] per call, so enable/disable needs no rebinding gymnastics.
RECORDER = [None]


def enable_flight_recorder(capacity=DEFAULT_CAPACITY, out_dir=None,
                           rank=None, world=None):
    """Install (or replace) the process-wide recorder and return it."""
    rec = FlightRecorder(capacity=capacity, rank=rank, world=world,
                         out_dir=out_dir)
    RECORDER[0] = rec
    return rec


def disable_flight_recorder():
    RECORDER[0] = None


def get_recorder():
    return RECORDER[0]


def active():
    return RECORDER[0] is not None and _ENABLED[0]


def dump_active(reason="manual", out_dir=None):
    """Dump the active recorder (None when inactive). Never raises: the
    dump runs on failure paths where a secondary error must not mask the
    primary fault."""
    rec = RECORDER[0]
    if rec is None:
        return None
    try:
        return rec.dump(path=rec.dump_path(out_dir), reason=reason)
    except OSError:
        return None


def clear_active(reason="recovered"):
    """Clear the active recorder's ring (no-op when none): called after a
    SUCCESSFUL recovery so a past episode's pending entries can't pollute
    the next post-mortem — the pre-recovery evidence already lives in the
    dumped flight_<rank>.json. All ranks recover together, so rings (and
    seqs) reset in lockstep."""
    rec = RECORDER[0]
    if rec is not None:
        rec.clear()


def dump_on_timeout(what="collective", timeout=None):
    """The watchdog's default timeout hook: dump the ring (when a
    recorder is active) and mirror a ``comm_timeout`` event carrying the
    rank's last-matched (committed) seq and any in-flight op into the
    event log, so the hang is analyzable from the events stream even if
    the flight file is lost."""
    rec = RECORDER[0]
    path = dump_active(reason="comm_timeout")
    fields = {"what": what, "timeout": timeout}
    if rec is not None:
        pend = rec.pending()
        fields.update(last_seq=rec.last_committed_seq,
                      rank=rec.rank, dump=path,
                      in_flight=[{"op": e["op"], "seq": e["seq"]}
                                 for e in pend[-4:]])
    _EVENTS.record("comm_timeout", **fields)
    return path
