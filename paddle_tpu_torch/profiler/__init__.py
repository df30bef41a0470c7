"""paddle.profiler: the counterpart of ``paddle_tpu/profiler/__init__.py``
(ref: python/paddle/profiler/profiler.py:358 Profiler; C++
HostTracer/CudaTracer -> here ``torch.profiler`` with the CPU and CUDA
activities, plus a host-side RecordEvent shim exporting chrome://tracing
JSON like the reference's ChromeTracingLogger).

The scheduler state machine is the JAX package's: ``make_scheduler`` (and
a ``(start, end)`` tuple) map a step to CLOSED, READY, RECORD or
RECORD_AND_RETURN, and the same arguments step through the same states.
``Profiler`` drives ``torch.profiler.profile`` with that machine (CLOSED
-> NONE, READY -> WARMUP, RECORD -> RECORD, RECORD_AND_RETURN ->
RECORD_AND_SAVE): the device trace of a window is collected when the
window closes. Host ``RecordEvent`` spans are buffered while a window
records (every thread, as in JAX) and also marked in the torch trace
(``record_function``); ``observability.chrome_trace()`` merges the
buffered spans, and ``Profiler.export`` writes one chrome trace of the
window's torch events (device kernels by name, on the profiler's clock)
with the host spans and the observability marks (on the host's
perf_counter clock). ``summary`` prints the host span table, the step
times, and (``op_detail``) the window's device kernels by time and the
amp operator stats when they are collected.
"""

from __future__ import annotations

import enum
import json
import os
import threading
import time
from contextlib import contextmanager


class ProfilerTarget:
    CPU = "cpu"
    GPU = "gpu"
    CUSTOM_DEVICE = "custom_device"
    TPU = "tpu"


class SortedKeys(enum.Enum):
    """Ordering for summary tables (ref: profiler_statistic.py
    SortedKeys)."""
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    Calls = 4


class ProfilerState:
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


def make_scheduler(closed=0, ready=0, record=1, repeat=0, skip_first=0):
    """Profiling-window state machine (ref: python/paddle/profiler/
    profiler.py make_scheduler). After ``skip_first`` warmup steps
    (CLOSED), cycle through ``closed`` CLOSED steps, ``ready`` READY
    steps (profiler armed, data discarded) and ``record`` RECORD steps,
    the last of which is RECORD_AND_RETURN (the trace handler fires
    there). ``repeat`` bounds the number of cycles; 0 repeats forever."""
    if record <= 0:
        raise ValueError("record must be >= 1 in make_scheduler")
    if min(closed, ready, repeat, skip_first) < 0:
        raise ValueError("make_scheduler phases must be non-negative")
    period = closed + ready + record

    def scheduler(step):
        if step < skip_first:
            return ProfilerState.CLOSED
        cycle, pos = divmod(step - skip_first, period)
        if repeat and cycle >= repeat:
            return ProfilerState.CLOSED
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == period - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return scheduler


def _tuple_scheduler(start, end):
    """paddle also accepts scheduler=(start, end): record [start, end)."""
    start, end = int(start), int(end)

    def scheduler(step):
        if step < start or step >= end:
            return ProfilerState.CLOSED
        if step == end - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return scheduler


class _HostEventBuffer:
    """Shared, lock-guarded span buffer keyed by thread id. The previous
    threading.local buffer silently DROPPED every span recorded off the
    main thread (async checkpoint saver, watchdog, DataLoader workers) —
    Profiler.export never saw them."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_tid = {}
        self.active = False

    def append(self, ev):
        with self._lock:
            self._by_tid.setdefault(ev["tid"], []).append(ev)

    def clear(self):
        with self._lock:
            self._by_tid.clear()

    def all_events(self):
        """Every buffered span from every thread, sorted by start ts."""
        with self._lock:
            evs = [e for lst in self._by_tid.values() for e in lst]
        evs.sort(key=lambda e: e["ts"])
        return evs


_host = _HostEventBuffer()


class RecordEvent:
    """Host-side span (ref: paddle.profiler.RecordEvent / C++ RecordEvent
    instrumentation in the eager codegen); while a window records it is
    also a ``torch.profiler.record_function`` range."""

    def __init__(self, name, event_type=None):
        self.name = name
        self._rf = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def begin(self):
        self._t0 = time.perf_counter_ns()
        if _host.active:
            import torch
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()

    def end(self):
        if self._rf is not None:
            rf, self._rf = self._rf, None
            rf.__exit__(None, None, None)
        if _host.active:
            _host.append(
                {"name": self.name, "ph": "X", "pid": os.getpid(),
                 "tid": threading.get_ident(),
                 "ts": self._t0 / 1000.0,
                 "dur": (time.perf_counter_ns() - self._t0) / 1000.0})


class Profiler:
    """ref: profiler.py:358. Drives torch.profiler (CPU and, with a card,
    CUDA activities) through the scheduler state machine and collects host
    RecordEvent spans."""

    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False, record_shapes=False, profile_memory=False,
                 with_flops=False):
        self.timer_only = timer_only
        self.on_trace_ready = on_trace_ready
        if isinstance(scheduler, (tuple, list)):
            scheduler = _tuple_scheduler(*scheduler)
        self._scheduler = scheduler
        self._record_shapes = record_shapes
        self._profile_memory = profile_memory
        self._with_flops = with_flops
        self._prof = None
        self._device_events = []     # the last window's torch trace events
        self._kernels = []           # its device kernels: (name, calls, us)
        self._step = 0
        self._state = ProfilerState.CLOSED
        self._step_times = []
        self._t_last = None

    def _current_state(self):
        if self._scheduler is None:
            return ProfilerState.RECORD
        return self._scheduler(self._step)

    def _apply_state(self):
        # host spans are only collected while RECORDing (READY arms the
        # profiler but discards data, like the reference's WARMUP)
        _host.active = self._state in (ProfilerState.RECORD,
                                       ProfilerState.RECORD_AND_RETURN)

    def _torch_schedule(self, step):
        from torch.profiler import ProfilerAction
        return {ProfilerState.CLOSED: ProfilerAction.NONE,
                ProfilerState.READY: ProfilerAction.WARMUP,
                ProfilerState.RECORD: ProfilerAction.RECORD,
                ProfilerState.RECORD_AND_RETURN:
                    ProfilerAction.RECORD_AND_SAVE}[self._scheduler(step)]

    def _torch_ready(self, prof):
        """torch's trace of a closed window: keep its events (the chrome
        trace as torch writes it) and its device kernels."""
        import tempfile
        fd, path = tempfile.mkstemp(suffix=".json", prefix="ptt_prof_")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
            self._device_events = doc.get("traceEvents", [])
        except (OSError, ValueError, RuntimeError):
            self._device_events = []
        finally:
            try:
                os.remove(path)
            except OSError:
                pass
        spans = {e["name"] for e in _host.all_events()}
        kernels = []
        for e in prof.key_averages():
            # the device-side copies of the RecordEvent ranges are no
            # kernels
            if str(e.device_type).endswith("CUDA") and e.key not in spans:
                us = (getattr(e, "self_device_time_total", 0)
                      or getattr(e, "self_cuda_time_total", 0))
                kernels.append((e.key, e.count, us))
        kernels.sort(key=lambda k: -k[2])
        self._kernels = kernels

    def start(self):
        _host.clear()
        self._device_events, self._kernels = [], []
        self._step = 0
        self._state = self._current_state()
        self._apply_state()
        self._t_last = time.perf_counter()
        if not self.timer_only:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(
                activities=acts,
                schedule=None if self._scheduler is None
                else self._torch_schedule,
                on_trace_ready=self._torch_ready,
                record_shapes=self._record_shapes,
                profile_memory=self._profile_memory,
                with_flops=self._with_flops)
            self._prof.start()

    def step(self, num_samples=None):
        now = time.perf_counter()
        if self._t_last is not None:
            self._step_times.append(now - self._t_last)
        self._t_last = now
        prev = self._state
        self._step += 1
        self._state = self._current_state()
        if self._prof is not None and self._scheduler is not None:
            self._prof.step()          # closes torch's window first
        self._apply_state()
        if prev == ProfilerState.RECORD_AND_RETURN:
            # the step that just COMPLETED closed a record window: hand
            # the spans to the handler, then drop them so the next window
            # exports only its own data (and the shared buffer stays
            # bounded across repeat cycles)
            if self.on_trace_ready is not None:
                self.on_trace_ready(self)
            _host.clear()

    def stop(self):
        recording = _host.active
        _host.active = False
        if self._prof is not None:
            prof, self._prof = self._prof, None
            prof.stop()
            if self._scheduler is None:
                self._torch_ready(prof)
        if self.on_trace_ready is not None and (
                self._scheduler is None or
                (recording and _host.all_events())):
            # scheduled mode: only flush a window that actually holds
            # spans — a stop() right after a window-close step (which
            # fired the handler and cleared the buffer) must not
            # overwrite the real export with an empty one
            self.on_trace_ready(self)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def export(self, path, format="json", include_events=True):  # noqa: A002
        """Chrome tracing export of the window: torch's events (the device
        kernels by name), the host spans, and the observability events as
        instant marks. Spans from ALL threads are included."""
        from ..observability.exporters import chrome_trace
        doc = chrome_trace(None, include_host_spans=True,
                           include_metric_marks=include_events)
        doc["traceEvents"] = list(self._device_events) + doc["traceEvents"]
        with open(path, "w") as f:
            json.dump(doc, f)
        return doc

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms"):
        """Statistics tables (ref: python/paddle/profiler/
        profiler_statistic.py — per-event Calls/Total/Avg/Max/Min/Ratio
        with SortedKeys ordering; with op_detail, the window's device
        kernels and the amp operator stats)."""
        stats = {}   # name -> [calls, total_ms, max_ms, min_ms]
        for e in _host.all_events():
            d = e["dur"] / 1000.0
            st = stats.setdefault(e["name"], [0, 0.0, 0.0, float("inf")])
            st[0] += 1
            st[1] += d
            st[2] = max(st[2], d)
            st[3] = min(st[3], d)
        grand = sum(st[1] for st in stats.values()) or 1.0
        key = sorted_by or SortedKeys.CPUTotal
        idx = {SortedKeys.CPUTotal: 1, SortedKeys.CPUAvg: None,
               SortedKeys.CPUMax: 2, SortedKeys.CPUMin: 3,
               SortedKeys.Calls: 0}[key]

        def sort_key(kv):
            st = kv[1]
            if idx is None:
                return -(st[1] / st[0])
            return -st[idx] if key is not SortedKeys.CPUMin else st[3]

        header = (f"{'Event':<42}{'Calls':>7}{'Total(ms)':>11}"
                  f"{'Avg(ms)':>10}{'Max(ms)':>10}{'Min(ms)':>10}"
                  f"{'Ratio(%)':>9}")
        lines = ["-" * len(header), header, "-" * len(header)]
        for name, (calls, total, mx, mn) in sorted(stats.items(),
                                                   key=sort_key):
            lines.append(
                f"{name[:41]:<42}{calls:>7}{total:>11.3f}"
                f"{total / calls:>10.3f}{mx:>10.3f}{mn:>10.3f}"
                f"{100.0 * total / grand:>9.1f}")
        if self._step_times:
            import numpy as np
            ts = np.asarray(self._step_times)
            lines.append("-" * len(header))
            lines.append(f"steps: {len(ts)}  avg {ts.mean()*1e3:.2f}ms  "
                         f"p50 {np.percentile(ts,50)*1e3:.2f}ms  "
                         f"max {ts.max()*1e3:.2f}ms")
        if op_detail:
            if self._kernels:
                busy = sum(k[2] for k in self._kernels) or 1.0
                lines.append("-" * len(header))
                lines.append(f"{'Device kernel':<42}{'Calls':>7}"
                             f"{'Total(ms)':>11}{'Ratio(%)':>9}")
                for name, calls, us in self._kernels[:30]:
                    lines.append(f"{name[:41]:<42}{calls:>7}"
                                 f"{us / 1e3:>11.3f}"
                                 f"{100.0 * us / busy:>9.1f}")
            from ..amp import OP_STATS
            if OP_STATS["counts"]:
                lines.append("-" * len(header))
                lines.append(f"{'Counted op':<42}{'Calls':>7}")
                for name, n in sorted(OP_STATS["counts"].items(),
                                      key=lambda kv: -kv[1])[:30]:
                    lines.append(f"{name[:41]:<42}{n:>7}")
        out = "\n".join(lines)
        print(out)
        return out


def export_chrome_tracing(dir_name, worker_name=None):
    def handler(prof):
        os.makedirs(dir_name, exist_ok=True)
        prof.export(os.path.join(dir_name, "host_trace.json"))
    return handler


def export_protobuf(dir_name, worker_name=None):
    return export_chrome_tracing(dir_name, worker_name)


@contextmanager
def profiler_guard(**kwargs):
    p = Profiler(**kwargs)
    p.start()
    try:
        yield p
    finally:
        p.stop()


class utils:
    RecordEvent = RecordEvent

    @staticmethod
    @contextmanager
    def job_schedule_profiler_range(*a, **kw):
        yield False


class SummaryView(enum.Enum):
    """ref: profiler/profiler.py SummaryView."""
    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6
    MemoryManipulationView = 7
    UDFView = 8


def load_profiler_result(filename):
    """ref: profiler load_profiler_result — reload an exported host
    trace (chrome-tracing JSON) for offline summary."""
    with open(filename) as f:
        data = json.load(f)
    return data.get("traceEvents", data)


__all__ = ["Profiler", "ProfilerState", "ProfilerTarget", "RecordEvent",
           "SortedKeys", "SummaryView", "export_chrome_tracing",
           "export_protobuf", "load_profiler_result", "make_scheduler",
           "profiler_guard", "utils"]
