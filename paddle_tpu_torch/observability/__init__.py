"""paddle_tpu_torch.observability — the port's runtime telemetry.

Stdlib-only copies of ``paddle_tpu/observability``'s metrics registry
(counters, gauges, fixed-bucket histograms), structured event log,
request tracing (spans, quantile sketches, SLO attainment), flight
recorder, per-request cost ledger, exporters (Prometheus text, JSONL,
chrome trace, with the profiler's host ``RecordEvent`` spans merged in)
and the doctor's detectors, with the step-scope performance ledger
(``perf``: phases, goodput, MFU) and program introspection
(``xla_introspect``: per-program flops, bytes and the HBM ledger, rebuilt
for eager PyTorch on CUDA). Every series keeps the JAX package's name, so
one dashboard reads both; the port holds its own ``REGISTRY`` and
``EVENTS`` (a process that imports both packages has two registries).

``sharding`` is the sharding observatory: the collectives of the
tensor-parallel engine's step programs (harvested at each program's first
run) and the partition audit of its placed weights.
"""

from __future__ import annotations

import os as _os

from .metrics import (  # noqa: F401
    REGISTRY, MetricsRegistry, Counter, Gauge, Histogram,
    counter, gauge, histogram, enable, disable, enabled, disabled_scope,
    DEFAULT_LATENCY_BUCKETS,
)
from .events import EVENTS, EventLog, record_event  # noqa: F401
from .exporters import (  # noqa: F401
    prometheus_text, dump_metrics_json, dump_events_jsonl, chrome_trace,
    serve_prometheus,
)

__all__ = [
    "REGISTRY", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "counter", "gauge", "histogram", "enable", "disable", "enabled",
    "disabled_scope", "EVENTS", "EventLog", "record_event",
    "prometheus_text", "dump_metrics_json", "dump_events_jsonl",
    "chrome_trace", "serve_prometheus", "snapshot", "reset", "dump_run",
    # lazy submodules (PEP 562), as in the JAX package
    "perf", "xla_introspect", "flight_recorder", "tracing", "detectors",
    "doctor", "costs", "sharding",
]

_LAZY_SUBMODULES = ("perf", "xla_introspect", "flight_recorder", "tracing",
                    "detectors", "doctor", "costs", "sharding")


def __getattr__(name):
    if name in _LAZY_SUBMODULES:
        import importlib
        mod = importlib.import_module("." + name, __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def snapshot():
    """Compact JSON-ready metrics snapshot (see MetricsRegistry.snapshot)."""
    return REGISTRY.snapshot()


def reset():
    """Zero every instrument and clear the event ring (test/bench
    isolation). Registrations and module-cached instruments survive."""
    import sys as _sys
    REGISTRY.reset()
    EVENTS.clear()
    xi = _sys.modules.get(__name__ + ".xla_introspect")
    if xi is not None:
        xi.reset()
    pf = _sys.modules.get(__name__ + ".perf")
    if pf is not None:
        pf._ACTIVE[0] = None      # detach any lingering StepTimer
    co = _sys.modules.get(__name__ + ".costs")
    if co is not None:
        co.LEDGER.reset()         # drop open per-trace cost entries
    sh = _sys.modules.get(__name__ + ".sharding")
    if sh is not None:
        sh.reset()                # forget harvested programs and audits


def dump_run(prefix):
    """Write the whole run's telemetry as three sibling artifacts:
    ``<prefix>.metrics.json``, ``<prefix>.events.jsonl``,
    ``<prefix>.prom``. Returns the three paths."""
    paths = (f"{prefix}.metrics.json", f"{prefix}.events.jsonl",
             f"{prefix}.prom")
    dump_metrics_json(paths[0])
    dump_events_jsonl(paths[1])
    with open(paths[2], "w") as f:
        f.write(prometheus_text())
    return paths


# opt-in durable event stream: PADDLE_TPU_OBS_EVENTS=/path/to/events.jsonl
_sink = _os.environ.get("PADDLE_TPU_OBS_EVENTS")
if _sink:
    try:
        EVENTS.open_sink(_sink)
    except OSError:
        pass
