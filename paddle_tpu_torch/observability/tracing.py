"""Request tracing: cross-process spans + percentile SLO telemetry.

The event log answers "what happened when" per process; this layer
makes it answer "what happened to THIS request, across every process it
touched". Three pieces, all stdlib-only (the engine and router import
this at module load, so it must never pull jax/numpy in):

**Trace ids + spans.** A request gets one opaque trace id at admission
(router or engine) and carries it through the ``make_sequence_snapshot``
wire format, so a failover re-placement on another replica process keeps
the same id. Spans are ordinary events (``kind="span"``) on the bounded
event ring with the start time in ``mono_us`` and the measured duration
in ``dur_us``; the record-time ``ts`` (epoch seconds) therefore marks
the span's END — cross-process tools reconstruct the start as
``ts - dur_us*1e-6`` because per-process monotonic clocks do not align.
``tools/trace_report.py`` merges per-process dumps into one chrome trace
keyed by trace id.

**Streaming quantile sketch.** ``QuantileSketch`` is a small KLL-style
compactor: bounded memory, one append per observation, MERGEABLE across
processes (the fleet metrics plane merges per-replica sketches into one
fleet percentile), and deterministic (compaction keeps alternating
halves instead of a random offset, so tests and repeated runs agree).
Named sketches (``observe("ttft", v)``) publish live
``slo_<name>_seconds{q=p50|p95|p99}`` gauges through a registry
collector — quantile math runs at collect/export time, never on the
serving hot path.

**SLO attainment.** ``set_slo_targets(ttft_ms=..., ...)`` (or the
``PADDLE_TPU_SLO_<NAME>_MS`` env vars) arms per-metric budgets;
``check_slo`` counts checks/violations, keeps a live
``slo_attainment{metric=}`` gauge, and records a ``slo_violation`` event
(with the trace id) for every miss — the event, not just the counter,
is what lets a violated budget be traced back to the exact request.

Everything honors the process-wide enable flag: disabled, every entry
point is a single compare-and-return.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager

from .metrics import _ENABLED, REGISTRY
from .events import EVENTS

__all__ = [
    "new_trace_id", "record_span", "span", "QuantileSketch", "sketch",
    "observe", "export_states", "merge_states", "set_slo_targets",
    "slo_targets", "check_slo", "merge_series", "split_metric",
    "tenant_metric", "sanitize_tenant", "tenant_tracked",
    "diff_states", "parse_series_key",
]


# --------------------------------------------------------------------------
# trace ids + spans
# --------------------------------------------------------------------------

def new_trace_id():
    """16-hex-char opaque trace id, unique across processes; None when
    telemetry is disabled (a None trace id makes every span helper and
    propagation site a no-op, which is the disabled contract)."""
    if not _ENABLED[0]:
        return None
    return os.urandom(8).hex()


def record_span(name, t0, t1=None, trace=None, **fields):
    """Record one completed span. `t0`/`t1` are time.perf_counter()
    seconds (t1 defaults to now). Returns the event dict (None when
    disabled). See the module docstring for the clock contract."""
    if not _ENABLED[0]:
        return None
    if t1 is None:
        t1 = time.perf_counter()
    return EVENTS.record("span", name=name, trace=trace,
                         mono_us=t0 * 1e6,
                         dur_us=max(0.0, t1 - t0) * 1e6, **fields)


@contextmanager
def span(name, trace=None, **fields):
    """Span the wall time of a with-block."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record_span(name, t0, trace=trace, **fields)


# --------------------------------------------------------------------------
# per-tenant metric naming
# --------------------------------------------------------------------------
#
# A tenant-scoped observation lives in its own named sketch under the
# convention ``<metric>@<tenant>`` — sketches stay mergeable across
# processes by NAME, so the fleet metrics plane rolls per-tenant
# percentiles up exactly like the aggregate ones with zero wire-format
# changes. Exporters split the name back apart and publish the tenant as
# a label (``slo_ttft_seconds{q="p95",tenant="acme"}``), never as part
# of the Prometheus metric name.

def sanitize_tenant(tenant):
    """Canonical tenant label value: tenants are caller-supplied
    strings, but they travel through sketch names (``metric@tenant``),
    label sets, and the fleet merge's ``name{k=v,...}`` keys — characters
    with meaning in any of those encodings ('@', ',', '=', braces,
    whitespace) are mapped to '_' ONCE at the admission edges (router /
    engine), so every layer downstream can treat the value as opaque.
    None stays None; length capped at 64."""
    if tenant is None:
        return None
    out = "".join(c if (c.isalnum() or c in "._-") else "_"
                  for c in str(tenant))
    return out[:64] or "_"


def tenant_metric(metric, tenant):
    """The per-tenant sketch name for `metric` (identity when tenant is
    falsy)."""
    if not tenant:
        return metric
    return f"{metric}@{tenant}"


# Per-tenant series are caller-controlled cardinality: every distinct
# tenant value mints permanent sketches + counter/gauge series that ride
# every metrics scrape. A caller mistaking a per-user/request id for a
# tenant must degrade the TELEMETRY (overflow tenants fold into the
# aggregate and are counted), never the process — so the population is
# bounded.
_TENANT_SERIES = set()
_MAX_TENANT_SERIES = int(os.environ.get(
    "PADDLE_TPU_MAX_TENANT_SERIES", "256"))


def tenant_tracked(tenant):
    """Admit `tenant` into the bounded per-tenant series population
    (PADDLE_TPU_MAX_TENANT_SERIES, default 256 distinct values per
    process). Returns False — and counts the drop in
    ``obs_tenant_series_capped_total`` — for unseen tenants past the
    cap: their observations still land in the aggregate series, they
    just don't mint new per-tenant ones."""
    if not tenant:
        return False
    if tenant in _TENANT_SERIES:
        return True
    if len(_TENANT_SERIES) >= _MAX_TENANT_SERIES:
        REGISTRY.counter(
            "obs_tenant_series_capped_total",
            "per-tenant observations folded into the aggregate because "
            "the distinct-tenant cap was hit "
            "(PADDLE_TPU_MAX_TENANT_SERIES)").inc()
        return False
    _TENANT_SERIES.add(tenant)
    return True


def split_metric(name):
    """Invert tenant_metric: ``("ttft@acme") -> ("ttft", "acme")``,
    plain names return ``(name, None)``."""
    base, sep, tenant = name.partition("@")
    return (base, tenant) if sep else (name, None)


# --------------------------------------------------------------------------
# streaming quantile sketch
# --------------------------------------------------------------------------

class QuantileSketch:
    """Bounded-memory streaming quantiles, KLL-compactor style.

    Level ``i`` holds items each representing ``2**i`` observations;
    when a level overflows ``k`` items it is sorted and every other item
    is promoted to level ``i+1`` (the kept offset alternates
    deterministically, cancelling the sampling bias a fixed offset
    would accumulate). Worst-case rank error is
    O(n * levels / (2k)) — with the default k=256 that is ~1-2% of rank
    for the request counts a serving process sees between scrapes,
    verified against exact percentiles in tests/test_request_tracing.py.
    Mergeable: ``merge`` concatenates levels pairwise and recompacts, so
    per-replica sketches roll up into one fleet percentile without the
    raw samples ever crossing the wire.
    """

    __slots__ = ("k", "_levels", "count", "min", "max", "_flip", "_lock")

    def __init__(self, k=256):
        self.k = int(k)
        self._levels = [[]]
        self.count = 0
        self.min = None
        self.max = None
        self._flip = 0
        self._lock = threading.Lock()

    def add(self, v):
        if not _ENABLED[0]:
            return
        v = float(v)
        with self._lock:
            self.count += 1
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
            self._levels[0].append(v)
            self._compact()

    def _compact(self):
        # caller holds the lock
        i = 0
        while i < len(self._levels):
            buf = self._levels[i]
            if len(buf) <= self.k:
                i += 1
                continue
            buf.sort()
            keep = buf[self._flip::2]
            self._flip ^= 1
            self._levels[i] = []
            if i + 1 == len(self._levels):
                self._levels.append([])
            self._levels[i + 1].extend(keep)
            i += 1

    def quantile(self, q):
        """Approximate q-quantile (0..1) of everything observed."""
        with self._lock:
            items = [(v, 1 << lvl)
                     for lvl, buf in enumerate(self._levels) for v in buf]
            total = sum(w for _, w in items)
            lo, hi = self.min, self.max
        if not items:
            return None
        if q <= 0:
            return lo
        if q >= 1:
            return hi
        items.sort()
        target = q * total
        cum = 0
        for v, w in items:
            cum += w
            if cum >= target:
                return v
        return hi

    def merge(self, other):
        """Fold another sketch (or exported state dict) into this one."""
        if isinstance(other, dict):
            other = QuantileSketch.from_state(other)
        with other._lock:
            levels = [list(buf) for buf in other._levels]
            count, omin, omax = other.count, other.min, other.max
        with self._lock:
            while len(self._levels) < len(levels):
                self._levels.append([])
            for i, buf in enumerate(levels):
                self._levels[i].extend(buf)
            self.count += count
            if omin is not None and (self.min is None or omin < self.min):
                self.min = omin
            if omax is not None and (self.max is None or omax > self.max):
                self.max = omax
            self._compact()
        return self

    def state(self):
        """JSON-able snapshot — the fleet metrics wire format."""
        with self._lock:
            return {"k": self.k, "count": self.count,
                    "min": self.min, "max": self.max,
                    "levels": [list(buf) for buf in self._levels]}

    @classmethod
    def from_state(cls, st):
        sk = cls(k=st.get("k", 256))
        sk.count = int(st.get("count", 0))
        sk.min = st.get("min")
        sk.max = st.get("max")
        sk._levels = [list(map(float, buf))
                      for buf in st.get("levels", [[]])] or [[]]
        return sk

    @classmethod
    def window_diff(cls, prev_state, cur_state):
        """Sketch of the observations that arrived BETWEEN two ``state()``
        snapshots of the same sketch, without ever resetting it — the
        load harness reads per-load-point percentiles off the engine's
        lifetime sketches this way.

        Returns ``(sketch, exact)``. The observation COUNT of the window
        is always exact (``cur.count - prev.count``). The items are
        exact as long as no compaction crossed the snapshot boundary:
        levels only ever grow by appending until a compaction rewrites
        them, so each current level whose prefix still equals the
        previous snapshot's level contributes exactly its new suffix.
        A rewritten level (prefix mismatch) contributes all its
        survivors — they stand in for both windows — and flips `exact`
        to False; with the default k=256 that only happens once the
        window itself holds hundreds of observations, where the
        approximation error is the sketch's own rank error."""
        cur = cur_state or {}
        prev = prev_state or {}
        sk = cls(k=int(cur.get("k", 256)))
        exact = True
        prev_levels = prev.get("levels") or []
        for i, buf in enumerate(cur.get("levels") or []):
            buf = list(map(float, buf))
            pb = list(map(float, prev_levels[i])) \
                if i < len(prev_levels) else []
            if len(pb) <= len(buf) and buf[:len(pb)] == pb:
                new = buf[len(pb):]
            else:               # compaction crossed the boundary
                new = buf
                exact = False
            while len(sk._levels) <= i:
                sk._levels.append([])
            sk._levels[i].extend(new)
        items = [v for buf in sk._levels for v in buf]
        sk.min = min(items) if items else None
        sk.max = max(items) if items else None
        sk.count = max(0, int(cur.get("count", 0))
                       - int(prev.get("count", 0)))
        return sk, exact

    def reset(self):
        with self._lock:
            self._levels = [[]]
            self.count = 0
            self.min = None
            self.max = None
            self._flip = 0

    def summary(self):
        return {"count": self.count, "min": self.min, "max": self.max,
                "p50": self.quantile(0.5), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}


# --------------------------------------------------------------------------
# named sketches -> live SLO gauges (registry collector)
# --------------------------------------------------------------------------

_SKETCHES = {}
_SK_LOCK = threading.Lock()
_QUANTILE_LABELS = ((0.5, "p50"), (0.95, "p95"), (0.99, "p99"))


def sketch(name) -> QuantileSketch:
    """Get-or-create the process-wide named sketch."""
    sk = _SKETCHES.get(name)        # lock-free fast path (GIL)
    if sk is None:
        with _SK_LOCK:
            sk = _SKETCHES.get(name)
            if sk is None:
                sk = _SKETCHES[name] = QuantileSketch()
    return sk


def observe(name, v, tenant=None):
    """One observation into the named sketch (seconds-denominated by
    convention: ttft / tpot / e2e and their fleet_* router-side kin).
    With `tenant`, the observation ALSO lands in the tenant-scoped
    ``name@tenant`` sketch — the aggregate percentiles keep counting
    every request, and the per-tenant sketch makes one tenant's tail
    separable from the fleet's."""
    if not _ENABLED[0]:
        return
    sketch(name).add(v)
    if tenant and tenant_tracked(tenant):
        sketch(tenant_metric(name, tenant)).add(v)


def export_states():
    """{name: sketch state} — what the worker `metrics` verb ships."""
    with _SK_LOCK:
        items = list(_SKETCHES.items())
    return {name: sk.state() for name, sk in items if sk.count}


def merge_states(states_list):
    """Merge many export_states() payloads into {name: QuantileSketch}."""
    out = {}
    for states in states_list:
        for name, st in (states or {}).items():
            out.setdefault(name, QuantileSketch()).merge(st)
    return out


def diff_states(prev_states, cur_states):
    """Per-name window sketches between two export_states()-shaped
    payloads (see ``QuantileSketch.window_diff``): {name: (sketch,
    exact)} for every name with window observations. Names absent from
    `prev_states` diff against empty (the whole sketch is the window)."""
    out = {}
    for name, st in (cur_states or {}).items():
        sk, exact = QuantileSketch.window_diff(
            (prev_states or {}).get(name), st)
        if sk.count:
            out[name] = (sk, exact)
    return out


def _collect_quantiles():
    out = []
    with _SK_LOCK:
        items = list(_SKETCHES.items())
    for name, sk in items:
        if not sk.count:
            continue
        base, tenant = split_metric(name)
        for q, label in _QUANTILE_LABELS:
            labels = {"q": label}
            if tenant:
                # per-tenant sketches publish under the BASE metric name
                # with the tenant as a label, so dashboards select
                # slo_ttft_seconds{tenant=...} instead of chasing
                # per-tenant metric names
                labels["tenant"] = tenant
            out.append({"name": f"slo_{base}_seconds", "type": "gauge",
                        "labels": labels,
                        "description": f"streaming {label} of {base} "
                                       "(mergeable quantile sketch)",
                        "value": sk.quantile(q)})
    return out


def _reset_sketches():
    with _SK_LOCK:
        items = list(_SKETCHES.values())
    for sk in items:
        sk.reset()


REGISTRY.register_collector(_collect_quantiles, reset=_reset_sketches)


# --------------------------------------------------------------------------
# SLO targets -> attainment gauges + slo_violation events
# --------------------------------------------------------------------------

def _env_targets():
    out = {}
    for name in ("ttft", "tpot", "e2e"):
        v = os.environ.get(f"PADDLE_TPU_SLO_{name.upper()}_MS")
        if v:
            try:
                out[name] = float(v)
            except ValueError:
                pass
    return out


_SLO_TARGETS = _env_targets()        # metric name -> budget in ms


def set_slo_targets(**targets_ms):
    """Arm (or with None, disarm) per-metric SLO budgets in ms, e.g.
    ``set_slo_targets(ttft_ms=250, e2e_ms=5000)``. Metric names may be
    passed with or without the ``_ms`` suffix."""
    for k, v in targets_ms.items():
        name = k[:-3] if k.endswith("_ms") else k
        if v is None:
            _SLO_TARGETS.pop(name, None)
        else:
            _SLO_TARGETS[name] = float(v)
    return dict(_SLO_TARGETS)


def slo_targets():
    return dict(_SLO_TARGETS)


def check_slo(metric, seconds, trace=None, rid=None, target_ms=None,
              tenant=None):
    """Grade one observation against its budget (per-request target_ms
    wins over the armed default; with neither, a no-op). Updates the
    checks/violations counters and the live attainment gauge; a miss
    records a ``slo_violation`` event carrying the trace id. With
    `tenant`, the SAME grade also lands in the tenant-labeled series —
    the aggregate attainment keeps grading every request, and
    ``slo_attainment{metric=,tenant=}`` answers whose SLO an overload
    actually broke. The checks/violations counters being
    plain additive counters is what lets the fleet plane re-derive
    per-tenant attainment across replicas (fleet_snapshot)."""
    if not _ENABLED[0]:
        return None
    if target_ms is None:
        target_ms = _SLO_TARGETS.get(metric)
    if target_ms is None:
        return None
    violated = seconds * 1e3 > float(target_ms)
    label_sets = [{"metric": metric}]
    if tenant and tenant_tracked(tenant):
        label_sets.append({"metric": metric, "tenant": str(tenant)})
    for labels in label_sets:
        checks = REGISTRY.counter(
            "slo_checks_total", "requests graded against an SLO budget",
            labels=labels)
        viols = REGISTRY.counter(
            "slo_violations_total",
            "requests that missed their SLO budget", labels=labels)
        checks.inc()
        if violated:
            viols.inc()
        REGISTRY.gauge(
            "slo_attainment", "fraction of graded requests within budget",
            labels=labels).set(1.0 - viols.value / max(1, checks.value))
    if violated:
        EVENTS.record("slo_violation", metric=metric, trace=trace,
                      rid=rid, tenant=tenant,
                      value_ms=round(seconds * 1e3, 3),
                      target_ms=float(target_ms))
    return violated


# --------------------------------------------------------------------------
# fleet metrics plane: merging per-process registry series
# --------------------------------------------------------------------------

# gauges whose values are NOT additive across processes: quantiles are
# re-derived from merged sketches, attainment from merged counters, and
# a previously-published fleet rollup must not feed back into itself
_NON_ADDITIVE_GAUGE_PREFIXES = ("slo_", "fleet_quantile_seconds",
                                "fleet_slo_attainment",
                                "fleet_replica_events_dropped")


def parse_series_key(key):
    """Invert merge_series' ``name{k=v,k2=v2}`` keys back into
    ``(name, labels-dict)`` — how the fleet plane re-derives per-label
    rollups (attainment from merged check/violation counters) and how
    the router's /metrics endpoint renders the merged dict as series."""
    name, brace, inner = key.partition("{")
    if not brace:
        return key, {}
    labels = {}
    for part in inner.rstrip("}").split(","):
        k, eq, v = part.partition("=")
        if eq:
            labels[k] = v
    return name, labels


def merge_series(series_lists, full_histograms=False):
    """Merge many ``MetricsRegistry.collect()`` payloads (one per
    PROCESS — the caller dedupes handles sharing a registry by pid) into
    one snapshot-shaped dict {counters, gauges, histograms}. Counters
    and gauges sum (the fleet view of capacity/traffic gauges is their
    total); same-bucket histograms sum elementwise; quantile gauges are
    dropped here and recomputed from merged sketches by the caller.
    full_histograms=True keeps the merged per-bucket counts (the shape
    a Prometheus exposition needs) instead of the compact summary."""
    counters, gauges, hists = {}, {}, {}

    def key_of(s):
        labels = s.get("labels") or {}
        if labels:
            inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
            return f"{s['name']}{{{inner}}}"
        return s["name"]

    for series in series_lists:
        for s in series or []:
            key = key_of(s)
            t = s.get("type")
            if t == "counter":
                counters[key] = counters.get(key, 0) + s.get("value", 0)
            elif t == "gauge":
                if s["name"].startswith(_NON_ADDITIVE_GAUGE_PREFIXES):
                    continue
                gauges[key] = gauges.get(key, 0) + (s.get("value") or 0)
            elif t == "histogram":
                h = hists.get(key)
                if h is None or h["buckets"] != list(s["buckets"]):
                    if h is not None:
                        continue        # bucket mismatch: keep the first
                    hists[key] = {
                        "buckets": list(s["buckets"]),
                        "counts": list(s["counts"]),
                        "sum": s.get("sum", 0.0),
                        "count": s.get("count", 0),
                        "min": s.get("min"), "max": s.get("max")}
                else:
                    h["counts"] = [a + b for a, b in
                                   zip(h["counts"], s["counts"])]
                    h["sum"] += s.get("sum", 0.0)
                    h["count"] += s.get("count", 0)
                    for fld, pick in (("min", min), ("max", max)):
                        v = s.get(fld)
                        if v is not None:
                            h[fld] = v if h[fld] is None \
                                else pick(h[fld], v)
    if full_histograms:
        hist_out = hists
    else:
        hist_out = {k: {"count": h["count"], "sum": round(h["sum"], 6),
                        "min": h["min"], "max": h["max"]}
                    for k, h in hists.items()}
    return {"counters": counters, "gauges": gauges,
            "histograms": hist_out}
