"""Exporters: Prometheus text exposition, JSONL dumps, merged chrome trace.

Three consumers, three formats:

- ``prometheus_text()`` — the pull-scrape format (text exposition 0.0.4)
  for wiring a long-lived serving/training process into an existing
  Prometheus stack; histograms render cumulative ``_bucket{le=...}``
  series plus ``_sum``/``_count``.
- ``dump_metrics_json`` / ``dump_events_jsonl`` — file artifacts for
  tools/obs_report.py and for embedding in BENCH records.
- ``chrome_trace()`` — one chrome://tracing JSON interleaving the
  profiler's host ``RecordEvent`` spans (``paddle_tpu_torch.profiler``)
  with the observability events as instant marks (ph="i") and the
  request spans (ph="X"), one lane per trace id.
"""

from __future__ import annotations

import json
import os
import re

from .metrics import REGISTRY
from .events import EVENTS, _json_default

__all__ = ["prometheus_text", "dump_metrics_json", "dump_events_jsonl",
           "chrome_trace", "serve_prometheus"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_RE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name):
    n = _NAME_RE.sub("_", name)
    if n and n[0].isdigit():
        n = "_" + n
    return n


def _prom_labels(labels, extra=None):
    items = list(sorted((labels or {}).items())) + list(extra or [])
    if not items:
        return ""
    def esc(v):
        return str(v).replace("\\", "\\\\").replace('"', '\\"') \
            .replace("\n", "\\n")
    return "{" + ",".join(
        f'{_LABEL_RE.sub("_", str(k))}="{esc(v)}"' for k, v in items) + "}"


# Per-tenant COST counters are the one series family whose
# label cardinality scales with the customer base, not the codebase —
# the exposition folds them to the top-N tenants by attributed
# device-seconds plus one aggregate ``tenant="other"`` row, so a scrape
# stays bounded no matter how many tenants the ledger saw. The knob:
# PADDLE_TPU_PROM_TENANT_TOPN (default 20; 0 disables folding). Both
# ``serve_prometheus`` and ``Router.serve_metrics`` render through
# ``prometheus_text``, so the bound holds on the replica AND the fleet
# endpoint.
_TENANT_COST_SERIES = frozenset((
    "tenant_device_seconds_total", "tenant_kv_page_seconds_total",
    "tenant_bytes_moved_total", "tenant_waste_seconds_total"))


def _fold_tenant_costs(series, top_n=None):
    """Fold tenant-labeled cost series beyond the top-N (ranked by
    tenant_device_seconds_total) into one ``tenant="other"`` row per
    (name, other-labels) group. Values sum, so fleet totals survive."""
    if top_n is None:
        top_n = int(os.environ.get("PADDLE_TPU_PROM_TENANT_TOPN", "20"))
    if top_n <= 0:
        return series
    cost = {}           # tenant -> attributed device-seconds (rank key)
    tenants = set()
    for s in series:
        t = (s.get("labels") or {}).get("tenant")
        if s["name"] in _TENANT_COST_SERIES and t:
            tenants.add(t)
            if s["name"] == "tenant_device_seconds_total":
                cost[t] = cost.get(t, 0.0) + (s.get("value") or 0)
    if len(tenants) <= top_n:
        return series
    keep = set(sorted(tenants,
                      key=lambda t: (-cost.get(t, 0.0), t))[:top_n])
    out, folded = [], {}
    for s in series:
        la = s.get("labels") or {}
        t = la.get("tenant")
        if s["name"] not in _TENANT_COST_SERIES or not t or t in keep:
            out.append(s)
            continue
        key = (s["name"], tuple(sorted(
            (k, v) for k, v in la.items() if k != "tenant")))
        cur = folded.get(key)
        if cur is None:
            la2 = {k: v for k, v in la.items() if k != "tenant"}
            la2["tenant"] = "other"
            cur = folded[key] = dict(s, labels=la2, value=0.0)
            out.append(cur)
        cur["value"] = (cur.get("value") or 0) + (s.get("value") or 0)
    return out


def prometheus_text(registry=REGISTRY):
    """Text exposition of every live series (instruments + collectors).
    Tenant-labeled cost counters are folded to top-N + ``other`` — see
    ``_fold_tenant_costs``."""
    lines = []
    typed = set()
    for s in _fold_tenant_costs(list(registry.collect())):
        name = _prom_name(s["name"])
        if name not in typed:
            typed.add(name)
            if s.get("description"):
                lines.append(f"# HELP {name} {s['description']}")
            lines.append(f"# TYPE {name} {s['type']}")
        if s["type"] in ("counter", "gauge"):
            lines.append(f"{name}{_prom_labels(s.get('labels'))} "
                         f"{s['value']}")
        else:   # histogram: cumulative buckets + sum/count
            cum = 0
            for bound, c in zip(s["buckets"], s["counts"]):
                cum += c
                lines.append(
                    f"{name}_bucket"
                    f"{_prom_labels(s.get('labels'), [('le', bound)])} "
                    f"{cum}")
            cum += s["counts"][-1]
            lines.append(
                f"{name}_bucket"
                f"{_prom_labels(s.get('labels'), [('le', '+Inf')])} {cum}")
            lines.append(f"{name}_sum{_prom_labels(s.get('labels'))} "
                         f"{s['sum']}")
            lines.append(f"{name}_count{_prom_labels(s.get('labels'))} "
                         f"{s['count']}")
    return "\n".join(lines) + "\n"


def serve_prometheus(port=0, host="127.0.0.1", registry=REGISTRY):
    """Stdlib-only pull-model scrape endpoint: a daemon-threaded HTTP
    server answering GET ``/metrics`` (and ``/``) with the text
    exposition of `registry` — parity with what a push pipeline gets
    from ``prometheus_text()``, for deployments that scrape instead.
    port=0 binds an ephemeral port; read it from ``server.server_port``.
    Returns the server; call ``server.shutdown()`` to stop. Never
    imports beyond the stdlib and never blocks the caller."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    import threading

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.split("?")[0].rstrip("/") not in ("", "/metrics"):
                self.send_error(404)
                return
            try:
                body = prometheus_text(registry).encode()
            except Exception as e:  # noqa: BLE001 — a broken collector
                self.send_error(500, str(e)[:80])   # must not kill serving
                return
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):   # scrapes must not spam stdout
            pass

    srv = ThreadingHTTPServer((host, port), _Handler)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True,
                     name=f"prom-scrape:{srv.server_port}").start()
    return srv


def dump_metrics_json(path, registry=REGISTRY):
    """Write the compact snapshot ({counters, gauges, histograms})."""
    with open(path, "w") as f:
        json.dump(registry.snapshot(), f, indent=1, default=_json_default)
    return path


def dump_events_jsonl(path, events=EVENTS):
    """Write the event ring buffer as JSONL. Returns the event count."""
    return events.export_jsonl(path)


def _host_spans():
    """The profiler's buffered RecordEvent spans (already chrome-trace
    shaped). Lazy import: the exporters must not force the profiler into
    every import graph."""
    try:
        from ..profiler import _host
        return _host.all_events()
    except Exception:  # noqa: BLE001 — spans are optional garnish
        return []


def chrome_trace(path=None, events=EVENTS, include_host_spans=True,
                 include_metric_marks=True):
    """Merged chrome://tracing dict; written to `path` when given.

    Host RecordEvent spans keep their (pid, tid, ts, dur); observability
    events become instant events on a synthetic 'observability' thread,
    with their fields in args, and spans one lane per trace id."""
    trace = []
    meta = []
    if include_host_spans:
        trace.extend(_host_spans())
    if include_metric_marks:
        pid = os.getpid()
        # Trace Event Format wants integer tids: park the marks on a
        # sentinel thread and name it via metadata (strict parsers like
        # Perfetto's legacy importer drop string-tid events)
        obs_tid = 0
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": obs_tid,
                     "args": {"name": "observability"}})
        # span events (tracing) get one lane per trace id so
        # concurrent requests render as parallel tracks, not a stack of
        # overlapping slices on one row
        trace_tids = {}
        for ev in events.events():
            args = {k: v for k, v in ev.items()
                    if k not in ("ts", "mono_us", "kind")}
            args = json.loads(json.dumps(args, default=_json_default))
            if ev["kind"] == "span":
                tr = ev.get("trace")
                tid = trace_tids.get(tr)
                if tid is None:
                    tid = trace_tids[tr] = 16 + len(trace_tids)
                    meta.append({
                        "name": "thread_name", "ph": "M", "pid": pid,
                        "tid": tid,
                        "args": {"name": f"trace {str(tr)[:8]}" if tr
                                 else "spans"}})
                trace.append({
                    "name": ev.get("name", "span"), "ph": "X",
                    "pid": pid, "tid": tid, "ts": ev["mono_us"],
                    "dur": ev.get("dur_us", 0.0), "args": args})
                continue
            trace.append({
                "name": ev["kind"], "ph": "i", "s": "p",
                "pid": pid, "tid": obs_tid,
                "ts": ev["mono_us"],
                "args": args})
    trace.sort(key=lambda e: e.get("ts", 0))
    doc = {"traceEvents": meta + trace}
    if path is not None:
        with open(path, "w") as f:
            json.dump(doc, f, default=_json_default)
    return doc
