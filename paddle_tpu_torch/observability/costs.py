"""paddle_tpu_torch.observability.costs — per-request cost attribution.

The fleet measures what every tenant *experiences* (latency sketches,
SLO grades) but not what every tenant *costs*: fused dispatches batch
many riders into one launch, CoW prefix pages are shared across
sequences, spec-decode drafts tokens that get rejected, and preempted/
hedged/abandoned requests burn compute that vanishes into aggregate
counters. The ``CostLedger`` here closes that gap by attributing every
unit of engine resource to a ``(trace, tenant)`` pair:

- **device-seconds** — each fused dispatch's wall window is split
  across its riders proportional to their row/token counts in that
  launch (``on_dispatch``). The engine also books the unsplit window
  into ``engine_busy_seconds_total``; the two must agree — that is the
  conservation identity ``tools/cost_audit.py`` enforces (attributed
  >= 95% of busy).
- **KV page-seconds** — integrated at engine step boundaries
  (``on_page_interval``): each live slot is charged its block table,
  with a page shared by ``r`` sequences (CoW prefix) costing each
  holder ``1/r``. Per-page shares sum to exactly 1, so the attributed
  integral equals the pool-occupancy integral — the second audit link.
- **bytes moved** — KV export/import/spill/upload payload bytes from
  the kv_transfer path (``on_bytes``).
- **waste** — a closed taxonomy (``WASTE_REASONS``) of resource spent
  on work that delivered nothing: spec-rejected draft rows, preemption
  re-prefill tokens, hedge-loser sunk work, and everything sunk into
  cancelled / deadline-expired / abandoned requests. An unknown reason
  is folded to ``other`` AND counted in
  ``cost_waste_unknown_reason_total`` so the audit can fail loudly.

Costs ride two surfaces at once:

1. per-trace accumulators, attached to the ``request_done`` event when
   the engine retires (or tears down) the request — ``close()``;
2. per-tenant registry counters (``tenant_device_seconds_total``,
   ``tenant_kv_page_seconds_total``, ``tenant_bytes_moved_total``,
   ``tenant_waste_seconds_total{reason=}``) which ride the worker
   metrics verb and merge additively in ``Router.fleet_snapshot()`` —
   one fleet-wide cost table per tenant, no wire changes. Tenant label
   cardinality is bounded by the same ``tenant_tracked`` cap the
   latency sketches use (PADDLE_TPU_MAX_TENANT_SERIES, default 256);
   the Prometheus exporter folds further to top-N + ``other`` at
   render time (see exporters.py).

Stdlib-only (threading/os/collections + the registry + tracing), so it
imports from the engine without touching jax. Every hot-path entry
point first checks the registry's enabled flag and reduces to a
compare-and-return when observability is off.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

from .metrics import REGISTRY as _REG, _ENABLED as _OBS_ON
from . import tracing as _TR

# The closed waste taxonomy. Every unit of waste the engine books must
# land in one of these buckets — cost_audit's waste-bucket link fails
# when cost_waste_unknown_reason_total moves.
WASTE_REASONS = frozenset({
    "spec_rejected",        # draft rows the verify dispatch refuted
    "preempt_reprefill",    # tokens recomputed after a preemption
    "hedge_loser",          # work sunk into a hedge race's loser
    "cancelled",            # work sunk into an explicitly cancelled req
    "deadline_exceeded",    # work sunk into a deadline-expired req
    "abandoned",            # work sunk after the consumer walked away
})

# Kinds a dispatch window can be split under (by_kind breakdown on the
# request_done cost record).
DISPATCH_KINDS = ("prefill", "decode", "spec_verify")

_MAX_TRACES = int(os.environ.get("PADDLE_TPU_COST_MAX_TRACES", "8192"))

# -- aggregate (unlabeled) counters: the conservation side ---------------
_C_DEV_ATTR = _REG.counter(
    "cost_device_seconds_total",
    "dispatch wall-seconds attributed to riders (sum over kinds/traces)")
_C_PAGE_ATTR = _REG.counter(
    "cost_page_seconds_total",
    "KV page-seconds attributed to live sequences (CoW split by refcount)")
_C_PAGE_POOL = _REG.counter(
    "cost_pool_page_seconds_total",
    "pool-occupancy integral: allocated pages x dt at step boundaries")
_C_WASTE_UNKNOWN = _REG.counter(
    "cost_waste_unknown_reason_total",
    "waste booked under a reason outside WASTE_REASONS (audit tripwire)")
_C_EVICT = _REG.counter(
    "cost_ledger_evictions_total",
    "per-trace cost entries evicted before close (ledger cap hit)")


def _kind_counter(kind):
    return _REG.counter(
        "cost_device_seconds_by_kind_total",
        "attributed dispatch wall-seconds by launch kind",
        labels={"kind": kind})


def _dir_counter(direction):
    return _REG.counter(
        "cost_bytes_moved_total",
        "KV payload bytes moved (export/import/spill/upload)",
        labels={"dir": direction})


def _waste_counter(reason):
    return _REG.counter(
        "cost_waste_seconds_total",
        "device-seconds spent on work that delivered nothing, by reason",
        labels={"reason": reason})


def _waste_tok_counter(reason):
    return _REG.counter(
        "cost_waste_tokens_total",
        "tokens' worth of discarded/recomputed work, by reason",
        labels={"reason": reason})


def _tenant_ok(tenant):
    """Per-tenant series are bounded by the shared tenant-cardinality
    cap; None/untracked tenants still count in the aggregates."""
    return bool(tenant) and _TR.tenant_tracked(tenant)


class CostLedger:
    """Process-wide (trace, tenant) resource accumulator. Thread-safe;
    bounded at ``max_traces`` open entries (oldest evicted, counted)."""

    def __init__(self, max_traces=None):
        self._lock = threading.Lock()
        self._max = int(max_traces or _MAX_TRACES)
        self._traces = OrderedDict()    # trace -> cost dict

    # -- internal ---------------------------------------------------------

    def _entry(self, trace, tenant):
        """Caller holds the lock. Traceless charges go to aggregates
        only (a None key entry would never be closed)."""
        if trace is None:
            return None
        e = self._traces.get(trace)
        if e is None:
            if len(self._traces) >= self._max:
                self._traces.popitem(last=False)
                _C_EVICT.inc()
            e = self._traces[trace] = {
                "tenant": tenant, "device_s": 0.0, "by_kind": {},
                "kv_page_s": 0.0, "bytes": 0,
                "waste_s": {}, "waste_tokens": {},
            }
        elif tenant and not e["tenant"]:
            e["tenant"] = tenant
        return e

    # -- charge points (engine hot path; all gated on _OBS_ON) ------------

    def on_dispatch(self, kind, seconds, riders, n_devices=1):
        """Split one fused launch's wall window across its riders.

        ``riders`` is a list of ``(trace, tenant, weight)`` or
        ``(trace, tenant, weight, kind)`` tuples — weight is the rider's
        row/token count in the launch (prompt tokens for prefill rows,
        fused-k for decode rows, 1+drafts for spec rows). A 4-tuple's
        kind overrides the default for mixed launches (ragged
        prefill+decode fusion). The full window is attributed: shares
        sum to ``seconds * n_devices`` whenever there is at least one
        rider.

        ``n_devices``: a mesh-sharded engine's dispatch runs
        one wall window on N devices at once — the billable unit is
        DEVICE-seconds, so the window books wall x n_devices here, and
        the engine scales ``engine_busy_seconds_total`` identically;
        cost_audit's dispatch_split identity (attributed == busy) then
        holds under the per-device busy definition with no slack term."""
        if not _OBS_ON[0] or seconds <= 0 or not riders:
            return
        seconds = float(seconds) * max(1, int(n_devices))
        total_w = 0.0
        for r in riders:
            total_w += max(float(r[2]), 0.0)
        if total_w <= 0:
            return
        per_tenant = {}
        per_kind = {}
        with self._lock:
            for r in riders:
                trace, tenant, w = r[0], r[1], max(float(r[2]), 0.0)
                if w == 0:
                    continue
                rkind = r[3] if len(r) > 3 else kind
                share = seconds * (w / total_w)
                e = self._entry(trace, tenant)
                if e is not None:
                    e["device_s"] += share
                    e["by_kind"][rkind] = \
                        e["by_kind"].get(rkind, 0.0) + share
                per_kind[rkind] = per_kind.get(rkind, 0.0) + share
                if _tenant_ok(tenant):
                    per_tenant[tenant] = \
                        per_tenant.get(tenant, 0.0) + share
        _C_DEV_ATTR.inc(seconds)
        for rkind, s in per_kind.items():
            _kind_counter(rkind).inc(s)
        for tenant, s in per_tenant.items():
            _REG.counter(
                "tenant_device_seconds_total",
                "attributed dispatch wall-seconds per tenant",
                labels={"tenant": tenant}).inc(s)

    def on_page_interval(self, dt, holders, occupied_pages):
        """Integrate KV page occupancy over one step interval.

        ``holders`` maps ``(trace, tenant)`` to the holder's page share
        at the interval boundary (sum over its block table of
        ``1/refcount[page]`` — a CoW-shared page costs each of its
        ``r`` holders ``1/r``). ``occupied_pages`` is the pool's total
        allocated-page count at the same instant; ``sum(holders) ==
        occupied_pages`` whenever every allocated page sits in exactly
        ``refcount`` block tables, which is the conservation identity
        cost_audit's page-integral link checks (within 1%)."""
        if not _OBS_ON[0] or dt <= 0:
            return
        attributed = 0.0
        per_tenant = {}
        with self._lock:
            for (trace, tenant), pages in holders.items():
                ps = float(pages) * dt
                if ps <= 0:
                    continue
                attributed += ps
                e = self._entry(trace, tenant)
                if e is not None:
                    e["kv_page_s"] += ps
                if _tenant_ok(tenant):
                    per_tenant[tenant] = per_tenant.get(tenant, 0.0) + ps
        if attributed:
            _C_PAGE_ATTR.inc(attributed)
        if occupied_pages > 0:
            _C_PAGE_POOL.inc(float(occupied_pages) * dt)
        for tenant, ps in per_tenant.items():
            _REG.counter(
                "tenant_kv_page_seconds_total",
                "attributed KV page-seconds per tenant (CoW split)",
                labels={"tenant": tenant}).inc(ps)

    def on_bytes(self, nbytes, trace=None, tenant=None, direction="out"):
        """KV payload bytes moved on behalf of a request (export /
        import / spill / upload / store traffic)."""
        if not _OBS_ON[0] or nbytes <= 0:
            return
        n = int(nbytes)
        with self._lock:
            e = self._entry(trace, tenant)
            if e is not None:
                e["bytes"] += n
        _dir_counter(direction).inc(n)
        if _tenant_ok(tenant):
            _REG.counter(
                "tenant_bytes_moved_total",
                "KV payload bytes moved per tenant",
                labels={"tenant": tenant}).inc(n)

    def on_waste(self, seconds, reason, trace=None, tenant=None,
                 tokens=0):
        """Book device-seconds (and optionally a token count) of work
        that delivered nothing, under a named taxonomy bucket."""
        if not _OBS_ON[0]:
            return
        if reason not in WASTE_REASONS:
            _C_WASTE_UNKNOWN.inc()
            reason = "other"
        s = max(float(seconds), 0.0)
        t = max(int(tokens), 0)
        if s == 0 and t == 0:
            return
        with self._lock:
            e = self._entry(trace, tenant)
            if e is not None:
                if s:
                    e["waste_s"][reason] = \
                        e["waste_s"].get(reason, 0.0) + s
                if t:
                    e["waste_tokens"][reason] = \
                        e["waste_tokens"].get(reason, 0) + t
        if s:
            _waste_counter(reason).inc(s)
        if t:
            _waste_tok_counter(reason).inc(t)
        if _tenant_ok(tenant):
            if s:
                _REG.counter(
                    "tenant_waste_seconds_total",
                    "wasted device-seconds per tenant, by reason",
                    labels={"tenant": tenant, "reason": reason}).inc(s)

    # -- read side --------------------------------------------------------

    def device_seconds(self, trace):
        """Attributed device-seconds accumulated so far for ``trace``
        (0.0 when unknown) — the 'work sunk' measure a teardown books
        as waste."""
        with self._lock:
            e = self._traces.get(trace)
            return float(e["device_s"]) if e else 0.0

    def cost_of(self, trace):
        """Snapshot (copy) of a trace's open cost entry, or None."""
        with self._lock:
            e = self._traces.get(trace)
            return None if e is None else self._render(e)

    def close(self, trace):
        """Pop and return a trace's cost record (the request_done
        attachment). None for unknown traces — attribution never
        invents an entry at close time."""
        if trace is None:
            return None
        with self._lock:
            e = self._traces.pop(trace, None)
            return None if e is None else self._render(e)

    @staticmethod
    def _render(e):
        out = {
            "device_s": round(e["device_s"], 6),
            "kv_page_s": round(e["kv_page_s"], 6),
            "bytes": int(e["bytes"]),
        }
        if e["by_kind"]:
            out["by_kind"] = {k: round(v, 6)
                              for k, v in sorted(e["by_kind"].items())}
        if e["waste_s"] or e["waste_tokens"]:
            out["waste_s"] = round(sum(e["waste_s"].values()), 6)
            out["waste"] = {k: round(v, 6)
                            for k, v in sorted(e["waste_s"].items())}
            if e["waste_tokens"]:
                out["waste_tokens"] = dict(sorted(
                    e["waste_tokens"].items()))
        return out

    def open_traces(self):
        with self._lock:
            return len(self._traces)

    def reset(self):
        """Drop every open entry (test/bench isolation; the registry's
        counters are reset separately by observability.reset())."""
        with self._lock:
            self._traces.clear()


# The process-wide ledger every engine in this process charges into —
# mirroring REGISTRY/EVENTS: one process == one replica == one ledger,
# and the worker metrics verb scrapes the whole process anyway.
LEDGER = CostLedger()
