"""The fleet doctor: correlates detector firings into ranked, named
findings (the interpretation layer's brain).

``Doctor`` owns a stateful detector set (observability/detectors.py)
and a sliding observation window. Each ``observe()`` call:

1. builds a ``Window`` from the previous and current metric snapshots,
   the events that arrived in between (sliced off the bounded ring by a
   ``mono_us`` watermark), and the quantile-sketch states of both edges;
2. runs every detector;
3. **correlates**: a SYMPTOM finding (latency/step-wall drift, goodput
   collapse, SLO breach) that fired in the same window as CAUSE
   findings (recompile storm, kernel fallback spike, queue buildup,
   replica death, ...) absorbs them as ``evidence["coincident"]`` and
   its summary gains the attribution clause — "tpot_p95 regression
   coincident with kernel fallback spike on op=ragged_attention";
4. publishes ``doctor_findings{finding=}`` gauges (1 while active,
   reset to 0 when a finding clears) and records one ``diagnosis``
   event per finding, evidence attached — machine-consumable breach/
   attribution signals (ROADMAP item 5 feeds on these);
5. returns the findings ranked most-severe-and-most-attributed first.

The doctor runs in three homes, all through this one class:

- **router sweep** — ``Router.start_doctor()`` feeds it
  ``fleet_snapshot()`` merges periodically (serving/router.py);
- **worker verb** — every replica answers a ``doctor`` verb with its
  own per-process findings (serving/replica.py + worker.py);
- **training hook** — ``ResilientTrainer`` baselines a doctor at
  ``run()`` start and calls ``diagnose_episode`` after every recovery
  episode and rollback (distributed/resilient.py).

``expected`` names findings that are deliberate in the current context
(a drill SIGKILLs replicas on purpose): they are still detected,
recorded, and gauged, but ``report()`` files them separately so "zero
unexpected findings" stays assertable — bench.py embeds exactly that
verdict in its final record.
"""

from __future__ import annotations

import threading

from .metrics import REGISTRY, _ENABLED
from .events import EVENTS
from . import tracing as _tracing
from .detectors import (Window, default_detectors, SEVERITY_RANK,
                        SYMPTOM_FINDINGS, CAUSE_FINDINGS)

__all__ = ["Doctor", "findings_brief"]


def _cause_clause(cause):
    """The attribution clause a correlated symptom's summary gains."""
    ev = cause.get("evidence") or {}
    detail = ""
    if cause["finding"] == "kernel_fallback_spike":
        rows = ev.get("by_labels") or []
        if rows:
            detail = (f" on op={rows[0].get('op', '?')}, "
                      f"backend={rows[0].get('backend', '?')}")
    elif cause["finding"] in ("replica_death", "suspect_replica",
                              "replica_drain"):
        reps = ev.get("replicas") or []
        if reps:
            detail = f" ({', '.join(reps)})"
    elif cause["finding"] == "recompile_storm":
        ops = ev.get("by_op") or {}
        if ops:
            top = max(ops, key=ops.get)
            detail = f" (top: {top})"
    return cause["finding"].replace("_", " ") + detail


def findings_brief(findings):
    """[{finding, severity, summary}] — the compact JSON-able form the
    bench record and the drill checks embed."""
    return [{"finding": f["finding"], "severity": f["severity"],
             "summary": f["summary"]} for f in findings]


class Doctor:
    """See the module docstring. Thread-safe: the router's sweep thread
    and a caller's manual ``observe()`` may interleave."""

    def __init__(self, name="doctor", detectors=None, expected=(),
                 registry=None, events=None):
        self.name = name
        self._detectors = detectors if detectors is not None \
            else default_detectors()
        self.expected = set(expected)
        self._registry = registry or REGISTRY
        self._events = events or EVENTS
        self._lock = threading.Lock()
        self._prev_snap = None
        self._prev_sketches = None
        self._mono_watermark = 0.0
        self._active = set()        # finding names currently gauged 1
        self.last_findings = []     # unexpected, ranked
        self.last_expected = []
        self.windows = 0

    # -- window assembly --------------------------------------------------
    def _own_snapshot(self):
        return self._registry.snapshot()

    def _new_events(self):
        """Events recorded since the previous observe (mono_us
        watermark over the bounded ring; doctor's own ``diagnosis``
        events are excluded so a finding can never feed itself)."""
        evs = [e for e in self._events.events()
               if e.get("mono_us", 0.0) > self._mono_watermark
               and e.get("kind") != "diagnosis"]
        return evs

    def observe(self, snapshot=None, events=None, sketches=None,
                flight=None):
        """One sweep. With no arguments, observes the in-process
        registry/event-ring/sketches (the worker and trainer homes);
        the router sweep passes its ``fleet_snapshot()`` merge and the
        merged sketch states instead. The FIRST observe is the
        baseline: it primes the window edges and returns []. Returns
        the ranked unexpected findings (``last_expected`` carries the
        rest)."""
        if not _ENABLED[0]:
            return []
        with self._lock:
            own_events = events is None
            if snapshot is None:
                snapshot = self._own_snapshot()
            if sketches is None:
                sketches = _tracing.export_states()
            if own_events:
                events = self._new_events()
                if events:
                    self._mono_watermark = max(
                        e.get("mono_us", 0.0) for e in events)
            prev, self._prev_snap = self._prev_snap, snapshot
            prev_sk, self._prev_sketches = self._prev_sketches, sketches
            first = prev is None
            window = Window(prev, snapshot, events=events,
                            sketches_prev=prev_sk,
                            sketches_cur=sketches, flight=flight)
            findings = []
            if not first:
                for det in self._detectors:
                    try:
                        findings.extend(det.observe(window))
                    except Exception as e:  # noqa: BLE001 — one broken
                        # detector must not take down the sweep; surface
                        # it as its own finding instead of silence
                        findings.append({
                            "finding": "detector_error",
                            "detector": det.name, "severity": "warn",
                            "summary": f"detector {det.name} raised "
                                       f"{type(e).__name__}: "
                                       f"{str(e)[:120]}",
                            "evidence": {}, "traces": []})
            findings = self._correlate(findings)
            self.windows += 1
            unexpected = [f for f in findings
                          if f["finding"] not in self.expected]
            expected = [f for f in findings
                        if f["finding"] in self.expected]
            self.last_findings = unexpected
            self.last_expected = expected
            self._publish(findings)
        return unexpected

    # -- correlation + ranking --------------------------------------------
    def _correlate(self, findings):
        causes = [f for f in findings if f["finding"] in CAUSE_FINDINGS]
        for f in findings:
            if f["finding"] in SYMPTOM_FINDINGS and causes:
                f.setdefault("evidence", {})["coincident"] = [
                    {"finding": c["finding"], "summary": c["summary"]}
                    for c in causes]
                f["summary"] += " — coincident with " + ", ".join(
                    _cause_clause(c) for c in causes[:3])

        def rank(f):
            attributed = 0 if f.get("evidence", {}).get("coincident") \
                else 1
            kind = 0 if f["finding"] in SYMPTOM_FINDINGS else (
                1 if f["finding"] in CAUSE_FINDINGS else 2)
            return (SEVERITY_RANK.get(f["severity"], 3), attributed,
                    kind, f["finding"])
        return sorted(findings, key=rank)

    # -- publication ------------------------------------------------------
    def _publish(self, findings):
        """``doctor_findings{finding=}`` gauges (1 active / 0 cleared)
        + one ``diagnosis`` event per finding. The gauges make the
        doctor's verdict scrapeable from the same /metrics pane as the
        raw instruments; the events make it attributable (evidence +
        trace ids ride along)."""
        now_active = set()
        for f in findings:
            now_active.add(f["finding"])
            # labels carry the DOCTOR too: independent doctors sharing
            # one registry (router fleet sweep + a polled per-replica
            # doctor in the same process) must not clobber each
            # other's active/cleared state on the same finding name
            self._registry.gauge(
                "doctor_findings",
                "active doctor findings (1 while firing, 0 cleared)",
                labels={"finding": f["finding"],
                        "doctor": self.name}).set(1)
            self._events.record(
                "diagnosis", doctor=self.name, finding=f["finding"],
                detector=f.get("detector"), severity=f["severity"],
                summary=f["summary"], evidence=f.get("evidence"),
                traces=f.get("traces") or [],
                expected=f["finding"] in self.expected)
        for cleared in self._active - now_active:
            self._registry.gauge(
                "doctor_findings",
                "active doctor findings (1 while firing, 0 cleared)",
                labels={"finding": cleared, "doctor": self.name}).set(0)
        self._active = now_active

    # -- reporting --------------------------------------------------------
    def report(self):
        """JSON-able verdict of the LAST window: {findings, expected,
        clean, windows}. ``clean`` means zero unexpected findings —
        what bench.py asserts and embeds."""
        return {"doctor": self.name,
                "windows": self.windows,
                "clean": not self.last_findings,
                "findings": findings_brief(self.last_findings),
                "expected": findings_brief(self.last_expected)}

    def diagnose_episode(self, context, **info):
        """The training home's per-episode hook: run one sweep NOW and
        record a single ``diagnosis`` event for the episode itself,
        naming the context (fault type / rollback) and whatever
        findings the window surfaced — "every recovery episode gets a
        diagnosis", even when the detectors have nothing to add.
        Returns the findings."""
        findings = self.observe()
        all_f = findings + self.last_expected
        self._events.record(
            "diagnosis", doctor=self.name, finding="recovery_episode",
            detector="doctor", severity="info",
            summary=f"recovery episode ({context}): "
                    + (", ".join(f["finding"] for f in all_f)
                       if all_f else "no coincident anomaly detected"),
            evidence=dict(info, context=context,
                          findings=[f["finding"] for f in all_f]),
            traces=[])
        return findings
