"""Streaming anomaly detectors over the recording plane.

PRs 3/5/8/10 built a deep RECORDING plane — the metrics registry, perf
phases, request traces, capacity curves. This module is the first half
of the INTERPRETATION layer: cheap streaming monitors that watch the
existing instruments and turn "the p95 gauge moved" into a structured,
named finding with evidence attached.

Every detector consumes a ``Window`` — two consecutive snapshot-shaped
metric dicts (``{counters, gauges, histograms}``, the exact shape of
``MetricsRegistry.snapshot()`` AND of ``Router.fleet_snapshot()``'s
merge, so one detector set serves both the in-process and the
fleet-merged home), the events that arrived between them, and the
quantile-sketch states of both edges. ``observe(window)`` returns zero
or more finding dicts:

    {"finding": <stable name>, "detector": <class name>,
     "severity": "info" | "warn" | "critical",
     "summary": <one human line>,
     "evidence": {...metric deltas, offending labels...},
     "traces": [trace ids implicated, when known]}

Design constraints:

- **streaming + stateful**: drift detectors keep a robust EWMA (mean +
  mean-absolute-deviation) per metric and need `warmup` windows before
  they may fire — a cold start or a first compile can never read as a
  regression.
- **delta-based**: counter detectors fire on WINDOW deltas, never on
  lifetime totals, so attaching a doctor to a long-lived process does
  not replay its whole history as one giant anomaly.
- **zero false positives on clean runs**: the closed-loop acceptance
  (tests/test_doctor.py) drives a clean 10-step llama serve run through
  every detector and asserts silence; every threshold below is tuned
  against that bar first and sensitivity second.
- **stdlib-only**: the doctor runs inside the router's health thread
  and the resilient trainer's recovery path; importing it must never
  pull jax/numpy in.
"""

from __future__ import annotations

from .tracing import QuantileSketch, split_metric, parse_series_key

__all__ = [
    "Window", "Detector", "RobustEwma", "DEFAULT_DETECTORS",
    "default_detectors",
    "StepWallDrift", "LatencyDrift", "RecompileStorm",
    "KernelFallbackSpike", "QueueBuildup", "GoodputCollapse",
    "SloBreachStreak", "BadStepStreak", "ReplicaDeath", "SuspectReplica",
    "ReplicaDrain", "LaunchSkewStraggler", "StragglerReplica",
    "CollectiveRegression",
]

SEVERITY_RANK = {"critical": 0, "warn": 1, "info": 2}

# taxonomy: SYMPTOM findings describe what the user feels (latency,
# throughput); CAUSE findings describe a mechanism that explains it.
# The doctor correlates a symptom with the causes that fired in the
# same window ("tpot_p95 regression coincident with fallback spike on
# op=ragged_attention").
SYMPTOM_FINDINGS = frozenset({
    "step_wall_regression", "ttft_p95_regression", "tpot_p95_regression",
    "e2e_p95_regression", "goodput_collapse", "slo_breach_streak",
})
CAUSE_FINDINGS = frozenset({
    "recompile_storm", "kernel_fallback_spike", "queue_buildup",
    "bad_step_streak", "replica_death", "suspect_replica",
    "replica_drain", "launch_skew_straggler", "slow_replica",
    "comm_regression",
})


def _by_source(sketches):
    """Normalize sketch states to ``{source: {name: state}}``. Callers
    pass either one process's flat ``{name: state}`` export (the
    in-process homes) or the fleet plane's per-source map
    (``fleet_snapshot()["sketch_states_by_source"]``) — window_diff is
    only valid within ONE process's sketch, so the per-source shape is
    the canonical one and a flat export becomes a single source."""
    if not sketches:
        return {}
    flat = all(isinstance(v, dict) and ("levels" in v or "count" in v)
               for v in sketches.values())
    return {"_": dict(sketches)} if flat else \
        {src: dict(states or {}) for src, states in sketches.items()}


# the repo's ONE snapshot-key parser (`name{k=v,...}` -> (name, labels))
# lives in tracing; aliased for the Window helpers and tools/run_diff.py
_parse_key = parse_series_key


class Window:
    """One observation window: the metric state at both edges plus the
    events that arrived in between. All lookups tolerate missing
    sections (a fleet merge has no events; an offline snapshot may have
    no sketches)."""

    def __init__(self, prev, cur, events=None, sketches_prev=None,
                 sketches_cur=None, flight=None):
        self.prev = prev or {}
        self.cur = cur or {}
        self.events = list(events or [])
        self.sketches_prev = _by_source(sketches_prev)
        self.sketches_cur = _by_source(sketches_cur)
        self.flight = flight or []      # per-rank flight-recorder dumps

    # -- counters ---------------------------------------------------------
    def _section(self, snap, kind):
        return (snap or {}).get(kind, {}) or {}

    def counter_delta(self, name):
        """Window delta of a counter summed over every labelset."""
        return sum(d for _, d in self.counter_deltas(name))

    def counter_deltas(self, name):
        """[(labels, window delta)] over every labelset of `name` with a
        nonzero delta."""
        cur = self._section(self.cur, "counters")
        prev = self._section(self.prev, "counters")
        out = []
        for key, v in cur.items():
            base, labels = _parse_key(key)
            if base != name:
                continue
            d = v - prev.get(key, 0)
            if d:
                out.append((labels, d))
        return out

    # -- gauges -----------------------------------------------------------
    def gauge(self, name, labels=None, edge="cur"):
        snap = self.cur if edge == "cur" else self.prev
        key = name
        if labels:
            inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
            key = f"{name}{{{inner}}}"
        return self._section(snap, "gauges").get(key)

    # -- histograms -------------------------------------------------------
    def hist_delta(self, name):
        """(count delta, sum delta) of a histogram over the window,
        summed across labelsets."""
        cur = self._section(self.cur, "histograms")
        prev = self._section(self.prev, "histograms")
        n = s = 0.0
        for key, h in cur.items():
            if _parse_key(key)[0] != name:
                continue
            p = prev.get(key) or {}
            n += (h.get("count") or 0) - (p.get("count") or 0)
            s += (h.get("sum") or 0.0) - (p.get("sum") or 0.0)
        return n, s

    # -- events -----------------------------------------------------------
    def events_of(self, kind):
        if kind.endswith("*"):
            pre = kind[:-1]
            return [e for e in self.events
                    if str(e.get("kind", "")).startswith(pre)]
        return [e for e in self.events if e.get("kind") == kind]

    def sketch_names(self):
        """Union of sketch names across every source."""
        out = set()
        for states in self.sketches_cur.values():
            out.update(states)
        return sorted(out)

    def sketch_window(self, name):
        """(window QuantileSketch, exact) of a named sketch across the
        window, or (None, True) when absent/empty for the window.
        The diff runs PER SOURCE process and the per-source window
        sketches merge — ``window_diff``'s append-only-levels property
        holds within one process's sketch, never across a fleet merge
        (a re-merged sketch rewrites its buffers every sweep, and
        diffing it would hand the detector the lifetime distribution
        labeled as a window)."""
        merged, exact, total = None, True, 0
        for src, states in self.sketches_cur.items():
            if src not in self.sketches_prev:
                # a source first seen THIS window (hot-added replica):
                # its states are lifetime history, not a window — it
                # primes the next window's baseline instead, exactly
                # like the doctor's own first observe. A new sketch
                # NAME within a known source is different: all its
                # observations genuinely arrived inside the window.
                continue
            st = states.get(name)
            if st is None:
                continue
            prev_st = self.sketches_prev[src].get(name)
            sk, ex = QuantileSketch.window_diff(prev_st, st)
            if not sk.count:
                continue
            exact = exact and ex
            total += sk.count
            merged = sk if merged is None else merged.merge(sk)
        if merged is None:
            return None, True
        merged.count = total
        return merged, exact


class RobustEwma:
    """Robust streaming baseline: EWMA of the value plus EWMA of the
    absolute deviation (a cheap MAD analogue). ``update`` folds the new
    window in AFTER ``exceeds`` is consulted, so a spike is judged
    against the pre-spike baseline and then (partially) absorbed —
    repeated spikes re-fire until the baseline catches up, a sustained
    shift fires once per streak."""

    def __init__(self, alpha=0.3, warmup=3):
        self.alpha = float(alpha)
        self.warmup = int(warmup)
        self.mean = None
        self.dev = 0.0
        self.n = 0

    @property
    def warmed(self):
        return self.n >= self.warmup and self.mean is not None

    def exceeds(self, value, rel=0.5, k=4.0, floor=0.0):
        """True when `value` sits above the baseline by BOTH the
        relative margin (`rel` of the mean) and the deviation margin
        (`k` robust deviations) — and above the absolute `floor`
        (sub-floor values are noise regardless of ratios: a 40µs step
        "doubling" to 80µs is not a regression)."""
        if not self.warmed or value <= floor:
            return False
        margin = max(self.mean * rel, k * self.dev)
        return value > self.mean + margin

    def update(self, value):
        value = float(value)
        if self.mean is None:
            self.mean = value
        else:
            self.dev = (1 - self.alpha) * self.dev \
                + self.alpha * abs(value - self.mean)
            self.mean = (1 - self.alpha) * self.mean + self.alpha * value
        self.n += 1
        return self


class Detector:
    """Base streaming detector. Subclasses set ``name`` (stable id used
    by tools/doctor_audit.py), ``sources`` (the instrument/event names
    consumed — the audit asserts each still exists and feeds the
    detector), and implement ``observe(window) -> [finding dicts]``."""

    name = "detector"
    sources = ()

    def observe(self, window):  # pragma: no cover - abstract
        raise NotImplementedError

    def finding(self, finding, severity, summary, evidence=None,
                traces=None):
        return {"finding": finding, "detector": self.name,
                "severity": severity, "summary": summary,
                "evidence": evidence or {},
                "traces": sorted({t for t in (traces or []) if t})}


# ---------------------------------------------------------------------------
# drift detectors (robust EWMA baselines)
# ---------------------------------------------------------------------------

class StepWallDrift(Detector):
    """Step wall-time regression: the window's mean step wall
    (``step_wall_seconds`` count/sum deltas) drifts above the robust
    EWMA baseline. Fires the classic "training/serving got slower"
    symptom the doctor then tries to attribute."""

    name = "step_wall_drift"
    sources = ("step_wall_seconds",)

    def __init__(self, rel=0.75, k=5.0, min_steps=3, warmup=3,
                 floor_s=1e-4):
        self.rel, self.k = float(rel), float(k)
        self.min_steps = int(min_steps)
        self.floor_s = float(floor_s)
        self._ewma = RobustEwma(warmup=warmup)

    def observe(self, window):
        n, s = window.hist_delta("step_wall_seconds")
        if n < self.min_steps:
            return []
        mean = s / n
        out = []
        if self._ewma.exceeds(mean, rel=self.rel, k=self.k,
                              floor=self.floor_s):
            base = self._ewma.mean
            out.append(self.finding(
                "step_wall_regression", "warn",
                f"step wall regressed: window mean {mean * 1e3:.2f}ms "
                f"over {n:.0f} steps vs baseline {base * 1e3:.2f}ms "
                f"(x{mean / max(base, 1e-12):.2f})",
                evidence={"window_mean_s": round(mean, 6),
                          "baseline_mean_s": round(base, 6),
                          "window_steps": int(n),
                          "ratio": round(mean / max(base, 1e-12), 3)}))
        self._ewma.update(mean)
        return out


class LatencyDrift(Detector):
    """TTFT/TPOT(/e2e) p95 regression over the window, read off the
    LIFETIME quantile sketches via ``QuantileSketch.window_diff`` — the
    engine never resets its sketches, the detector still sees per-window
    percentiles (count-exact, machinery reused)."""

    name = "latency_drift"
    sources = ("ttft", "tpot")           # named sketches

    def __init__(self, metrics=("ttft", "tpot"), rel=1.0, k=6.0,
                 min_count=5, warmup=3, floor_s=1e-4):
        self.metrics = tuple(metrics)
        self.rel, self.k = float(rel), float(k)
        self.min_count = int(min_count)
        self.warmup = int(warmup)
        self.floor_s = float(floor_s)
        self._ewma = {}

    def observe(self, window):
        out = []
        for name in window.sketch_names():
            base_name, tenant = split_metric(name)
            if base_name not in self.metrics:
                continue
            sk, _exact = window.sketch_window(name)
            if sk is None or sk.count < self.min_count:
                continue
            p95 = sk.quantile(0.95)
            if p95 is None:
                continue
            ewma = self._ewma.get(name)
            if ewma is None:
                ewma = self._ewma[name] = RobustEwma(warmup=self.warmup)
            if ewma.exceeds(p95, rel=self.rel, k=self.k,
                            floor=self.floor_s):
                ev = {"metric": base_name,
                      "window_p95_s": round(p95, 6),
                      "baseline_p95_s": round(ewma.mean, 6),
                      "window_count": sk.count,
                      "ratio": round(p95 / max(ewma.mean, 1e-12), 3)}
                if tenant:
                    ev["tenant"] = tenant
                out.append(self.finding(
                    f"{base_name}_p95_regression", "warn",
                    f"{base_name}_p95 regressed"
                    + (f" for tenant {tenant}" if tenant else "")
                    + f": window p95 {p95 * 1e3:.2f}ms over {sk.count} "
                    f"obs vs baseline {ewma.mean * 1e3:.2f}ms "
                    f"(x{p95 / max(ewma.mean, 1e-12):.2f})",
                    evidence=ev))
            ewma.update(p95)
        return out


class GoodputCollapse(Detector):
    """``perf_goodput`` (productive fraction of step wall) collapsing
    below its own baseline: input starvation, checkpoint stalls, or
    unattributed overhead eating the step."""

    name = "goodput_collapse"
    sources = ("perf_goodput",)

    def __init__(self, drop=0.5, min_baseline=0.05, warmup=3):
        self.drop = float(drop)
        self.min_baseline = float(min_baseline)
        self._ewma = RobustEwma(warmup=warmup)

    def observe(self, window):
        g = window.gauge("perf_goodput")
        if g is None:
            return []
        out = []
        if self._ewma.warmed and self._ewma.mean >= self.min_baseline \
                and g < self._ewma.mean * self.drop:
            out.append(self.finding(
                "goodput_collapse", "warn",
                f"goodput collapsed to {g:.2%} vs baseline "
                f"{self._ewma.mean:.2%} (productive fraction of step "
                "wall; check data_wait/checkpoint phase shares)",
                evidence={"goodput": round(g, 4),
                          "baseline": round(self._ewma.mean, 4)}))
        self._ewma.update(g)
        return out


# ---------------------------------------------------------------------------
# counter-delta detectors
# ---------------------------------------------------------------------------

class RecompileStorm(Detector):
    """Dispatch/engine recompiles inside one window: a shape-unstable
    workload or executable-cache thrash re-tracing programs on the hot
    path. First compiles never count — only the recompile counters."""

    name = "recompile_storm"
    sources = ("dispatch_recompiles_total", "engine_recompiles_total",
               "dispatch_recompile")

    def __init__(self, threshold=3):
        self.threshold = int(threshold)

    def observe(self, window):
        d_disp = window.counter_delta("dispatch_recompiles_total")
        d_eng = window.counter_delta("engine_recompiles_total")
        total = d_disp + d_eng
        if total < self.threshold:
            return []
        evs = window.events_of("dispatch_recompile") \
            + window.events_of("engine_recompile")
        ops = {}
        for e in evs:
            key = e.get("op") or e.get("program") or "?"
            ops[key] = ops.get(key, 0) + 1
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:4]
        return [self.finding(
            "recompile_storm", "warn",
            f"recompile storm: {total:.0f} recompiles in one window "
            f"(dispatch {d_disp:.0f}, engine {d_eng:.0f})"
            + (f"; top: {', '.join(f'{o} x{n}' for o, n in top)}"
               if top else ""),
            evidence={"dispatch_recompiles": d_disp,
                      "engine_recompiles": d_eng,
                      "by_op": dict(top)})]


class KernelFallbackSpike(Detector):
    """``kernel_fallback_total{op,backend,reason}`` moved: the primitive
    layer is no longer running the lowering it was asked for — a routing
    regression hiding behind identical outputs. Evidence names the
    offending (op, backend, reason) labelsets."""

    name = "kernel_fallback_spike"
    sources = ("kernel_fallback_total", "kernel_fallback")

    def __init__(self, threshold=1):
        self.threshold = int(threshold)

    def observe(self, window):
        rows = window.counter_deltas("kernel_fallback_total")
        total = sum(d for _, d in rows)
        if total < self.threshold:
            return []
        rows.sort(key=lambda r: -r[1])
        labels = [f"op={la.get('op', '?')}, "
                  f"backend={la.get('backend', '?')} "
                  f"({la.get('reason', '?')}) x{d:.0f}"
                  for la, d in rows[:4]]
        return [self.finding(
            "kernel_fallback_spike", "warn",
            f"kernel fallback spike: {total:.0f} fallbacks to the xla "
            f"reference this window — {'; '.join(labels)}",
            evidence={"total": total,
                      "by_labels": [dict(la, delta=d)
                                    for la, d in rows[:8]]})]


class QueueBuildup(Detector):
    """Admission stall, three signatures over one gauge + one counter:
    the engine's waiting queue GROWS across consecutive windows
    (``engine_queue_waiting``), a backlog that jumped and then
    PLATEAUS holds above ``sustained_depth`` (a one-window burst to 50
    that arrivals then balance never grows again, but 50 requests are
    still waiting), or admissions roll back for lack of pages
    (``engine_requeues_total``). The fleet merge sums the gauge across
    replicas — buildup anywhere surfaces."""

    name = "queue_buildup"
    sources = ("engine_queue_waiting", "engine_requeues_total")

    def __init__(self, min_depth=4, streak=2, requeue_threshold=3,
                 sustained_depth=None, sustained=3):
        self.min_depth = int(min_depth)
        self.streak = int(streak)
        self.requeue_threshold = int(requeue_threshold)
        self.sustained_depth = int(sustained_depth) \
            if sustained_depth is not None else 2 * self.min_depth
        self.sustained = int(sustained)
        self._growing = 0
        self._above = 0
        self._prev_depth = None

    def observe(self, window):
        out = []
        depth = window.gauge("engine_queue_waiting")
        if depth is not None:
            if self._prev_depth is not None and depth > self._prev_depth \
                    and depth >= self.min_depth:
                self._growing += 1
            elif depth < self.min_depth or (
                    self._prev_depth is not None
                    and depth <= self._prev_depth):
                self._growing = 0
            if self._growing >= self.streak:
                out.append(self.finding(
                    "queue_buildup", "warn",
                    f"queue buildup: {depth:.0f} requests waiting, "
                    f"depth grew {self._growing} consecutive windows "
                    f"(admissions cannot keep up with arrivals)",
                    evidence={"depth": depth,
                              "prev_depth": self._prev_depth,
                              "growing_windows": self._growing}))
                self._growing = 0       # re-arm: fire once per buildup
                self._above = 0         # the plateau rule re-arms too
            self._above = self._above + 1 \
                if depth >= self.sustained_depth else 0
            if self._above >= self.sustained:
                out.append(self.finding(
                    "queue_buildup", "warn",
                    f"sustained backlog: {depth:.0f} requests waiting "
                    f"for {self._above} consecutive windows (depth is "
                    "flat, so the growth rule never fires — but the "
                    "backlog is standing)",
                    evidence={"depth": depth,
                              "sustained_windows": self._above,
                              "sustained_depth": self.sustained_depth}))
                self._above = 0         # re-arm per standing incident
            self._prev_depth = depth
        d_requeue = window.counter_delta("engine_requeues_total")
        if d_requeue >= self.requeue_threshold:
            out.append(self.finding(
                "queue_buildup", "warn",
                f"admission stall: {d_requeue:.0f} admissions rolled "
                "back to the queue this window (KV page pool "
                "exhausted?)",
                evidence={"requeues": d_requeue,
                          "pages_free": window.gauge("engine_pages_free"),
                          "pages_total":
                              window.gauge("engine_pages_total")}))
        return out


class SloBreachStreak(Detector):
    """Armed SLO budgets missed in ``streak`` consecutive windows
    (``slo_violations_total{metric=[,tenant]}`` deltas). One breach is a
    tail event; a streak is an attainment incident. Evidence carries the
    window attainment and the traces of recent ``slo_violation``
    events."""

    name = "slo_breach_streak"
    sources = ("slo_violations_total", "slo_checks_total",
               "slo_violation")

    def __init__(self, streak=2):
        self.streak = int(streak)
        self._streaks = {}

    def observe(self, window):
        out = []
        viols = {tuple(sorted(la.items())): d for la, d in
                 window.counter_deltas("slo_violations_total")}
        checks = {tuple(sorted(la.items())): d for la, d in
                  window.counter_deltas("slo_checks_total")}
        for key in set(self._streaks) | set(viols):
            d = viols.get(key, 0)
            if d <= 0:
                self._streaks.pop(key, None)
                continue
            n = self._streaks.get(key, 0) + 1
            self._streaks[key] = n
            if n < self.streak:
                continue
            labels = dict(key)
            graded = checks.get(key, 0)
            att = 1.0 - d / graded if graded else 0.0
            traces = [e.get("trace")
                      for e in window.events_of("slo_violation")
                      if e.get("metric") == labels.get("metric")]
            out.append(self.finding(
                "slo_breach_streak",
                "critical" if att < 0.5 else "warn",
                f"SLO breach streak: {labels.get('metric')}"
                + (f" (tenant {labels['tenant']})"
                   if labels.get("tenant") else "")
                + f" missed its budget in {n} consecutive windows "
                f"({d:.0f} violations / {graded:.0f} graded this "
                f"window, attainment {att:.0%})",
                evidence={"labels": labels, "violations": d,
                          "graded": graded,
                          "window_attainment": round(att, 4),
                          "streak": n},
                traces=traces))
            self._streaks[key] = 0      # re-arm after reporting
        return out


class BadStepStreak(Detector):
    """Non-finite training steps: BadStepGuard skips
    (``resilient_bad_steps_total``) and snapshot rollbacks
    (``resilient_rollbacks_total``) inside the window. Evidence carries
    the offending steps from the mirrored ``resilient_bad_step``
    events."""

    name = "bad_step_streak"
    sources = ("resilient_bad_steps_total", "resilient_rollbacks_total",
               "resilient_bad_step")

    def __init__(self, threshold=1):
        self.threshold = int(threshold)

    def observe(self, window):
        d_bad = window.counter_delta("resilient_bad_steps_total")
        d_rb = window.counter_delta("resilient_rollbacks_total")
        if d_bad < self.threshold and not d_rb:
            return []
        evs = window.events_of("resilient_bad_step")
        steps = [e.get("step") for e in evs][-8:]
        return [self.finding(
            "bad_step_streak", "critical" if d_rb else "warn",
            f"non-finite steps: {d_bad:.0f} skipped"
            + (f", {d_rb:.0f} snapshot rollbacks" if d_rb else "")
            + (f" (steps {steps})" if steps else "")
            + " — loss/grads went nan/inf (divergence or data poison)",
            evidence={"bad_steps": d_bad, "rollbacks": d_rb,
                      "steps": steps})]


class ReplicaDeath(Detector):
    """Hard replica deaths observed by the router this window
    (``fleet_failovers_total`` / ``fleet_replica_dead`` events), with
    the rerouted-sequence count as blast-radius evidence."""

    name = "replica_death"
    sources = ("fleet_failovers_total", "fleet_replica_dead")

    def observe(self, window):
        d = window.counter_delta("fleet_failovers_total")
        evs = window.events_of("fleet_replica_dead")
        if not d and not evs:
            return []
        names = sorted({e.get("replica") for e in evs if e.get("replica")})
        reasons = {e.get("replica"): str(e.get("reason"))[:80]
                   for e in evs}
        rerouted = window.counter_delta("fleet_requests_rerouted_total")
        return [self.finding(
            "replica_death", "critical",
            f"replica death: {max(d, len(evs)):.0f} failover(s)"
            + (f" — {', '.join(names)}" if names else "")
            + f"; {rerouted:.0f} sequences rerouted",
            evidence={"failovers": max(d, len(evs)),
                      "replicas": names, "reasons": reasons,
                      "rerouted": rerouted,
                      "live": window.gauge("fleet_replicas_live")})]


class SuspectReplica(Detector):
    """Heartbeat-stale suspicions (``fleet_replicas_suspected_total`` /
    ``fleet_replica_suspect`` events): a replica the router stopped
    placing onto without declaring dead — a wedged store, a blackout,
    or a GIL-bound compile."""

    name = "suspect_replica"
    sources = ("fleet_replicas_suspected_total", "fleet_replica_suspect")

    def observe(self, window):
        d = window.counter_delta("fleet_replicas_suspected_total")
        evs = window.events_of("fleet_replica_suspect")
        if not d and not evs:
            return []
        names = sorted({e.get("replica") for e in evs if e.get("replica")})
        reasons = {e.get("replica"): str(e.get("reason"))[:80]
                   for e in evs}
        return [self.finding(
            "suspect_replica", "warn",
            f"suspect replica: {max(d, len(evs)):.0f} stale-heartbeat "
            "suspicion(s)"
            + (f" — {', '.join(names)}" if names else "")
            + " (placement avoidance only; streams keep flowing)",
            evidence={"suspicions": max(d, len(evs)),
                      "replicas": names, "reasons": reasons})]


class ReplicaDrain(Detector):
    """Replica drains in the window (``fleet_drain_exports_total`` /
    ``fleet_replica_draining`` events): deliberate, but the doctor
    reports it so an operator reading a latency blip sees the planned
    handoff next to it. Info severity — a drain is not a fault."""

    name = "replica_drain"
    sources = ("fleet_drain_exports_total", "fleet_replica_draining")

    def observe(self, window):
        d = window.counter_delta("fleet_drain_exports_total")
        evs = window.events_of("fleet_replica_draining")
        if not d and not evs:
            return []
        names = sorted({e.get("replica") for e in evs if e.get("replica")})
        pages = window.counter_delta("fleet_kv_transfer_pages_total")
        return [self.finding(
            "replica_drain", "info",
            f"replica drain: {max(d, len(evs)):.0f} sequence export(s)"
            + (f" off {', '.join(names)}" if names else "")
            + f", {pages:.0f} KV pages transferred instead of recomputed",
            evidence={"drain_exports": d, "replicas": names,
                      "kv_pages_moved": pages,
                      "transfer_fallbacks": window.counter_delta(
                          "fleet_kv_transfer_fallbacks_total")})]


class LaunchSkewStraggler(Detector):
    """Collective launch skew across ranks, from per-rank flight
    recorder dumps (the two-phase rings): for each seq present on
    >= 2 ranks, the spread of start times names the straggler. Only
    meaningful when the doctor is handed flight dumps (multi-rank
    training); silent otherwise."""

    name = "launch_skew_straggler"
    sources = ("flight_recorder",)

    def __init__(self, skew_threshold_us=50_000.0, min_seqs=2):
        self.skew_threshold_us = float(skew_threshold_us)
        self.min_seqs = int(min_seqs)

    def observe(self, window):
        if len(window.flight) < 2:
            return []
        by_seq = {}
        for dump in window.flight:
            rank = dump.get("rank", "?")
            for e in dump.get("entries", []):
                by_seq.setdefault(e["seq"], {})[rank] = e
        late_counts, worst = {}, None
        n_skewed = 0
        for seq, per_rank in by_seq.items():
            if len(per_rank) < 2:
                continue
            starts = {r: e.get("start_us") for r, e in per_rank.items()
                      if e.get("start_us") is not None}
            if len(starts) < 2:
                continue
            lo_r = min(starts, key=starts.get)
            hi_r = max(starts, key=starts.get)
            skew = starts[hi_r] - starts[lo_r]
            if skew < self.skew_threshold_us:
                continue
            n_skewed += 1
            late_counts[hi_r] = late_counts.get(hi_r, 0) + 1
            op = per_rank[hi_r].get("op", "?")
            if worst is None or skew > worst["skew_us"]:
                worst = {"seq": seq, "op": op, "skew_us": round(skew, 1),
                         "late_rank": hi_r, "early_rank": lo_r}
        if n_skewed < self.min_seqs or not late_counts:
            return []
        straggler = max(late_counts, key=late_counts.get)
        return [self.finding(
            "launch_skew_straggler", "warn",
            f"launch-skew straggler: rank {straggler} launched last on "
            f"{late_counts[straggler]} of {n_skewed} skewed collectives "
            f"(worst: seq {worst['seq']} {worst['op']} "
            f"+{worst['skew_us'] / 1e3:.1f}ms)",
            evidence={"straggler_rank": straggler,
                      "skewed_seqs": n_skewed,
                      "late_counts": {str(k): v
                                      for k, v in late_counts.items()},
                      "worst": worst})]


class StragglerReplica(Detector):
    """Gray failure: a replica that is SLOW, not dead. Reads
    the router's per-replica progress gauges —
    ``fleet_replica_stall_seconds{replica=}`` (seconds since the last
    token any stream on that replica produced, 0 when idle),
    ``fleet_replica_inflight{replica=}``, and
    ``fleet_replica_progress_age_seconds{replica=}`` (seconds since
    the last token, busy or not) — and fires the ``slow_replica``
    CAUSE finding when one replica's stall is both above an absolute
    floor and a large multiple of its peers' demonstrated
    responsiveness, for ``streak`` consecutive windows. The relative
    rule is what separates a brownout from a uniformly-loaded fleet:
    every heartbeat keeps flowing during a brownout, so the
    death/suspect planes stay silent and this detector is the only one
    that can name the culprit.

    A peer's responsiveness is the MINIMUM of its progress age over
    the trailing ``peer_memory`` windows, not the instantaneous stall:
    the stall gauge sawtooths 0 -> step-wall between token batches, so
    a single sweep can catch a perfectly healthy peer mid-step (or
    mid-recompile) at a seconds-high reading and raise the relative
    bar beyond what any real brownout reaches. The trailing minimum
    asks the right question — "has this peer produced a token
    RECENTLY?" — and one slow step cannot fake the answer for a whole
    memory span. Because the age gauge keeps reporting while a peer
    is idle, a replica that burned through its queue and went idle
    remains a witness until its youngest age sample drifts past the
    memory horizon: a peer that just FINISHED its work fast is the
    strongest possible evidence the fleet is not uniformly slow. A
    replica that never produced anything publishes no age and can
    never vouch for the fleet."""

    name = "straggler_replica"
    sources = ("fleet_replica_stall_seconds", "fleet_replica_inflight",
               "fleet_replica_progress_age_seconds")

    def __init__(self, floor_s=1.0, rel_mult=4.0, peer_floor_s=0.05,
                 streak=2, peer_memory=6):
        self.floor_s = float(floor_s)
        self.rel_mult = float(rel_mult)
        self.peer_floor_s = float(peer_floor_s)
        self.streak = int(streak)
        self.peer_memory = int(peer_memory)
        self._streaks = {}
        self._hist = {}     # rep -> trailing progress-age samples

    def _rows(self, window):
        """{replica: {"stall": s, "inflight": n, "age": s}} off the
        cur edge."""
        rows = {}
        gauges = window._section(window.cur, "gauges")
        for key, v in gauges.items():
            base, labels = _parse_key(key)
            rep = labels.get("replica")
            if rep is None:
                continue
            if base == "fleet_replica_stall_seconds":
                rows.setdefault(rep, {})["stall"] = float(v)
            elif base == "fleet_replica_inflight":
                rows.setdefault(rep, {})["inflight"] = float(v)
            elif base == "fleet_replica_progress_age_seconds":
                rows.setdefault(rep, {})["age"] = float(v)
        return rows

    def observe(self, window):
        rows = self._rows(window)
        # roll the responsiveness history first: every replica with a
        # progress age contributes a sample (idle or busy — the gauge
        # only exists once a replica has produced something)
        for rep, row in rows.items():
            if "age" in row:
                h = self._hist.setdefault(rep, [])
                h.append(row["age"])
                del h[:-self.peer_memory]
        for rep in list(self._hist):
            if rep not in rows:
                del self._hist[rep]
        out = []
        suspects = set()
        for rep, row in rows.items():
            stall = row.get("stall", 0.0)
            if not row.get("inflight") or stall < self.floor_s:
                continue
            # judge against WITNESS peers only — replicas whose best
            # trailing progress age shows a recent token: a never-busy
            # peer has no age at all, and with no witness a slow fleet
            # is indistinguishable from a slow replica.
            peers = [min(h) for p, h in self._hist.items()
                     if p != rep and h]
            if not peers:
                continue
            peers.sort()
            med = peers[len(peers) // 2]
            bar = self.rel_mult * max(med, self.peer_floor_s)
            if stall < bar:
                continue
            suspects.add(rep)
            n = self._streaks.get(rep, 0) + 1
            self._streaks[rep] = n
            if n < self.streak:
                continue
            out.append(self.finding(
                "slow_replica", "critical",
                f"straggler replica {rep}: no token for {stall:.2f}s "
                f"with {row.get('inflight', 0):.0f} stream(s) in flight "
                f"(witness-peer responsiveness {med * 1e3:.0f}ms, "
                f"{n} consecutive windows) — alive but browned out; "
                "hedge/quarantine candidate",
                evidence={"replica": rep, "stall_s": round(stall, 3),
                          "inflight": row.get("inflight", 0),
                          "peer_responsiveness_s": round(med, 4),
                          "witnesses": len(peers), "streak": n}))
            # no re-arm: a standing brownout keeps firing every window
            # (the supervisor's quarantine streak counts CONSECUTIVE
            # slow_replica findings; a once-per-incident report would
            # starve it). The streak dict clears the moment the
            # replica makes progress again.
        for rep in list(self._streaks):
            if rep not in suspects:
                del self._streaks[rep]
        return out


class CollectiveRegression(Detector):
    """The sharding observatory's streaming half, two
    tripwires over one finding:

    - **replicated-param tripwire**: ``sharding_partition_violations``
      (the intent-vs-reality partition audit's gauge) ROSE — some
      parameter is laid out contrary to its declared ``param_spec``.
      A silently-replicated col-parallel weight costs N x HBM and N x
      all-gather bytes while computing the right answer, so nothing
      numeric ever catches it. Evidence names the params with their
      declared-vs-actual specs (from ``partition_violation`` events).
    - **collective-bytes jump**: the mesh engine's per-dispatch
      ``xla_collective_dispatch_bytes_total`` stream jumped
      window-over-window past a robust-EWMA baseline — a layout or
      partitioner change fattened the wire without touching latency
      floors yet.

    Both fire ``comm_regression`` (a CAUSE: the doctor correlates it
    under whatever latency/goodput symptom it produced)."""

    name = "collective_regression"
    sources = ("sharding_partition_violations", "partition_violation",
               "xla_collective_dispatch_bytes_total")

    def __init__(self, rel=1.0, k=6.0, warmup=3, floor_bytes=4096.0):
        self.rel = float(rel)
        self.k = float(k)
        self.floor = float(floor_bytes)
        self._ewma = RobustEwma(warmup=warmup)

    def observe(self, window):
        out = []
        cur = window.gauge("sharding_partition_violations") or 0
        prev = window.gauge("sharding_partition_violations",
                            edge="prev") or 0
        if cur > prev:
            named = [{"param": e.get("param"),
                      "declared": e.get("declared"),
                      "actual": e.get("actual")}
                     for e in window.events_of("partition_violation")][:6]
            head = named[0] if named else {}
            out.append(self.finding(
                "comm_regression", "warn",
                f"partition audit: {cur:.0f} param(s) placed contrary "
                "to their declared PartitionSpec"
                + (f" — {head.get('param')}: declared "
                   f"{head.get('declared')}, actual {head.get('actual')}"
                   if named else ""),
                evidence={"violations": cur, "params": named}))
        delta = window.counter_delta(
            "xla_collective_dispatch_bytes_total")
        jumped = self._ewma.exceeds(delta, rel=self.rel, k=self.k,
                                    floor=self.floor)
        baseline = self._ewma.mean
        self._ewma.update(delta)
        if jumped:
            out.append(self.finding(
                "comm_regression", "warn",
                f"collective bytes jumped: {delta:.0f}B dispatched this "
                f"window vs ~{baseline:.0f}B baseline — the wire got "
                "fatter without a layout declaration changing",
                evidence={"window_bytes": delta,
                          "baseline_bytes": round(baseline or 0.0, 1)}))
        return out


def default_detectors():
    """A fresh, independently-stateful detector set — one per doctor."""
    return [
        StepWallDrift(), LatencyDrift(), GoodputCollapse(),
        RecompileStorm(), KernelFallbackSpike(), QueueBuildup(),
        SloBreachStreak(), BadStepStreak(), ReplicaDeath(),
        SuspectReplica(), ReplicaDrain(), LaunchSkewStraggler(),
        StragglerReplica(), CollectiveRegression(),
    ]


# audit surface: {detector name: source instruments} — what
# tools/doctor_audit.py walks to catch detector->instrument rot
DEFAULT_DETECTORS = {cls.name: cls.sources for cls in (
    StepWallDrift, LatencyDrift, GoodputCollapse, RecompileStorm,
    KernelFallbackSpike, QueueBuildup, SloBreachStreak, BadStepStreak,
    ReplicaDeath, SuspectReplica, ReplicaDrain, LaunchSkewStraggler,
    StragglerReplica, CollectiveRegression)}
