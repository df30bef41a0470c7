"""Fleet autopilot: the closed loop from diagnosis to action.

The doctor turns the recording plane into machine-consumable
findings; the tracing layer measures SLO attainment; the KV transfer
plane moves sequences between replicas without recompute; the
resilient runtime has a restart budget. Nothing
consumed any of it — a dead replica stayed dead, a breached SLO stayed
breached. The ``Supervisor`` is the missing subsystem: it subscribes to
``Router.doctor_sweep()`` windows and the fleet's SLO-attainment
signals, and executes a BOUNDED, ACCOUNTED remediation policy through
the router's lifecycle verbs:

    doctor finding / window signal          supervisor action
    ─────────────────────────────────────   ─────────────────────────────
    replica_death (or router dead set)  ──► replace: re-spawn via
                                            ``spawn_fn`` under a
                                            jittered-exp-backoff
                                            RESTART BUDGET; exhaustion
                                            escalates (permanent-failure
                                            diagnosis) instead of
                                            respawn-looping
    suspect_replica streak              ──► quarantine: drain out of
                                            placement (in-flight hands
                                            off via the transfer
                                            plane), then PROBE it back
                                            in with the cheap ping verb
    slow_replica streak      ──► quarantine: same drain path
                                            for a GRAY failure — the
                                            replica heartbeats and
                                            pings fine but its tokens
                                            crawl; recovery waits for
                                            the straggler findings to
                                            stay quiet, not just the
                                            ping to answer
    sustained ttft/attainment breach    ──► scale_up: spawn a replica
                                            (hysteresis: a single
                                            breached window NEVER
                                            triggers; cooldown: one
                                            action per incident)
    sustained healthy + idle, size>target ► scale_down: prefix-affinity
                                            -aware drain() (the victim
                                            owning the FEWEST cached
                                            prefix chains; sequences
                                            transfer, never recompute
                                            while the source is alive),
                                            then remove once empty
    externally drained replica          ──► adopt: finish the drain
                                            (remove when empty); the
                                            below-target rule restores
                                            fleet size

Flap prevention is structural, not tuned: every scale signal must
persist for ``*_streak`` windows before it may act (hysteresis — one
breached window is a tail event by definition; the breach streak holds
through up to ``breach_clear_windows - 1`` healthy windows between
breaches, because a trickle of SLO misses whose completions straddle
window edges is still ONE standing incident, and only that many
consecutive clean windows prove it over), every executed scale action
opens a ``cooldown_s`` window during which further scale decisions are
suppressed (so an oscillating signal yields one action per incident,
not one per window), and the restart budget bounds how often a
crashing replica may be revived (decaying while it stays
healthy). A clean fleet therefore produces ZERO actions — the chaos
campaign's no-flap assert.

Accounting: every DECISION increments
``supervisor_intents_total{action=,reason=}`` and every EXECUTED action
increments ``supervisor_actions_total{action=,reason=}`` plus records a
traced ``supervisor_action`` event (its own trace id + a span over the
execution). ``dry_run=True`` records every intent and advances the
policy state machine identically but executes nothing — intents equal,
actions zero, the parity the tests assert. The router's request
accounting identity (offered == completed + shed + failed) is untouched
by construction: the supervisor only ever calls verbs (spawn / drain /
remove / undrain) that reroute or re-place admitted requests, never
verbs that drop them.

``tools/fault_drill.py --campaign`` drives randomized multi-fault
schedules against a supervised fleet and asserts the loop closes:
every injected fault gets its named diagnosis AND its named
remediation, with zero failed requests and post-campaign convergence.
``tools/supervisor_audit.py`` is the tier-1 rot guard over the
finding → decision → router action → traced event chain.
"""

from __future__ import annotations

import random
import threading
import time

from ..observability.metrics import REGISTRY as _REG
from ..observability.events import EVENTS as _EVENTS
from ..observability import tracing as _TR

__all__ = ["Supervisor", "SupervisorPolicy"]

# findings the supervisor reads as "the fleet is breaching its latency
# contract" — the scale-up signal (alongside window attainment)
BREACH_FINDINGS = frozenset({
    "slo_breach_streak", "ttft_p95_regression", "tpot_p95_regression",
    "e2e_p95_regression", "queue_buildup", "goodput_collapse",
})


def _intent_counter(action, reason):
    return _REG.counter(
        "supervisor_intents_total",
        "supervisor DECISIONS (dry-run included) — intents equal "
        "actions on a live supervisor, actions stay 0 in dry-run",
        labels={"action": str(action), "reason": str(reason)})


def _action_counter(action, reason):
    return _REG.counter(
        "supervisor_actions_total",
        "supervisor remediation actions EXECUTED against the fleet",
        labels={"action": str(action), "reason": str(reason)})


class _Backoff:
    """Jittered exponential backoff:
    min(cap, base*2^n) * (1 + U[0, jitter]) — the jitter decorrelates a
    storm of replicas all dying at once so their respawns don't land as
    one thundering herd."""

    def __init__(self, base=0.5, cap=30.0, jitter=0.5, seed=None):
        self.base, self.cap, self.jitter = base, cap, jitter
        self.n = 0
        self._rng = random.Random(seed)

    def next_delay(self):
        d = min(self.cap, self.base * (2 ** self.n))
        self.n += 1
        return d * (1.0 + self._rng.uniform(0.0, self.jitter))

    def reset(self):
        self.n = 0


class _RestartState:
    """Per-replica restart budget: attempts consumed, next time a
    respawn is allowed, and the permanent-failure latch."""

    def __init__(self, backoff):
        self.attempts = 0
        self.backoff = backoff
        self.next_ok = 0.0          # earliest clock a respawn may fire
        self.last_attempt = None
        self.failed_permanently = False
        self.escalated = False


class SupervisorPolicy:
    """The autopilot's knobs. Defaults are tuned for sub-second doctor
    windows on the CPU drill fleets; production fleets scale the
    streaks/cooldowns with their sweep interval."""

    def __init__(self, target_replicas=None, min_replicas=1,
                 max_replicas=8,
                 scale_up_streak=2, scale_down_streak=4,
                 breach_clear_windows=2,
                 cooldown_s=10.0, attainment_target=0.9,
                 idle_inflight_per_replica=0.5,
                 quarantine_streak=2,
                 max_restarts=3, restart_decay_s=30.0,
                 backoff_base=0.5, backoff_cap=30.0, backoff_jitter=0.5,
                 backoff_seed=None, adopt_external_drains=True):
        self.target_replicas = target_replicas   # None: frozen to the
        #                                          fleet size at attach
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.scale_up_streak = int(scale_up_streak)
        self.scale_down_streak = int(scale_down_streak)
        self.breach_clear_windows = int(breach_clear_windows)
        self.cooldown_s = float(cooldown_s)
        self.attainment_target = float(attainment_target)
        self.idle_inflight_per_replica = float(idle_inflight_per_replica)
        self.quarantine_streak = int(quarantine_streak)
        self.max_restarts = int(max_restarts)
        self.restart_decay_s = float(restart_decay_s)
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self.backoff_jitter = float(backoff_jitter)
        self.backoff_seed = backoff_seed
        self.adopt_external_drains = bool(adopt_external_drains)


class Supervisor:
    """See the module docstring. One instance per router; ``tick()``
    runs one observe→decide→act cycle, ``start(interval)`` runs it on a
    daemon thread. ``clock`` is injectable so cooldown/backoff tests
    run on a fake clock."""

    def __init__(self, router, spawn_fn=None, policy=None, dry_run=False,
                 expected=(), clock=time.monotonic):
        self.router = router
        self.spawn_fn = spawn_fn    # name -> replica handle; None makes
        #                             spawn-shaped actions intent-only
        self.policy = policy or SupervisorPolicy()
        self.dry_run = bool(dry_run)
        self.expected = tuple(expected)
        self._clock = clock
        self._lock = threading.Lock()
        if self.policy.target_replicas is None:
            # resolve the frozen-at-attach default on a COPY: a caller
            # sharing one policy object across supervisors must not
            # have the first fleet's size leak into the second's target
            import copy
            self.policy = copy.copy(self.policy)
            self.policy.target_replicas = max(
                self.policy.min_replicas,
                len(router.usable_replicas()))
        self._restart = {}          # name -> _RestartState
        self._suspect_streak = {}
        self._slow_streak = {}      # name -> consecutive slow_replica
        #                             findings (gray-failure quarantine)
        self._slow_last_seen = {}   # name -> tick of the latest
        #                             slow_replica finding: probe_recover
        #                             must outwait this, not just the
        #                             suspicion set — a browned-out
        #                             replica pings fine
        self._breach_streak = 0
        self._breach_gap = 0
        self._breach_named_by_doctor = False
        self._healthy_streak = 0
        self._cooldown_until = 0.0
        self._quarantined = set()
        self._pending_removal = {}  # name -> reason (draining toward
        #                             removal: scale_down / external)
        self._spawn_seq = 0
        self._prev_counters = None  # previous window's merged counters
        #                             (window attainment needs deltas —
        #                             the lifetime attainment gauge
        #                             dilutes a fresh breach away)
        self.ticks = 0
        # bounded drop-oldest, like every other long-running store in
        # the fleet plane: a daemon supervisor through a flappy month
        # must not grow memory per window
        from collections import deque
        self.decisions_log = deque(maxlen=4096)
        #                           # (tick, action, target, reason)
        self.executed_log = deque(maxlen=4096)
        #                           # decisions that actually LANDED on
        #                           # the fleet (not dry-run, no
        #                           # _execute error) — what the chaos
        #                           # campaign grades remediation
        #                           # against: an intent whose spawn
        #                           # failed is not a remediation
        self.findings_log = deque(maxlen=4096)   # (tick, finding name)
        self._g_quar = _REG.gauge(
            "supervisor_replicas_quarantined",
            "replicas the supervisor drained out of placement on a "
            "suspicion streak (probing them back in)")
        self._g_perm = _REG.gauge(
            "supervisor_permanent_failures",
            "replicas whose restart budget is exhausted (escalated, "
            "no longer respawned)")
        self._g_breach = _REG.gauge(
            "supervisor_breach_streak",
            "consecutive breached windows observed (scale-up fires at "
            "the policy streak)")
        _REG.gauge(
            "supervisor_fleet_target",
            "the fleet size the autopilot converges back to"
        ).set(self.policy.target_replicas)
        self._stop = threading.Event()
        self._thread = None

    # -- observe ----------------------------------------------------------
    def _window_attainment(self, snapshot):
        """Per-metric WINDOW attainment from the merged slo counters:
        diff this sweep's checks/violations against the previous
        sweep's. Returns {metric_key: attainment} for keys graded this
        window (empty first window)."""
        counters = (snapshot or {}).get("counters") or {}
        prev = self._prev_counters or {}
        out = {}
        for key, checks in counters.items():
            if not key.startswith("slo_checks_total"):
                continue
            d_checks = checks - prev.get(key, 0)
            if d_checks <= 0:
                continue
            vkey = key.replace("slo_checks_total",
                               "slo_violations_total", 1)
            d_viol = counters.get(vkey, 0) - prev.get(vkey, 0)
            out[key[len("slo_checks_total"):].strip("{}") or "all"] = \
                1.0 - d_viol / d_checks
        self._prev_counters = dict(counters)
        return out

    def _breached(self, findings, attainment):
        """The scale-up signal for ONE window. Returns (breached,
        doctor_saw_it): a breach-shaped doctor finding fired, or any
        ttft-family window attainment sits below target — the second
        bool records whether the DOCTOR already named the breach (when
        only the attainment counters saw it, the supervisor files the
        diagnosis itself at trigger time, so every remediation is
        preceded by a named finding)."""
        doc = any(f.get("finding") in BREACH_FINDINGS for f in findings)
        att = any(a < self.policy.attainment_target
                  for key, a in attainment.items()
                  if "ttft" in key)
        return (doc or att), doc

    # -- decide -----------------------------------------------------------
    def _decide(self, findings, snapshot, now):
        """The policy state machine: pure against (findings, snapshot,
        router membership, clock) plus its own streak/cooldown state —
        dry-run and live supervisors fed the same observations make
        the SAME decisions. Returns [{action, target, reason, ...}]."""
        p = self.policy
        r = self.router
        decisions = []

        dead = set(r.dead_replicas())
        # NOTE: replica_death FINDINGS are deliberately not a death
        # source here — a finding names the incarnation that died in
        # ITS window, and by the time it surfaces the name may already
        # carry a live successor (the doctor sweeps one window behind
        # the replace). The router's verdict set plus the direct
        # liveness probe below cover every real death without being
        # able to re-kill a replacement.
        # direct liveness observation (a PID check, fleet-manager
        # style): a replica whose process/flag is gone is DEAD for the
        # replace queue even before any stream trips over it — without
        # this, the first tick after a quiet-period kill sees a fleet
        # below target with no owner for the deficit and spawns a
        # FRESH name, then replaces the dead one too when the data
        # plane finally notices (two spawns + a scale-down for one
        # death: flap). The verdict is filed THROUGH the router
        # (mark_dead) so the doctor — the one diagnosis authority —
        # names the death off the same fleet_replica_dead event every
        # other observer produces; dry-run observes without filing.
        registered = r.registered_replicas()
        for name, h in registered.items():
            if name in dead:
                continue
            try:
                alive = h.alive()
            except Exception:  # noqa: BLE001 — unobservable IS dead
                alive = False
            if not alive:
                dead.add(name)
                if not self.dry_run:
                    try:
                        r.mark_dead(name, "supervisor liveness probe: "
                                          "handle reports not alive")
                    except Exception:  # noqa: BLE001
                        pass
        # 1) replace dead replicas under the restart budget
        pending_replace = set()     # dead names still owed a respawn
        #                             (counted so the below-target rule
        #                             never double-spawns around a
        #                             replace that is merely backing
        #                             off)
        for name in sorted(dead):
            if name in self._pending_removal:
                # a drained victim that dies was LEAVING anyway: step 3
                # retires its registration (died_while_draining) and
                # the below-target rule restores size if the fleet is
                # actually short — replacing it here would spawn a
                # fresh replica only to remove it in the same tick
                continue
            st = self._restart.get(name)
            if st is None:
                st = self._restart[name] = _RestartState(_Backoff(
                    p.backoff_base, p.backoff_cap, p.backoff_jitter,
                    seed=p.backoff_seed))
            if st.failed_permanently:
                # retire the permanently-failed registration once its
                # in-flight reroutes settled; the below-target rule then
                # restores capacity under a FRESH name (a budget spent
                # on one incarnation says nothing about a new one on a
                # different box/process)
                if name in registered and r.inflight_of(name) == 0 \
                        and len(r.usable_replicas()) > 0:
                    decisions.append({"action": "remove", "target": name,
                                      "reason": "permanent_failure"})
                continue
            pending_replace.add(name)
            if st.attempts > 0 and st.last_attempt is not None \
                    and now - st.last_attempt >= p.restart_decay_s:
                # the budget decays while the replica stays up — only a
                # replica that keeps crashing exhausts it
                st.attempts -= 1
                st.last_attempt = now
                st.backoff.n = max(0, st.backoff.n - 1)
            if st.attempts >= p.max_restarts:
                st.failed_permanently = True
                decisions.append({
                    "action": "escalate", "target": name,
                    "reason": "restart_budget_exhausted",
                    "attempts": st.attempts})
                continue
            if now < st.next_ok:
                continue            # backoff window still open
            st.attempts += 1
            st.last_attempt = now
            st.next_ok = now + st.backoff.next_delay()
            decisions.append({"action": "replace", "target": name,
                              "reason": "replica_death",
                              "attempt": st.attempts})

        # 2) quarantine suspects on a streak; probe quarantined back in
        suspects = set(r.suspected_replicas())
        for name in list(self._suspect_streak):
            if name not in suspects:
                del self._suspect_streak[name]
        for name in suspects:
            if name in dead or name in self._quarantined:
                continue
            n = self._suspect_streak.get(name, 0) + 1
            self._suspect_streak[name] = n
            if n >= p.quarantine_streak:
                decisions.append({"action": "quarantine", "target": name,
                                  "reason": "suspect_streak",
                                  "windows": n})
        # 2b) quarantine STRAGGLERS the doctor named (slow_replica,
        # a gray failure — heartbeats flow, pings answer,
        # tokens crawl — so the suspicion set above never sees it. The
        # detector fires every window the brownout stands; the same
        # quarantine_streak debounces here.
        slow = {f.get("evidence", {}).get("replica")
                for f in findings if f.get("finding") == "slow_replica"}
        slow.discard(None)
        for name in list(self._slow_streak):
            if name not in slow:
                del self._slow_streak[name]
        for name in sorted(slow):
            self._slow_last_seen[name] = self.ticks
            if name in dead or name in self._quarantined:
                continue
            n = self._slow_streak.get(name, 0) + 1
            self._slow_streak[name] = n
            if n >= p.quarantine_streak:
                decisions.append({"action": "quarantine", "target": name,
                                  "reason": "slow_replica",
                                  "windows": n})
        for name in sorted(self._quarantined):
            if name in dead or name not in registered:
                self._quarantined.discard(name)   # replace path owns it
                continue
            # a drained straggler reads 0 stall (nothing in flight), so
            # the finding going quiet proves nothing: hold the
            # quarantine until the straggler has ALSO been silent for a
            # full streak of windows — without this, probe_recover
            # re-admits the still-browned-out replica one tick after
            # the drain empties it and the fleet flaps
            recently_slow = (self.ticks - self._slow_last_seen.get(
                name, -(1 << 30))) <= p.quarantine_streak
            if name not in suspects and not recently_slow:
                decisions.append({"action": "probe_recover",
                                  "target": name,
                                  "reason": "suspicion_cleared"})

        # 3) adopt externally drained replicas (finish their removal)
        if p.adopt_external_drains:
            for name in r.draining_replicas():
                if name in self._pending_removal \
                        or name in self._quarantined or name in dead:
                    continue
                self._pending_removal[name] = "external_drain"
                decisions.append({"action": "adopt_drain",
                                  "target": name,
                                  "reason": "external_drain"})
        # ...and remove any pending victim whose drain completed
        for name, reason in sorted(self._pending_removal.items()):
            if name not in registered:
                del self._pending_removal[name]
                continue
            if name in dead:
                # the drain lost the race to a death; failover already
                # moved the sequences — just retire the registration
                decisions.append({"action": "remove", "target": name,
                                  "reason": "died_while_draining"})
            elif r.inflight_of(name) == 0:
                decisions.append({"action": "remove", "target": name,
                                  "reason": reason})

        # 4) scaling, with hysteresis + cooldown
        usable = r.usable_replicas()
        size = len(usable)
        attainment = self._window_attainment(snapshot)
        breached, doc_saw_breach = self._breached(findings, attainment)
        if breached:
            self._breach_streak += 1
            self._breach_gap = 0
            self._healthy_streak = 0
            if doc_saw_breach:
                self._breach_named_by_doctor = True
        else:
            # the streak HOLDS through short gaps: SLO misses graded at
            # completion straddle window edges, and a trickle of them
            # is one standing incident, not many. Only
            # breach_clear_windows consecutive clean windows clear it.
            self._breach_gap = getattr(self, "_breach_gap", 0) + 1
            if self._breach_gap >= p.breach_clear_windows:
                self._breach_streak = 0
                self._breach_named_by_doctor = False
        self._g_breach.set(self._breach_streak)
        in_flight = sum(r.inflight_of(n) for n in usable) \
            / max(size, 1)
        idle = in_flight <= p.idle_inflight_per_replica
        healthy = (not breached and self._breach_streak == 0
                   and not dead and not suspects
                   and not self._quarantined)
        self._healthy_streak = self._healthy_streak + 1 \
            if (healthy and idle) else 0
        cooled = now >= self._cooldown_until
        effective_target = p.target_replicas
        if size < effective_target and cooled and self.spawn_fn \
                and not pending_replace:
            # structural deficit (a drained replica was removed, or a
            # permanent failure shrank the fleet): restore target size.
            # Not gated on a breach streak — the deficit is a fact, not
            # a noisy signal — but still under the cooldown so one
            # deficit yields one spawn per window of opportunity.
            decisions.append({"action": "spawn",
                              "target": self._next_name(),
                              "reason": "below_target",
                              "size": size,
                              "target_size": effective_target})
        elif breached and self._breach_streak >= p.scale_up_streak \
                and cooled and size < p.max_replicas:
            if not self._breach_named_by_doctor:
                # the breach was observed on the attainment COUNTERS
                # alone (the doctor's streak rules can miss a trickle
                # of completion-graded SLO misses): the supervisor is
                # the observer, so it files the named diagnosis itself
                # — every remediation is preceded by a finding, never
                # by an unexplained action
                self.findings_log.append((self.ticks,
                                          "slo_breach_streak"))
                _EVENTS.record(
                    "diagnosis", doctor="supervisor",
                    finding="slo_breach_streak", detector="supervisor",
                    severity="warn",
                    summary=f"ttft window attainment below "
                            f"{p.attainment_target:.0%} across "
                            f"{self._breach_streak} breached windows "
                            "(supervisor attainment observer)",
                    evidence={"attainment": {k: round(v, 4)
                                             for k, v in
                                             attainment.items()},
                              "streak": self._breach_streak},
                    traces=[], expected=False)
            decisions.append({"action": "scale_up",
                              "target": self._next_name(),
                              "reason": "slo_breach_streak",
                              "streak": self._breach_streak,
                              "size": size})
        elif self._healthy_streak >= p.scale_down_streak and cooled \
                and size > max(effective_target, p.min_replicas) \
                and not self._pending_removal:
            victim = self._scale_down_victim(usable)
            if victim is not None:
                decisions.append({"action": "scale_down",
                                  "target": victim,
                                  "reason": "sustained_idle",
                                  "healthy_windows":
                                      self._healthy_streak})
        return decisions

    def _next_name(self):
        self._spawn_seq += 1
        return f"s{self._spawn_seq}"

    def _scale_down_victim(self, usable):
        """Prefix-affinity-aware victim choice: drain the replica whose
        removal forfeits the LEAST cached-prefix investment (fewest
        owned chains in the router's affinity map; in-flight count
        breaks ties). Never a quarantined or draining replica — those
        are already leaving placement for their own reasons — and, in
        a role-split fleet, never the last replica of its role: the
        router's remove() would refuse it forever and the drained
        victim would wedge pending_removal."""
        r = self.router
        counts = r.affinity_counts()
        draining = set(r.draining_replicas())
        cands = [n for n in usable
                 if n not in self._quarantined and n not in draining]
        roles, role_split = r.fleet_roles()
        if role_split:
            cands = [n for n in cands
                     if roles.get(n) is None
                     or sum(1 for m in cands
                            if roles.get(m) == roles.get(n)) > 1]
        if len(cands) <= 1:
            return None
        return min(cands, key=lambda n: (counts.get(n, 0),
                                         r.inflight_of(n), n))

    # -- act --------------------------------------------------------------
    def _execute(self, d, now):
        """Run one decision against the router. Returns an error string
        (None on success); failures are recorded, never raised — a
        failed remediation must not kill the loop that would retry it."""
        r = self.router
        action, target = d["action"], d.get("target")
        try:
            if action in ("replace", "spawn", "scale_up"):
                if self.spawn_fn is None:
                    return "no spawn_fn configured (intent only)"
                handle = self.spawn_fn(target)
                r.spawn(target, handle)
                if action in ("spawn", "scale_up"):
                    self._cooldown_until = now + self.policy.cooldown_s
                    self._healthy_streak = 0
                    if action == "scale_up":
                        # only a DELIBERATE breach response clears the
                        # streak — a below-target restore is a deficit
                        # fix, and a breach standing through it must
                        # still be answerable once the cooldown opens
                        self._breach_streak = 0
            elif action == "quarantine":
                r.drain(target)
                self._quarantined.add(target)
                self._suspect_streak.pop(target, None)
                self._slow_streak.pop(target, None)
            elif action == "probe_recover":
                # prove the replica answers before re-admitting it to
                # placement: suspicion cleared + a live ping
                handle = r.handle_of(target)
                probe = getattr(handle, "ping", None) \
                    or getattr(handle, "metrics")
                probe()
                r.undrain(target)
                self._quarantined.discard(target)
            elif action == "adopt_drain":
                pass                # bookkeeping only (decided above)
            elif action == "scale_down":
                r.drain(target)
                self._pending_removal[target] = "scale_down"
                self._cooldown_until = now + self.policy.cooldown_s
                self._healthy_streak = 0
            elif action == "remove":
                try:
                    handle = r.remove(target)
                except ValueError as e:
                    # the router refuses removals that would leave the
                    # fleet (or a role) unservable — the fleet changed
                    # around this victim since it was drained. Put it
                    # BACK instead of retrying the refusal forever (a
                    # wedged pending_removal blocks every future
                    # scale-down and the convergence check)
                    self._pending_removal.pop(target, None)
                    self._quarantined.discard(target)
                    if target in r.draining_replicas():
                        r.undrain(target)
                    return f"refused, victim restored: {e}"
                self._pending_removal.pop(target, None)
                self._quarantined.discard(target)
                try:
                    handle.shutdown()
                except Exception:  # noqa: BLE001 — already out of the
                    pass           # fleet; a noisy shutdown is cosmetic
            elif action == "escalate":
                # the budget is spent: stop respawning, file a
                # permanent-failure diagnosis so operators (and the
                # doctor pane) see an ESCALATION, not silence
                self._g_perm.set(sum(
                    1 for s in self._restart.values()
                    if s.failed_permanently))
                _REG.gauge(
                    "doctor_findings",
                    "active doctor findings (1 while firing, 0 cleared)",
                    labels={"finding": "replica_permanent_failure",
                            "doctor": "supervisor"}).set(1)
                _EVENTS.record(
                    "diagnosis", doctor="supervisor",
                    finding="replica_permanent_failure",
                    detector="supervisor", severity="critical",
                    summary=f"replica {target} exhausted its restart "
                            f"budget ({d.get('attempts')} attempts) — "
                            "declared permanently failed, escalating "
                            "instead of respawn-looping",
                    evidence={"replica": target,
                              "attempts": d.get("attempts")},
                    traces=[], expected=False)
            else:
                return f"unknown action {action!r}"
        except Exception as e:  # noqa: BLE001
            return f"{type(e).__name__}: {str(e)[:160]}"
        return None

    # -- the loop ---------------------------------------------------------
    def tick(self):
        """One observe→decide→act cycle. Returns the decision list
        (executed or intent-only per ``dry_run``)."""
        with self._lock:
            now = self._clock()
            findings = self.router.doctor_sweep(expected=self.expected)
            all_findings = list(findings) + list(
                getattr(self.router.doctor, "last_expected", []))
            snapshot = self.router.last_fleet_snapshot
            self.ticks += 1
            for f in all_findings:
                self.findings_log.append((self.ticks, f.get("finding")))
            decisions = self._decide(all_findings, snapshot, now)
            for d in decisions:
                _intent_counter(d["action"], d["reason"]).inc()
                self.decisions_log.append(
                    (self.ticks, d["action"], d.get("target"),
                     d["reason"]))
                err = None
                t0 = time.perf_counter()
                trace = _TR.new_trace_id()
                if self.dry_run:
                    # dry run: the state machine advanced in _decide,
                    # the intent is on the books — nothing touches the
                    # fleet. Cooldowns still arm so a dry supervisor
                    # makes the same one-action-per-incident decisions
                    # a live one would.
                    if d["action"] in ("spawn", "scale_up",
                                       "scale_down"):
                        self._cooldown_until = \
                            now + self.policy.cooldown_s
                        self._healthy_streak = 0
                        if d["action"] == "scale_up":
                            self._breach_streak = 0
                    if d["action"] == "quarantine":
                        self._quarantined.add(d["target"])
                        self._suspect_streak.pop(d["target"], None)
                        self._slow_streak.pop(d["target"], None)
                    if d["action"] == "probe_recover":
                        self._quarantined.discard(d["target"])
                else:
                    err = self._execute(d, now)
                    if err is None:
                        _action_counter(d["action"], d["reason"]).inc()
                        self.executed_log.append(
                            (self.ticks, d["action"], d.get("target"),
                             d["reason"]))
                        _TR.record_span(
                            "supervisor_action", t0, trace=trace,
                            action=d["action"], target=d.get("target"))
                d["error"] = err
                d["dry_run"] = self.dry_run
                _EVENTS.record(
                    "supervisor_action", trace=trace,
                    action=d["action"], target=d.get("target"),
                    reason=d["reason"], dry_run=self.dry_run,
                    error=err,
                    fleet_size=len(self.router.usable_replicas()))
            self._g_quar.set(len(self._quarantined))
            return decisions

    def start(self, interval=2.0):
        """Periodic ticks on a daemon thread. Idempotent."""
        if self._thread is not None:
            return self
        try:
            self.tick()              # baseline sweep (doctor window 0)
        except Exception as e:  # noqa: BLE001 — same contract as the
            # loop below: a bad first window must not kill the autopilot
            _EVENTS.record(
                "supervisor_tick_error",
                error=f"{type(e).__name__}: {str(e)[:160]}")

        def loop():
            while not self._stop.wait(interval):
                try:
                    self.tick()
                except Exception as e:  # noqa: BLE001 — the autopilot
                    # must outlive a bad window; surface, keep ticking
                    _EVENTS.record(
                        "supervisor_tick_error",
                        error=f"{type(e).__name__}: {str(e)[:160]}")
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="fleet-supervisor")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None

    # -- reporting --------------------------------------------------------
    def report(self):
        """JSON-able autopilot state: what it did and what it is
        watching."""
        actions = {}
        for _, action, _, reason in self.decisions_log:
            actions[f"{action}:{reason}"] = \
                actions.get(f"{action}:{reason}", 0) + 1
        return {
            "ticks": self.ticks,
            "dry_run": self.dry_run,
            "target_replicas": self.policy.target_replicas,
            "fleet_size": len(self.router.usable_replicas()),
            "quarantined": sorted(self._quarantined),
            "pending_removal": dict(self._pending_removal),
            "permanent_failures": sorted(
                n for n, s in self._restart.items()
                if s.failed_permanently),
            "breach_streak": self._breach_streak,
            "decisions": actions,
        }
