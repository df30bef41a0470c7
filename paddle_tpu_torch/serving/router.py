"""Fleet router — least-load admission, prefix-affinity placement, and
preemption-safe sequence failover over a group of replicas.

The router is the only component that owns a request end to end. Each
request's durable state is the router-side journal: the prompt, every
token DELIVERED to the consumer, and the remaining budget — exactly the
``GenerationEngine.export_request`` schema, rebuilt on every placement.
That makes replica death survivable by construction:

    submit ──place──► replica A ──(cursor,token)*──► consumer
                │ A dies (ReplicaDeadError / socket reset / heartbeat
                │ staleness for queued work)
                └─re-place──► replica B, snapshot = prompt + delivered,
                              start = len(delivered)

- **zero failed requests**: a sequence only fails when NO replica is
  live (NoLiveReplicaError) or when the request itself is unservable
  (the engine rejected it, e.g. over max_seq_len — rerouting would
  recur on every peer); both paths are counted in
  fleet_requests_failed_total before raising, so the zero-failed gauge
  never lies. Any survivor re-prefills the snapshot (through its prefix
  cache when the pages are resident) and continues.
- **exactly-once delivery**: tokens are indexed by the virtual-sequence
  cursor. The resumed stream starts at ``len(delivered)``, and a
  defensive cursor check suppresses any duplicate a misbehaving replica
  could emit (``fleet_dup_tokens_suppressed_total`` should stay 0).
- **greedy parity**: the snapshot conditions the peer on exactly the
  tokens the consumer saw; greedy decode is deterministic, so the
  rerouted continuation is the one the dead replica would have
  produced.

Placement: the longest chain of the prompt's full-page prefix hashes
(``engine.prefix_chain_hashes`` — the BlockManager index's own hash
chain) is looked up in a bounded router-side owner map; a live owner
wins (its prefix cache holds those pages), otherwise the live replica
with the fewest in-flight sequences. Health is TWO-TIERED:

- **hard dead** (stream raised / process exited): final; every journaled
  sequence re-places immediately.
- **suspect** (heartbeat value stale on the store — judged by value
  change with local receipt times, clock-skew free, the ElasticManager
  rule): avoided for NEW placement, lifted when the beat resumes, and
  still usable as a last resort — a replica GIL-bound in a long compile
  stalls its beat thread without being dead, and "everything looks
  stale" must degrade placement, never fail a request. Active streams
  are untouched either way: tokens flowing is the stronger liveness
  signal, so a heartbeat blackout (store wedge, dropped beats) never
  kills a healthy stream spuriously.

Overload is a CONTRACT, not an accident. With
``admission_budget`` set, the router bounds its fleet-wide in-flight
request count: an admission that would exceed it is SHED — a
``RequestShedError`` the caller sees immediately instead of an
unbounded queue silently inflating every tenant's tail. Shedding is
*accounted*: ``fleet_requests_shed_total{reason=,tenant=}`` counts it,
a traced ``shed`` event records the queue depth and budget at decision
time, and the books close exactly —

    offered == completed + shed + failed (+ abandoned + in flight)

per ``fleet_accounting()``, the identity the load harness
(tools/loadgen.py) asserts at every load point. Rerouted sequences are
NOT re-admissions: a request the fleet accepted is never shed mid-life
by a replica death — the budget gates the front door only.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

from ..inference.engine import (make_sequence_snapshot,
                                prefix_chain_hashes,
                                DeadlineExceededError,
                                RequestCancelledError)
from ..observability.metrics import REGISTRY as _REG
from ..observability.events import EVENTS as _EVENTS
from ..observability import tracing as _TR
from .replica import ReplicaDeadError, HB_KEY_PREFIX

__all__ = ["Router", "NoLiveReplicaError", "RequestShedError",
           "HedgePolicy"]

_C_REQS = _REG.counter("fleet_requests_total",
                       "requests submitted to the router")
_C_DONE = _REG.counter("fleet_requests_completed_total",
                       "requests that delivered their full sequence")
_C_FAILED = _REG.counter(
    "fleet_requests_failed_total",
    "requests that FAILED (no live replica left) — the drill gate "
    "asserts this stays 0")
_C_REROUTED = _REG.counter("fleet_requests_rerouted_total",
                           "sequence re-placements after a replica death")
_C_FAILOVERS = _REG.counter("fleet_failovers_total",
                            "replica death events observed by the router")
_C_TOKENS = _REG.counter("fleet_tokens_delivered_total",
                         "tokens delivered to consumers")
_C_DUP = _REG.counter(
    "fleet_dup_tokens_suppressed_total",
    "duplicate-cursor tokens suppressed (exactly-once guard; 0 in a "
    "healthy fleet)")
_C_AFFINITY = _REG.counter(
    "fleet_prefix_affinity_hits_total",
    "placements routed to the replica owning the prompt's cached prefix")
_C_ABANDONED = _REG.counter(
    "fleet_requests_abandoned_total",
    "streams the CONSUMER closed early (its own timeout/disconnect) — "
    "requests the latency sketches cannot honestly observe, counted so "
    "the tail they belong to stays visible")
_C_SUSPECT = _REG.counter(
    "fleet_replicas_suspected_total",
    "stale-heartbeat suspicions (placement avoidance, NOT death)")
# gray-failure defense: deadlines, cancellation, hedging.
# deadline_exceeded and cancelled are their OWN accounting buckets —
# neither a shed (never admitted) nor a failure (infrastructure broke);
# the fleet_accounting() identity gains both terms.
_C_DEADLINE_X = _REG.counter(
    "fleet_requests_deadline_exceeded_total",
    "admitted requests that blew their end-to-end deadline_ms and were "
    "expired at an engine step boundary (accounted outcome, not a "
    "failure)")
_C_CANCELLED = _REG.counter(
    "fleet_requests_cancelled_total",
    "admitted requests torn down by an explicit cancel verb before "
    "their token budget (accounted outcome, not a failure)")
_C_CANCELS_SENT = _REG.counter(
    "fleet_cancels_sent_total",
    "cancel verbs the router sent to replicas (abandoned consumers, "
    "hedge losers) — each frees engine slot+pages within one step")
_C_HEDGES = _REG.counter(
    "fleet_hedges_fired_total",
    "progress-watchdog hedges: journal-replay re-placements raced "
    "against a slow-but-alive primary")
_C_HEDGE_WINS = _REG.counter(
    "fleet_hedge_wins_total",
    "hedges that delivered the next token before the primary did "
    "(the primary was cancelled as the loser)")
_C_HEDGE_DUP = _REG.counter(
    "fleet_hedge_dup_tokens_suppressed_total",
    "duplicate-cursor tokens suppressed INSIDE the hedge race (the "
    "loser kept emitting briefly) — hedging's own dedup, separate "
    "from fleet_dup_tokens_suppressed_total which must stay 0")
# disaggregated serving: KV pages on the wire
_C_KV_TRANSFERS = _REG.counter(
    "fleet_kv_transfers_total",
    "KV page batches moved between replicas (handoff/drain)")
_C_KV_PAGES = _REG.counter(
    "fleet_kv_transfer_pages_total",
    "KV pages mapped on a destination replica via transfer "
    "(prefill work moved as bytes, not recomputed)")
_C_KV_BYTES = _REG.counter(
    "fleet_kv_transfer_bytes_total",
    "serialized KV bytes shipped across the transfer plane")
_C_KV_FALLBACK = _REG.counter(
    "fleet_kv_transfer_fallbacks_total",
    "transfers that degraded to plain re-prefill (source died "
    "mid-export, import refused, wire error) — correctness is "
    "unaffected, the bytes just did not move")
_C_HANDOFF = _REG.counter(
    "fleet_prefill_handoffs_total",
    "role-split requests handed from a prefill replica to a decode "
    "replica after their first token")
_C_DRAIN_X = _REG.counter(
    "fleet_drain_exports_total",
    "sequences exported (state + KV) off a draining replica")
# fleet lifecycle verbs: the supervisor (and operators)
# grow/shrink the fleet without restarting the router
_C_SPAWNED = _REG.counter(
    "fleet_replicas_spawned_total",
    "replicas registered at runtime (spawn verb: autoscale-up, "
    "dead-replica replacement)")
_C_REMOVED = _REG.counter(
    "fleet_replicas_removed_total",
    "replicas deregistered at runtime (remove verb: autoscale-down, "
    "permanent-failure retirement)")
_G_DRAINING = _REG.gauge("fleet_replicas_draining",
                         "replicas currently draining")
_G_LIVE = _REG.gauge("fleet_replicas_live", "live replicas")
_H_FAILOVER = _REG.histogram(
    "fleet_failover_recovery_seconds",
    "replica death detected -> first rerouted token delivered",
    buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0))


def _shed_counter(reason, tenant):
    """The accounted-shedding counter series (created on demand per
    (reason, tenant) labelset). Tenant-less sheds label tenant="" so
    the series family stays one name; tenants past the bounded
    per-tenant series population fold into "_other" (the TOTAL stays
    exact either way — the identity never depends on per-tenant
    splits)."""
    if tenant and not _TR.tenant_tracked(tenant):
        tenant = "_other"
    return _REG.counter(
        "fleet_requests_shed_total",
        "admissions REJECTED by the overload contract (bounded router "
        "admission; graceful degradation, never collapse)",
        labels={"reason": str(reason), "tenant": str(tenant or "")})


class NoLiveReplicaError(RuntimeError):
    """Every replica is dead: the only way a fleet request can fail."""


class RequestShedError(RuntimeError):
    """The router REFUSED this admission: the fleet is over its
    admission budget. Shedding is the overload contract's graceful
    degradation — the caller gets an immediate, accounted rejection
    (retry later / elsewhere) instead of an unbounded queue inflating
    every tenant's tail latency. Counted in
    ``fleet_requests_shed_total{reason=,tenant=}``; never raised for a
    request that was already admitted."""

    def __init__(self, msg, reason="capacity", tenant=None, depth=None,
                 budget=None):
        super().__init__(msg)
        self.reason = reason
        self.tenant = tenant
        self.depth = depth
        self.budget = budget


@dataclass
class HedgePolicy:
    """Hedged re-placement policy. The watchdog waits an
    ADAPTIVE multiple of the fleet's own latency sketches — `ttft_mult`
    x median fleet TTFT before a placement's first token, `tpot_mult`
    x median fleet TPOT between tokens — clamped to
    [min_wait_s, max_wait_s] (cold sketches fall back to max_wait_s, so
    warmup compiles never fire spurious hedges). `max_fraction` bounds
    concurrent hedges to that fraction of admitted in-flight requests
    (floor 1): a fleet-WIDE brownout degrades, it cannot double offered
    load. One hedge per placement; first-new-token-wins; the loser is
    cancelled via the cancel verb."""
    ttft_mult: float = 8.0
    tpot_mult: float = 8.0
    min_wait_s: float = 0.25
    max_wait_s: float = 5.0
    max_fraction: float = 0.25


class _PumpFeeder:
    """Background puller for the hedge race: drains one replica pump
    into the SHARED queue tagged by source, so the hedged consumer
    races two pumps with one blocking get. A feeder that owns its
    placement claim (hedge placements) releases it itself when the
    pump ends; the primary's claim stays with stream()'s finally —
    exactly one decrement per claim either way."""

    def __init__(self, router, tag, name, handle, snap, start, q,
                 owns_claim):
        self.router = router
        self.tag = tag
        self.name = name
        self.handle = handle
        self.q = q
        self._snap = snap
        self._start = int(start)
        self._owns_claim = owns_claim
        self.thread = threading.Thread(
            target=self._run, daemon=True, name=f"pump:{name}")
        self.thread.start()

    def _run(self):
        try:
            try:
                pump = self.handle.submit(self._snap, start=self._start)
                for cursor, tok in pump:
                    self.q.put(("tok", self.tag, int(cursor), int(tok)))
                self.q.put(("end", self.tag, None, None))
            except BaseException as e:  # noqa: BLE001 — relayed, the
                self.q.put(("err", self.tag, e, None))   # consumer
                #                                          classifies
        finally:
            if self._owns_claim:
                with self.router._lock:
                    if self.name in self.router._inflight:
                        self.router._inflight[self.name] -= 1


class Router:
    def __init__(self, replicas, store=None, page_size=16,
                 heartbeat_timeout=2.0, join_grace=10.0,
                 max_affinity_entries=8192, admission_budget=None,
                 roles=None, deadline_from_slo=None, hedge=None):
        """replicas: {name: handle} or iterable of objects with
        ``.name``. store: heartbeat store (same object/root the replicas
        publish to); None disables heartbeat health (stream errors still
        fail over). page_size must match the replicas' engines for the
        affinity hashes to align. admission_budget: max fleet-wide
        in-flight requests before NEW admissions are shed
        (RequestShedError, accounted — the overload contract); None
        disables shedding (unbounded admission, the historical
        behavior). roles: {name: "prefill"|"decode"} role tags
        — merged with each handle's own ``.role``; once BOTH
        roles exist in the fleet, requests prefill on a prefill replica
        (compute-bound, bursty) and hand off — KV pages transferred,
        not recomputed — to a decode replica (bandwidth-bound, steady)
        for the rest of their tokens. An untagged fleet behaves
        bit-for-bit as before.

        Gray-failure defense, BOTH off by default — flag-off
        the router is bit-for-bit the pre-defense router:
        deadline_from_slo: multiple of a request's slo_ms minted as its
        end-to-end deadline_ms at admission when the caller passes none
        (e.g. 4.0 -> a 250ms-SLO request expires engine-side after 1s);
        None never derives a deadline (callers can still pass
        deadline_ms per request). hedge: a HedgePolicy arming the
        progress watchdog + hedged re-placement; None disables."""
        if not isinstance(replicas, dict):
            replicas = {r.name: r for r in replicas}
        if not replicas:
            raise ValueError("router needs at least one replica")
        self._replicas = dict(replicas)
        unknown = set(roles or {}) - set(self._replicas)
        if unknown:
            # a typo'd replica name must not silently disable the split
            raise ValueError(
                f"roles name unknown replicas {sorted(unknown)} "
                f"(configured: {sorted(self._replicas)})")
        self._roles = {}
        for n, h in self._replicas.items():
            r = (roles or {}).get(n, getattr(h, "role", None))
            if r is not None:
                if str(r) not in ("prefill", "decode"):
                    raise ValueError(
                        f"unknown replica role {r!r} for {n!r} "
                        "(expected 'prefill' or 'decode')")
                self._roles[n] = str(r)
        vals = set(self._roles.values())
        self._role_split = "prefill" in vals and "decode" in vals
        self._draining = set()      # placement-excluded; in-flight
        #                             streams hand off at the next
        #                             token boundary (state TRANSFERRED
        #                             from the still-alive source)
        self._store = store
        self.page_size = int(page_size)
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.join_grace = float(join_grace)
        self._lock = threading.Lock()
        self._dead = set()          # HARD dead: stream error/process exit
        self._suspect = set()       # stale heartbeat: avoid for placement,
        #                             but still usable as a last resort —
        #                             a busy replica (GIL-bound compile)
        #                             stalls its beat thread without being
        #                             dead, and "every replica suspect"
        #                             must degrade placement, not requests
        self._inflight = {name: 0 for name in self._replicas}
        self.admission_budget = None if admission_budget is None \
            else int(admission_budget)
        self._admitted = 0          # fleet-wide in-flight requests (the
        #                             admission budget's denominator):
        #                             +1 at stream() admission, -1 when
        #                             the stream closes for ANY outcome
        self.deadline_from_slo = None if deadline_from_slo is None \
            else float(deadline_from_slo)
        self.hedge = hedge          # HedgePolicy or None (off)
        self._hedges_active = 0     # concurrent hedges in flight (the
        #                             HedgePolicy.max_fraction budget's
        #                             numerator)
        self._placements = {}       # trace -> (name, handle) of the
        #                             CURRENT placement: what cancel()
        #                             and the abandoned-stream teardown
        #                             aim the cancel verb at
        self._progress = {}         # name -> perf_counter of the last
        #                             placement/token on that replica:
        #                             the straggler detector's
        #                             stall-seconds source
        self._prefix_owner = OrderedDict()   # chain_hash -> replica name
        self._max_affinity = int(max_affinity_entries)
        self._hb_seen = {}          # name -> (raw value, local receipt t)
        self._started = time.monotonic()
        self._joined = {n: self._started for n in self._replicas}
        #                             per-replica membership time: the
        #                             heartbeat join grace must run from
        #                             when a replica JOINED, not from
        #                             router start — a replica spawned
        #                             an hour in would otherwise be
        #                             suspected before its first beat
        self._watch_stop = threading.Event()
        self._watch_thread = None
        self.doctor = None          # lazily built by doctor_sweep()
        self._doctor_thread = None
        self._last_scrape = {}      # name -> last good metrics payload
        #                             of the CURRENT incarnation; folded
        #                             back into the fleet merge when the
        #                             replica dies or errors, so its
        #                             lifetime counters never vanish
        #                             mid-window (negative fleet deltas
        #                             would mask the doctor's coincident
        #                             cause findings exactly when a death
        #                             makes them most likely)
        self._retired_scrapes = OrderedDict()   # (pid, inc) -> final
        #                             payload of a PROCESS that left
        #                             the fleet (a dead replica
        #                             replaced under the same name, or
        #                             a removed replica). Retention is
        #                             keyed by INCARNATION, never by
        #                             name or bare pid: merging a dead
        #                             predecessor's retained scrape as
        #                             if it were the successor would
        #                             double-count the name, dropping
        #                             it would send fleet deltas
        #                             negative, and pids are recycled.
        #                             Bounded LRU.
        self._max_retired = 128
        self._scrape_lock = threading.Lock()    # leaf lock guarding
        #                             _last_scrape/_retired_scrapes:
        #                             _scrape_fleet runs lock-free
        #                             (long replica I/O) while spawn/
        #                             remove retire under the router
        #                             lock — the retention dicts need
        #                             their own atomicity
        self.last_fleet_snapshot = None   # doctor_sweep stashes the
        #                             merge it interpreted, so a
        #                             consumer (the supervisor) reads
        #                             attainment off the SAME scrape
        #                             the findings came from
        _G_LIVE.set(len(self.live_replicas()))

    # -- membership -------------------------------------------------------
    def usable_replicas(self):
        """Replicas a sequence CAN run on: process/flag-alive and not
        hard-dead. Includes heartbeat suspects — suspicion shapes
        placement preference, never request viability."""
        return [n for n, h in self._replicas.items()
                if n not in self._dead and h.alive()]

    def live_replicas(self):
        """Usable and not under heartbeat suspicion."""
        return [n for n in self.usable_replicas()
                if n not in self._suspect]

    def mark_dead(self, name, reason=""):
        """HARD death: a stream raised / the process exited. Final."""
        with self._lock:
            if name in self._dead:
                return
            self._dead.add(name)
            self._suspect.discard(name)
            self._draining.discard(name)   # death finishes any drain
        _C_FAILOVERS.inc()
        live = self.live_replicas()
        _G_LIVE.set(len(live))
        _G_DRAINING.set(len(self._draining))
        _EVENTS.record("fleet_replica_dead", replica=name,
                       reason=str(reason)[:160], live=len(live))

    def suspect(self, name, reason=""):
        """SOFT death verdict (stale heartbeat): stop placing new work
        here, keep in-flight streams (tokens flowing is the stronger
        liveness signal), and lift the suspicion when the beat resumes."""
        with self._lock:
            if name in self._suspect or name in self._dead:
                return
            self._suspect.add(name)
        _C_SUSPECT.inc()
        _G_LIVE.set(len(self.live_replicas()))
        _EVENTS.record("fleet_replica_suspect", replica=name,
                       reason=str(reason)[:160])

    def clear_suspect(self, name):
        with self._lock:
            was = name in self._suspect
            self._suspect.discard(name)
        if was:
            _G_LIVE.set(len(self.live_replicas()))
            _EVENTS.record("fleet_replica_recovered", replica=name)

    def dead_replicas(self):
        """Registered names under a HARD death verdict (the
        supervisor's replace queue)."""
        with self._lock:
            return sorted(self._dead & set(self._replicas))

    def suspected_replicas(self):
        """Names currently under heartbeat suspicion."""
        with self._lock:
            return sorted(self._suspect)

    def draining_replicas(self):
        """Names currently draining (placement-excluded)."""
        with self._lock:
            return sorted(self._draining)

    def handle_of(self, name):
        """The replica handle registered under `name` (KeyError when
        unknown)."""
        return self._replicas[name]

    def registered_replicas(self):
        """{name: handle} snapshot of the registry, verdicts NOT
        applied — the supervisor's liveness probe walks this (a dead
        process must be visible here precisely because usable_replicas
        hides it)."""
        return dict(self._replicas)

    def fleet_roles(self):
        """({name: role}, role_split) snapshot — what a scale-down
        victim choice needs to avoid draining the last replica of a
        role remove() would then refuse."""
        return dict(self._roles), self._role_split

    def affinity_counts(self):
        """{name: owned prefix-chain entries} over the bounded owner
        map — how much cached-prefix investment placement would lose by
        draining each replica (the supervisor's scale-down victim
        ranking reads this)."""
        with self._lock:
            counts = {n: 0 for n in self._replicas}
            for owner in self._prefix_owner.values():
                if owner in counts:
                    counts[owner] += 1
            return counts

    @staticmethod
    def _inc_key(m):
        """(pid, incarnation-token) identity of a scrape payload. OS
        pids are recycled: keying retention by bare pid would let a
        LATER process that drew the same pid shadow (or double-skip) a
        retiree's final counters. Payloads without the token (older
        workers) degrade to pid-only identity."""
        return (m.get("pid"), m.get("inc"))

    def _retire_scrape(self, name):
        """Move `name`'s last good scrape into the incarnation-keyed
        retired store: its PROCESS is leaving the fleet
        (death-and-replacement or removal) but its cumulative counters
        remain true forever and must keep feeding the merge. Guarded
        by the dedicated scrape lock (a LEAF lock — safe under the
        router lock at spawn/remove call sites, and what makes the
        multi-step pop/insert/evict sequence atomic against a
        concurrent lock-free ``_scrape_fleet`` on the /metrics
        thread)."""
        import os as _os
        with self._scrape_lock:
            m = self._last_scrape.pop(name, None)
            if m is None:
                return
            pid = m.get("pid")
            if pid is None or pid == _os.getpid():
                return  # the router's own registry is collected live
            self._retired_scrapes[self._inc_key(m)] = m
            self._retired_scrapes.move_to_end(self._inc_key(m))
            while len(self._retired_scrapes) > self._max_retired:
                self._retired_scrapes.popitem(last=False)

    def spawn(self, name, handle, role=None):
        """Register a NEW replica (or a fresh incarnation under a dead
        replica's name) at runtime — the supervisor's scale-up /
        replace verb. Clears every per-name verdict (dead,
        suspect, draining, heartbeat history) because the verdicts
        belonged to the previous incarnation, retires that
        incarnation's metrics scrape by pid so the fleet merge neither
        double-counts nor drops it, and purges the dead incarnation's
        prefix-affinity claims (the successor's cache is cold —
        routing sharers to it as an owner would be a phantom hit).
        Refuses to shadow a live replica."""
        if role is not None and str(role) not in ("prefill", "decode"):
            raise ValueError(f"unknown replica role {role!r} for "
                             f"{name!r} (expected 'prefill' or 'decode')")
        with self._lock:
            old = self._replicas.get(name)
            if old is not None and name not in self._dead and old.alive():
                raise ValueError(
                    f"replica {name!r} is already registered and alive "
                    "— remove() or kill it before spawning a successor")
            self._retire_scrape(name)
            # copy-on-write rebind: stream()/health threads iterate
            # these dicts outside the lock
            reps = dict(self._replicas)
            reps[name] = handle
            self._replicas = reps
            # the predecessor's in-flight placements keep their claimed
            # slots: each failing/rerouting stream's finally-release
            # balances its own claim — zeroing here would drive the
            # successor's count negative on those releases, and a
            # negative count wedges min-inflight placement AND the
            # drain-then-remove path (remove waits for exactly 0)
            self._inflight = dict(self._inflight,
                                  **{name: self._inflight.get(name, 0)})
            self._dead.discard(name)
            self._suspect.discard(name)
            self._draining.discard(name)
            self._hb_seen.pop(name, None)
            self._joined[name] = time.monotonic()
            r = role if role is not None else getattr(handle, "role", None)
            roles = dict(self._roles)
            roles.pop(name, None)
            if r is not None:
                roles[name] = str(r)
            self._roles = roles
            vals = set(self._roles.values())
            self._role_split = "prefill" in vals and "decode" in vals
            for h, owner in list(self._prefix_owner.items()):
                if owner == name:
                    del self._prefix_owner[h]
        _C_SPAWNED.inc()
        live = self.live_replicas()
        _G_LIVE.set(len(live))
        _G_DRAINING.set(len(self._draining))
        _EVENTS.record("fleet_replica_spawned", replica=name,
                       role=r, replacement=old is not None,
                       live=len(live))
        return handle

    def remove(self, name, force=False):
        """Deregister a replica at runtime — the supervisor's
        scale-down / retirement verb. REFUSES (ValueError,
        never a silent no-op) to remove the last viable replica of the
        fleet, or — in a role-split fleet — the last viable replica of
        its role: a scale-down that leaves requests unservable is an
        outage command, not an action. Also refuses while the replica
        still carries in-flight placements unless ``force`` (drain
        first; the supervisor always does). Returns the handle so the
        caller decides shutdown vs. reuse; the incarnation's metrics
        scrape is retired by pid so fleet counter deltas stay
        monotone."""
        with self._lock:
            if name not in self._replicas:
                raise KeyError(f"unknown replica {name!r}")
            survivors = [n for n, h in self._replicas.items()
                         if n != name and n not in self._dead
                         and h.alive()]
            if not survivors:
                raise ValueError(
                    f"refusing to remove {name!r}: it is the last "
                    "viable replica — removal would leave the fleet "
                    "unservable")
            role = self._roles.get(name)
            if self._role_split and role is not None and not any(
                    self._roles.get(n) == role for n in survivors):
                raise ValueError(
                    f"refusing to remove {name!r}: it is the last "
                    f"viable {role!r} replica of a role-split fleet")
            inflight = self._inflight.get(name, 0)
            if inflight and not force:
                raise ValueError(
                    f"refusing to remove {name!r}: {inflight} "
                    "placements still in flight — drain() first "
                    "(or pass force=True to abandon them to failover)")
            self._retire_scrape(name)
            reps = dict(self._replicas)
            handle = reps.pop(name)
            self._replicas = reps
            if not inflight:
                self._inflight = {n: v for n, v in self._inflight.items()
                                  if n != name}
            #   (a forced removal keeps the in-flight slot so the
            #    stream's finally-decrement still balances)
            self._dead.discard(name)
            self._suspect.discard(name)
            self._draining.discard(name)
            self._hb_seen.pop(name, None)
            self._joined.pop(name, None)
            roles = dict(self._roles)
            roles.pop(name, None)
            self._roles = roles
            vals = set(self._roles.values())
            self._role_split = "prefill" in vals and "decode" in vals
            for h, owner in list(self._prefix_owner.items()):
                if owner == name:
                    del self._prefix_owner[h]
        _C_REMOVED.inc()
        live = self.live_replicas()
        _G_LIVE.set(len(live))
        _G_DRAINING.set(len(self._draining))
        _EVENTS.record("fleet_replica_removed", replica=name,
                       forced=bool(force), live=len(live))
        return handle

    # -- draining ----------------------------------------------
    def drain(self, name):
        """Begin DRAINING a replica: no new placements land on it, and
        every in-flight stream hands its sequence off at its next token
        boundary — the sequence state AND its computed KV pages are
        exported from the still-alive source and imported on the new
        placement (``fleet_drain_exports_total`` / the kv_transfer
        counters), so the move costs a transfer, not a re-prefill. The
        replica object is untouched: once ``inflight_of(name)`` reaches
        0 it can be shut down, hot-swapped, or killed with zero failed
        requests and zero recompute. Idempotent."""
        with self._lock:
            if name not in self._replicas or name in self._draining:
                return
            self._draining.add(name)
        _G_DRAINING.set(len(self._draining))
        _EVENTS.record("fleet_replica_draining", replica=name,
                       inflight=self._inflight.get(name, 0))

    def undrain(self, name):
        """Cancel a drain: the replica takes new placements again."""
        with self._lock:
            was = name in self._draining
            self._draining.discard(name)
        if was:
            _G_DRAINING.set(len(self._draining))
            _EVENTS.record("fleet_replica_undrained", replica=name)

    def inflight_of(self, name):
        """In-flight placements on a replica (drain-completion poll)."""
        with self._lock:
            return self._inflight.get(name, 0)

    # -- cancellation propagation ------------------------------
    def cancel(self, trace, reason=None):
        """Send the cancel verb to whatever replica currently serves
        `trace`: engine slot + pages freed within one step instead of
        decoding to budget. Best-effort and idempotent — False when the
        trace has no live placement (finished, never admitted, already
        cancelled) or the replica could not be reached (a dead replica
        needs no cancel). The consumer's stream, if still open, raises
        RequestCancelledError at its next token. `reason` rides the
        verb so the engine's cost ledger books the sunk work under the
        right waste bucket (abandoned vs plain cancelled)."""
        placed = self._placements.get(trace)
        if placed is None:
            return False
        name, handle = placed
        cancel_fn = getattr(handle, "cancel", None)
        if cancel_fn is None:
            return False
        _C_CANCELS_SENT.inc()
        try:
            try:
                ok = bool(cancel_fn(trace, reason=reason))
            except TypeError:   # an older handle: no reason kwarg
                ok = bool(cancel_fn(trace))
        except Exception as e:  # noqa: BLE001 — a dead/unreachable
            #                     replica needs no cancel; the request
            #                     is already torn down with the process
            _EVENTS.record("fleet_cancel_failed", trace=trace,
                           replica=name,
                           error=f"{type(e).__name__}: {str(e)[:120]}")
            return False
        _EVENTS.record("fleet_cancel_sent", trace=trace, replica=name,
                       cancelled=ok)
        return ok

    def _note_progress(self, name):
        """Stamp a placement/token on `name` — the straggler
        detector's per-replica progress clock (a plain GIL-atomic dict
        write on the token path)."""
        self._progress[name] = time.perf_counter()

    def _publish_replica_progress(self):
        """Refresh the per-replica stall gauges the straggler detector
        (observability/detectors.py StragglerReplica) windows over:
        ``fleet_replica_stall_seconds{replica=}`` — seconds since the
        last placement-or-token on a replica that still HAS in-flight
        placements (0.0 when idle: an idle replica is not stalling,
        it is unoffered) — and ``fleet_replica_inflight{replica=}``."""
        now = time.perf_counter()
        with self._lock:
            inflight = dict(self._inflight)
        for name in list(self._replicas):
            n_in = inflight.get(name, 0)
            stall = 0.0
            if n_in > 0:
                stall = max(0.0, now - self._progress.get(name, now))
            _REG.gauge(
                "fleet_replica_stall_seconds",
                "seconds since the last token/placement on a replica "
                "with in-flight work (the straggler detector's signal; "
                "0 when idle)",
                labels={"replica": name}).set(stall)
            _REG.gauge(
                "fleet_replica_inflight",
                "router-side in-flight placements per replica",
                labels={"replica": name}).set(n_in)
            if name in self._progress:
                # progress AGE is published busy or not: a peer that
                # drained its queue and went idle a second ago is the
                # straggler detector's best witness that the fleet
                # itself is fast — the stall gauge (0 when idle) can't
                # carry that evidence, and a replica that never
                # produced anything publishes no age at all
                _REG.gauge(
                    "fleet_replica_progress_age_seconds",
                    "seconds since the last token/placement on a "
                    "replica, regardless of in-flight work (witness "
                    "evidence for the straggler detector)",
                    labels={"replica": name}).set(
                        max(0.0, now - self._progress[name]))

    # -- health (heartbeats on the store) ---------------------------------
    def check_heartbeats(self):
        """One health pass: a replica whose heartbeat VALUE has not
        changed (locally observed) for heartbeat_timeout becomes a
        SUSPECT — avoided for placement until the beat resumes; one
        that never wrote within join_grace of router start is too.
        Store outages are not votes — an unreadable store leaves every
        verdict unchanged (tokens flowing on live streams remain the
        stronger liveness signal). Hard death only ever comes from the
        stream/process error path."""
        if self._store is None:
            return self.live_replicas()
        now = time.monotonic()
        for name in list(self._replicas):
            if name in self._dead:
                continue
            try:
                val = self._store.get(HB_KEY_PREFIX + name)
            except KeyError:
                joined = self._joined.get(name, self._started)
                if now - joined > self.join_grace:
                    self.suspect(name, "no heartbeat ever (join grace "
                                       f"{self.join_grace}s exceeded)")
                continue
            except Exception:  # noqa: BLE001 — store outage: no verdict
                continue
            prev = self._hb_seen.get(name)
            if prev is None or prev[0] != val:
                self._hb_seen[name] = (val, now)
                self.clear_suspect(name)     # the beat resumed
                continue
            if now - prev[1] > self.heartbeat_timeout:
                self.suspect(
                    name, f"heartbeat stale {now - prev[1]:.2f}s "
                          f"(> {self.heartbeat_timeout}s)")
        return self.live_replicas()

    def heartbeat_of(self, name):
        """Latest decoded heartbeat payload of a replica, or None."""
        if self._store is None:
            return None
        try:
            return json.loads(self._store.get(HB_KEY_PREFIX + name))
        except Exception:  # noqa: BLE001
            return None

    def start_health_watch(self, interval=0.25):
        """Background heartbeat watcher + idle replica maintenance
        ticks (weight-swap polls on traffic-less replicas)."""
        def watch():
            while not self._watch_stop.is_set():
                self.check_heartbeats()
                for name in self.live_replicas():
                    poll = getattr(self._replicas[name], "poll", None)
                    if poll is not None:
                        poll()
                self._watch_stop.wait(interval)
        self._watch_thread = threading.Thread(target=watch, daemon=True,
                                              name="fleet-health-watch")
        self._watch_thread.start()
        return self

    def stop(self):
        self._watch_stop.set()
        if self._watch_thread is not None:
            self._watch_thread.join(2.0)
        if self._doctor_thread is not None:
            self._doctor_thread.join(2.0)

    # -- fleet doctor ------------------------------------------
    def doctor_sweep(self, expected=()):
        """One doctor observation over the CURRENT fleet merge: run the
        streaming detectors (observability/detectors.py) on a
        ``fleet_snapshot()`` window — merged counters/gauges/histograms
        plus the merged quantile-sketch states — correlated and
        published as ``doctor_findings{finding=}`` gauges and
        ``diagnosis`` events on the router's registry/ring (see
        observability/doctor.py). The first sweep is the baseline and
        returns []. Returns the ranked unexpected findings."""
        from ..observability.doctor import Doctor
        if self.doctor is None:
            self.doctor = Doctor(name="fleet", expected=expected)
        elif expected:
            self.doctor.expected |= set(expected)
        snap = self.fleet_snapshot()
        self.last_fleet_snapshot = snap
        # PER-SOURCE sketch states, never the merged form: window_diff's
        # append-only-levels property holds within one process's sketch
        # only — a re-merged sketch rewrites its buffers every sweep,
        # and diffing it would hand LatencyDrift the lifetime
        # distribution labeled as a window (silent on fresh regressions)
        return self.doctor.observe(
            snapshot=snap,
            sketches=snap.get("sketch_states_by_source"))

    def start_doctor(self, interval=2.0, expected=()):
        """Periodic router-side doctor sweeps: the serving analogue of
        the training hook — every `interval` seconds the whole fleet's
        merged telemetry is interpreted into named findings, so an
        operator (or the autoscaler, ROADMAP item 5) reads
        ``doctor_findings{finding=}`` instead of staring at raw p95
        gauges. Idempotent; stopped by ``stop()``."""
        if self._doctor_thread is not None:
            return self
        self.doctor_sweep(expected=expected)     # baseline window

        def sweep():
            while not self._watch_stop.wait(interval):
                try:
                    self.doctor_sweep()
                except Exception as e:  # noqa: BLE001 — a failed sweep
                    # must never take the fleet down with it
                    _EVENTS.record("doctor_sweep_error",
                                   error=f"{type(e).__name__}: "
                                         f"{str(e)[:120]}")
        self._doctor_thread = threading.Thread(
            target=sweep, daemon=True, name="fleet-doctor")
        self._doctor_thread.start()
        return self

    # -- fleet metrics plane ------------------------------------
    def _scrape_fleet(self):
        """ONE metrics round trip per distinct replica PROCESS: returns
        (series_lists, sketch-states-by-source, per-replica info).
        Sources are pid-deduped (all LocalReplicas of one process share
        a registry — summing it N times would fabricate traffic) and
        keyed by PID — stable across snapshots even when the first
        usable replica name changes (a death mid-window must not make
        a consumer's window diff silently fall back to lifetime data).
        Keeping states per SOURCE is what lets a consumer window-diff
        them (append-only levels hold per process, never across a
        merge)."""
        per, seen_pids = {}, set()
        series_lists, states_by_source = [], {}
        for name in self.usable_replicas():
            fn = getattr(self._replicas[name], "metrics", None)
            if fn is None:
                continue
            try:
                m = fn()
            except Exception as e:  # noqa: BLE001 — scrape, don't kill
                per[name] = {"error": f"{type(e).__name__}: "
                                      f"{str(e)[:120]}"}
                _EVENTS.record("fleet_metrics_error", replica=name,
                               error=f"{type(e).__name__}: "
                                     f"{str(e)[:120]}")
                continue
            prev = self._last_scrape.get(name)
            if prev is not None \
                    and self._inc_key(prev) != self._inc_key(m):
                # the name was re-incarnated without spawn() being told
                # (defensive): retire the predecessor's finals by
                # incarnation before the fresh payload shadows them
                self._retire_scrape(name)
            with self._scrape_lock:
                self._last_scrape[name] = m
            per[name] = {"pid": m.get("pid"),
                         "events_dropped": m.get("events_dropped", 0)}
            _REG.gauge(
                "fleet_replica_events_dropped",
                "per-replica event-ring drops (trace-gap evidence)",
                labels={"replica": name}).set(m.get("events_dropped", 0))
            pid = m.get("pid")
            if pid in seen_pids:
                per[name]["shared_process"] = True
                continue
            seen_pids.add(pid)
            series_lists.append(m.get("series") or [])
            states_by_source[f"pid{pid}"] = m.get("sketches") or {}
        import os as _os
        # Dead/unreachable replicas: fold each one's LAST good scrape
        # back into the merge. Counters are cumulative, so a dead
        # process's final totals are its truth — dropping them would
        # send merged counter deltas sharply negative in exactly the
        # window a death occurs, silencing the cause detectors (fallback
        # spike, recompile storm) right when ReplicaDeath fires and the
        # correlation needs them. Skips pids already counted live (a
        # recovered or shared process) and the router's own pid (its
        # registry is collected live below; a stale cache must never
        # shadow it).
        with self._scrape_lock:
            last_scrapes = list(self._last_scrape.items())
            retired_scrapes = list(self._retired_scrapes.items())
        for name, m in last_scrapes:
            pid = m.get("pid")
            if (name in per and "error" not in per[name]) \
                    or name not in self._replicas \
                    or pid in seen_pids or pid == _os.getpid():
                continue
            seen_pids.add(pid)
            # counters/histograms/sketches only: those are cumulative,
            # so a dead process's finals stay true forever. Its GAUGES
            # are point-in-time claims about state that no longer
            # exists (queue depth, free pages, tokens/sec) — re-merging
            # them would overstate fleet capacity and fire QueueBuildup
            # on a phantom backlog for the rest of the router's life.
            series_lists.append([s for s in m.get("series") or []
                                 if s.get("type") != "gauge"])
            states_by_source[f"pid{pid}"] = m.get("sketches") or {}
            per.setdefault(name, {}).update(
                pid=pid, retained=True,
                events_dropped=m.get("events_dropped", 0))
        # RETIRED incarnations (a dead replica replaced under the same
        # name, a removed replica): their processes are gone but their
        # cumulative counters are final truths — fold them in so the
        # merge stays monotone across a replacement. Keyed by
        # INCARNATION (pid + per-process token), never by name or bare
        # pid: the successor scrapes live under the name (a name-keyed
        # merge would double-count the window's deltas), and a recycled
        # pid must neither shadow a retiree's finals nor be skipped as
        # if the retiree were still the live process.
        seen_incs = {self._inc_key(m) for _, m in last_scrapes}
        for key, m in retired_scrapes:
            pid = m.get("pid")
            if key in seen_incs or pid == _os.getpid():
                continue
            seen_incs.add(key)
            series_lists.append([s for s in m.get("series") or []
                                 if s.get("type") != "gauge"])
            label = f"pid{pid}"
            if label in states_by_source or label in per:
                # recycled pid (a live source or another retiree
                # already owns the label): keep both visible
                label = f"pid{pid}:{m.get('inc')}"
            states_by_source[label] = m.get("sketches") or {}
            per[label] = {"pid": pid, "retired": True,
                          "events_dropped": m.get("events_dropped", 0)}
        if _os.getpid() not in seen_pids:
            # the router's own process (fleet_* counters, and — for
            # subprocess fleets — the consumer-side fleet_* sketches)
            series_lists.append(_REG.collect())
            states_by_source[f"pid{_os.getpid()}"] = _TR.export_states()
        return series_lists, states_by_source, per

    def fleet_snapshot(self):
        """ONE pane for the whole fleet: pull every usable replica's
        registry (the worker-socket ``metrics`` verb for subprocess
        replicas, the shared in-process registry for local ones),
        dedupe by pid (all LocalReplicas of one process share a
        registry — summing it N times would fabricate traffic), merge
        counters/gauges/histograms additively and the quantile SKETCHES
        by real merge (percentiles do not add), and publish the headline
        results as live gauges on the router's own registry:

        - ``fleet_quantile_seconds{metric=ttft|tpot|e2e, q=p50|p95|p99}``
          — fleet-wide engine-side percentiles from the merged sketches,
        - ``fleet_replica_events_dropped{replica=}`` — each replica's
          event-ring loss, so a trace with holes is attributable.

        Returns {replicas: {name: {pid, events_dropped, error?}},
        counters, gauges, histograms, quantiles}. Unreachable replicas
        are skipped with a ``fleet_metrics_error`` event — a metrics
        outage must never look like a serving outage."""
        self._publish_replica_progress()   # per-replica stall gauges
        #                                    ride every snapshot, so the
        #                                    doctor's straggler detector
        #                                    windows over fresh values
        series_lists, states_by_source, per = self._scrape_fleet()
        merged = _TR.merge_series(series_lists)
        merged_sketches = _TR.merge_states(states_by_source.values())
        quantiles, attainment = self._derive_fleet_gauges(
            merged, merged_sketches)
        merged["quantiles"] = quantiles
        merged["slo_attainment"] = attainment
        # sketch STATES ride along so consumers (the load harness) can
        # window-diff per load point without resetting any replica's
        # lifetime sketches. Diffing needs the PER-SOURCE states — the
        # append-only-levels property window_diff relies on holds
        # within one process's sketch, never across a merge — while the
        # merged form serves anyone who just wants one state per name
        merged["sketch_states_by_source"] = {
            src: states for src, states in states_by_source.items()}
        merged["sketch_states"] = {name: sk.state()
                                   for name, sk in merged_sketches.items()}
        merged["replicas"] = per
        return merged

    def _derive_fleet_gauges(self, merged, merged_sketches):
        """Publish the derived fleet gauges from one scrape's merge:
        ``fleet_quantile_seconds{metric=,q=[,tenant=]}`` from the merged
        sketches, and ``fleet_slo_attainment{metric=[,tenant=]}``
        re-derived from the merged check/violation COUNTERS (attainment
        gauges are non-additive, the counters are — "whose
        SLO did the fleet miss"). Returns (quantiles, attainment)."""
        quantiles = {}
        for sk_name, sk in sorted(merged_sketches.items()):
            if not sk.count:
                continue
            quantiles[sk_name] = qs = {}
            base, tenant = _TR.split_metric(sk_name)
            for q, label in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                v = sk.quantile(q)
                qs[label] = v
                if base in ("ttft", "tpot", "e2e"):
                    labels = {"metric": base, "q": label}
                    if tenant:
                        # per-tenant fleet percentiles: the
                        # tenant-scoped per-replica sketches merged by
                        # NAME, published under the same gauge family
                        # with the tenant as a label
                        labels["tenant"] = tenant
                    _REG.gauge(
                        "fleet_quantile_seconds",
                        "fleet-wide latency percentiles (merged "
                        "per-replica quantile sketches)",
                        labels=labels).set(v)
            qs["count"] = sk.count
        attainment = {}
        for key, checks in merged["counters"].items():
            if not key.startswith("slo_checks_total") or not checks:
                continue
            _, labels = _TR.parse_series_key(key)
            viols = merged["counters"].get(
                key.replace("slo_checks_total", "slo_violations_total"),
                0)
            att = 1.0 - viols / checks
            attainment[key.replace("slo_checks_total", "", 1)
                       .strip("{}") or "all"] = att
            _REG.gauge(
                "fleet_slo_attainment",
                "fleet-merged fraction of graded requests within "
                "budget (re-derived from merged check/violation "
                "counters)",
                labels=labels).set(att)
        return quantiles, attainment

    def fleet_accounting(self):
        """The overload contract's books, from the router's own
        counters: every request offered to stream() is EXACTLY one of
        completed / shed / failed / deadline_exceeded / cancelled /
        abandoned / still in flight — ``accounting_identity_ok`` checks
        the identity, the load harness asserts it at every load point,
        and bench emits a visibly-broken record when it does not hold.
        Counters are process-cumulative: callers sweeping multiple
        windows diff consecutive snapshots."""
        shed = 0
        for s in _REG.collect():
            if s["name"] == "fleet_requests_shed_total":
                shed += s.get("value", 0)
        with self._lock:
            in_flight = self._admitted
        return {"offered": _C_REQS.value,
                "completed": _C_DONE.value,
                "shed": int(shed),
                "failed": _C_FAILED.value,
                "deadline_exceeded": _C_DEADLINE_X.value,
                "cancelled": _C_CANCELLED.value,
                "abandoned": _C_ABANDONED.value,
                "in_flight": in_flight}

    @staticmethod
    def accounting_identity_ok(acc, drained=True):
        """offered == completed + shed + failed + deadline_exceeded +
        cancelled (+ abandoned [+ in flight unless drained]) — exactly.
        `acc` may be a fleet_accounting() snapshot or a diff of two
        (the new buckets default to 0 so older snapshots still
        grade)."""
        rhs = (acc["completed"] + acc["shed"] + acc["failed"]
               + acc.get("deadline_exceeded", 0)
               + acc.get("cancelled", 0)
               + acc.get("abandoned", 0))
        if not drained:
            rhs += acc.get("in_flight", 0)
        return acc["offered"] == rhs

    def fleet_series(self):
        """The fleet merge rendered back as collect()-shaped series —
        what the router-side /metrics endpoint exposes. ONE scrape:
        the raw per-process series feed both the full-bucket histogram
        merge here and the derived-gauge refresh (quantiles/attainment,
        published on the router's registry by fleet_snapshot's
        derivation, re-run on the same scrape via the shared helper).
        Merged counters/gauges keep their labels (parse_series_key
        inverts the merge keys)."""
        series_lists, states_by_source, _ = self._scrape_fleet()
        # ONE merge serves both uses: _derive_fleet_gauges reads only
        # the counters, and full-bucket histograms are a superset of
        # the compact form
        merged = _TR.merge_series(series_lists, full_histograms=True)
        self._derive_fleet_gauges(
            merged, _TR.merge_states(states_by_source.values()))
        own = _REG.collect()
        out = []
        for key, v in sorted(merged["counters"].items()):
            name, labels = _TR.parse_series_key(key)
            out.append({"name": name, "type": "counter",
                        "labels": labels, "value": v})
        for key, v in sorted(merged["gauges"].items()):
            name, labels = _TR.parse_series_key(key)
            out.append({"name": name, "type": "gauge",
                        "labels": labels, "value": v})
        for key, h in sorted(merged["histograms"].items()):
            name, labels = _TR.parse_series_key(key)
            out.append(dict(h, name=name, type="histogram",
                            labels=labels))
        # the derived fleet gauges live only on the router's registry
        # (merge_series drops them as non-additive): re-attach them
        for s in own:
            if s.get("type") == "gauge" and s["name"].startswith(
                    ("fleet_quantile_seconds", "fleet_slo_attainment",
                     "fleet_replica_events_dropped", "slo_")):
                out.append(s)
        return out

    def serve_metrics(self, port=0, host="127.0.0.1"):
        """Router-side /metrics: the one-pane
        fleet_snapshot() merge over HTTP. Workers already expose their
        per-process /metrics; this endpoint is the fleet ROLLUP —
        merged counters/histograms, merged-sketch percentiles, and
        fleet attainment — scraped at the router, where placement and
        shedding decisions are made. Reuses exporters.serve_prometheus
        through a registry view whose collect() refreshes the merge, so
        the text exposition format is identical to every other /metrics
        in the system. Returns the server (``server.server_port``,
        ``server.shutdown()``)."""
        from ..observability.exporters import serve_prometheus

        router = self

        class _FleetView:
            def collect(self):
                return router.fleet_series()

        return serve_prometheus(port, host=host, registry=_FleetView())

    # -- placement --------------------------------------------------------
    def place(self, tokens, role=None):
        """Choose a replica for a sequence whose virtual tokens are
        `tokens`: deepest live prefix-hash owner first (its cache holds
        those pages), else least in-flight load. Heartbeat suspects are
        used only when NO unsuspected replica is usable (degraded
        placement beats a failed request); draining replicas likewise.
        `role` prefers that role group and falls back to the
        whole fleet when the group has no usable member — every engine
        can do both, the split is an optimization, never a failure
        mode. Returns (name, handle). Raises NoLiveReplicaError only
        when the fleet is truly empty."""
        return self._place(tokens, claim=False, role=role)

    def _place(self, tokens, claim, role=None, exclude=()):
        """claim=True atomically bumps the chosen replica's in-flight
        count under the SAME lock that read the counts — without it, a
        burst of concurrent submissions all observe the same loads and
        pile onto one replica by name tie-break (stream() claims;
        stream's finally releases). `exclude` strikes names outright
        (the hedge must land on a DIFFERENT replica than the straggling
        primary — with no peer left, placement fails rather than
        doubling down on the straggler)."""
        live = self.live_replicas() or self.usable_replicas()
        if exclude:
            live = [n for n in live if n not in exclude]
        if not live:
            raise NoLiveReplicaError(
                f"no live replicas ({len(self._replicas)} configured, "
                f"dead: {sorted(self._dead)})")
        # preference ladder, each rung only when non-empty: not-draining
        # beats draining; the requested role group beats the rest
        cands = [n for n in live if n not in self._draining] or live
        if role:
            in_role = [n for n in cands if self._roles.get(n) == role]
            if in_role:
                cands = in_role
        hashes = prefix_chain_hashes(np.asarray(tokens), self.page_size)
        with self._lock:
            chosen = None
            for h in reversed(hashes):        # deepest match wins
                owner = self._prefix_owner.get(h)
                if owner in cands:
                    chosen = owner
                    break
            affinity = chosen is not None
            if chosen is None:
                chosen = min(cands, key=lambda n: (self._inflight[n], n))
            if claim:
                self._inflight[chosen] += 1
            for h in hashes:
                self._prefix_owner[h] = chosen
                self._prefix_owner.move_to_end(h)
            while len(self._prefix_owner) > self._max_affinity:
                self._prefix_owner.popitem(last=False)
        if affinity:
            _C_AFFINITY.inc()
        return chosen, self._replicas[chosen]

    # -- KV transfer plane -------------------------------------
    def _import_kv_into(self, dst_name, dst_handle, meta, payload,
                        trace, src_name=None):
        """Map an exported page batch onto `dst` (best-effort: a failed
        import degrades to re-prefill, counted). Returns pages mapped."""
        t0 = time.perf_counter()
        try:
            pages = dst_handle.import_kv(meta, payload, trace=trace)
        except Exception as e:  # noqa: BLE001 — transfer is optional
            _C_KV_FALLBACK.inc()
            _EVENTS.record("fleet_kv_transfer_failed", trace=trace,
                           src=src_name, dst=dst_name, stage="import",
                           error=f"{type(e).__name__}: {str(e)[:160]}")
            return 0
        _C_KV_TRANSFERS.inc()
        _C_KV_PAGES.inc(pages)
        _C_KV_BYTES.inc(len(payload))
        # the router-side hop span: one trace across three processes —
        # the source's kv_export, this kv_transfer, the destination's
        # kv_import (trace_report draws the flow arrow through them)
        _TR.record_span("kv_transfer", t0, trace=trace, src=src_name,
                        dst=dst_name, pages=pages, bytes=len(payload))
        _EVENTS.record("fleet_kv_transfer", trace=trace, src=src_name,
                       dst=dst_name, pages=pages, nbytes=len(payload))
        return pages

    def _export_handoff_kv(self, src_name, src_handle, tokens, trace):
        """Read the prefix-indexed pages covering `tokens` off a
        prefill replica (non-destructive). (meta, payload) or None."""
        try:
            meta, payload = src_handle.export_kv(tokens, trace=trace)
        except Exception as e:  # noqa: BLE001
            _C_KV_FALLBACK.inc()
            _EVENTS.record("fleet_kv_transfer_failed", trace=trace,
                           src=src_name, stage="export",
                           error=f"{type(e).__name__}: {str(e)[:160]}")
            return None
        if meta is None:
            return None
        return meta, payload

    def _drain_export(self, name, handle, trace):
        """Pull a sequence (state + KV) off a DRAINING, still-alive
        source. Returns (snap, kv_or_None); (None, None) when the
        source could not serve the export (died mid-drain, request
        already gone) — the journal re-prefill path covers it."""
        try:
            snap, meta, payload = handle.export_sequence(trace, kv=True)
        except KeyError:
            # benign race, not a fallback: the request finished (and
            # was drained engine-side) between our last token and the
            # export — there is nothing left to move, the journal's
            # loop-top completion check settles it
            _EVENTS.record("fleet_drain_export_raced", replica=name,
                           trace=trace)
            return None, None
        except Exception as e:  # noqa: BLE001
            _C_KV_FALLBACK.inc()
            _EVENTS.record("fleet_drain_export_failed", replica=name,
                           trace=trace,
                           error=f"{type(e).__name__}: {str(e)[:160]}")
            return None, None
        _C_DRAIN_X.inc()
        _EVENTS.record("fleet_drain_export", replica=name, trace=trace,
                       tokens=len(snap.get("tokens", [])),
                       kv_pages=(meta or {}).get("n_pages", 0))
        return snap, ((meta, payload) if meta is not None else None)

    # -- hedged re-placement -----------------------------------
    def _hedge_wait(self, first):
        """The progress watchdog's wait: an adaptive multiple of the
        fleet's OWN latency sketches — median fleet TTFT before this
        placement's first token, median fleet TPOT between tokens —
        clamped to the policy's [min_wait_s, max_wait_s]. Sketches with
        too few observations fall back to max_wait_s: warmup compiles
        must never read as stragglers."""
        pol = self.hedge
        sk = _TR.sketch("fleet_ttft" if first else "fleet_tpot")
        if sk is not None and sk.count >= 16:
            wait = sk.quantile(0.5) * (pol.ttft_mult if first
                                       else pol.tpot_mult)
        else:
            wait = pol.max_wait_s
        return min(max(wait, pol.min_wait_s), pol.max_wait_s)

    def _fire_hedge(self, primary, trace, tenant, snapshot, start, q):
        """Place the journal-replay hedge on a second replica. Returns
        (name, handle, _PumpFeeder) with the hedge-budget slot and
        placement claim taken, or None when the hedge cannot fire: budget
        exhausted (max_fraction of in-flight already hedging), or no
        live peer besides the straggler — hedging onto the straggler
        itself would just double its queue."""
        pol = self.hedge
        with self._lock:
            budget = max(1, int(pol.max_fraction * max(self._admitted,
                                                       1)))
            if self._hedges_active >= budget:
                return None
            self._hedges_active += 1
        try:
            name, handle = self._place_hedge_target(primary)
        except NoLiveReplicaError:
            with self._lock:
                self._hedges_active -= 1
            return None
        self._note_progress(name)
        _C_HEDGES.inc()
        _EVENTS.record("fleet_hedge_fired", trace=trace, tenant=tenant,
                       primary=primary, hedge=name, at_cursor=start)
        feeder = _PumpFeeder(self, 1, name, handle, snapshot(), start,
                             q, owns_claim=True)
        return name, handle, feeder

    def _place_hedge_target(self, primary):
        """The hedge's placement: identical ladder, primary excluded."""
        # the journal tokens are in the snapshot; placement affinity
        # keys on them via _place's own hash walk, so just re-place
        name, handle = self._place([], claim=True, exclude={primary})
        return name, handle

    def _pump_hedged(self, name, handle, snap, out, trace, tenant,
                     snapshot):
        """The hedge race: yields the same (cursor, token) pairs
        ``handle.submit`` would, but watches per-token progress — a
        primary that goes silent past the adaptive watchdog (alive, not
        dead: death raises and takes the normal failover path) gets
        raced by ONE journal-replay hedge on a second replica.
        First-new-token-wins; the loser is cancelled via the cancel
        verb (engine freed within a step) and its straggling output is
        suppressed here (``fleet_hedge_dup_tokens_suppressed_total``)
        so the consumer-side exactly-once guard
        (``fleet_dup_tokens_suppressed_total``) still reads 0.

        Claim accounting: the primary's placement claim belongs to
        stream()'s finally (hedged or not); the hedge feeder owns and
        releases its own claim. The hedge-budget slot is released in
        this generator's finally — exactly once per fired hedge."""
        q = queue.Queue()
        n = len(out)
        got_any = False
        srcs = {0: (name, handle)}
        _PumpFeeder(self, 0, name, handle, snap, n, q, owns_claim=False)
        hedge_fired = False
        hedge_claimed = False
        t_fire = None
        winner = None   # None = race open; before the hedge fires the
        #                 primary is the only runner, so "open" is fine
        live = {0}
        try:
            while True:
                timeout = None
                if not hedge_fired:
                    timeout = self._hedge_wait(first=not got_any)
                try:
                    kind, tag, a, b = q.get(timeout=timeout)
                except queue.Empty:
                    # watchdog: the primary is alive (no error item)
                    # but silent past the adaptive wait — hedge once
                    hedge_fired = True
                    fired = self._fire_hedge(name, trace, tenant,
                                             snapshot, n, q)
                    if fired is not None:
                        hname, hhandle, _ = fired
                        srcs[1] = (hname, hhandle)
                        live.add(1)
                        hedge_claimed = True
                        t_fire = time.perf_counter()
                    continue
                if winner is not None and tag != winner:
                    continue        # loser's stale output post-cancel
                if kind == "tok":
                    cursor, tok = a, b
                    if cursor < n:
                        _C_HEDGE_DUP.inc()   # the race's own dedup —
                        continue             # never the consumer guard
                    if winner is None and len(live) > 1:
                        # first NEW token decides the race
                        winner = tag
                        loser = 1 - tag
                        lname = srcs[loser][0]
                        if tag == 1:
                            _C_HEDGE_WINS.inc()
                            # the winner is the hedge: re-aim the
                            # abandoned-stream/explicit cancel path
                            self._placements[trace] = srcs[tag]
                            _TR.record_span(
                                "hedge", t_fire, trace=trace,
                                primary=name, hedge=srcs[tag][0],
                                won=True)
                        elif t_fire is not None:
                            _TR.record_span(
                                "hedge", t_fire, trace=trace,
                                primary=name, hedge=lname, won=False)
                        _EVENTS.record("fleet_hedge_resolved",
                                       trace=trace, winner=srcs[tag][0],
                                       loser=lname, hedge_won=tag == 1)
                        self._cancel_async(lname, srcs[loser][1], trace,
                                           reason="hedge_loser")
                        live.discard(loser)
                    got_any = True
                    self._note_progress(srcs[tag][0])
                    n += 1
                    yield cursor, tok
                elif kind == "end":
                    if winner is None and len(live) > 1:
                        # a runner finished without a NEW token (the
                        # journal was already complete server-side):
                        # settle for it and cancel the other
                        winner = tag
                        loser = 1 - tag
                        self._cancel_async(srcs[loser][0],
                                           srcs[loser][1], trace,
                                           reason="hedge_loser")
                        live.discard(loser)
                    return
                else:           # "err" — a, the exception, b is None
                    live.discard(tag)
                    if winner is None and live:
                        # the race survives: the OTHER runner is still
                        # pumping (e.g. the primary died after the
                        # hedge fired) — a dead runner loses by default
                        winner = next(iter(live))
                        if winner == 1:
                            _C_HEDGE_WINS.inc()
                            self._placements[trace] = srcs[winner]
                            if t_fire is not None:
                                _TR.record_span(
                                    "hedge", t_fire, trace=trace,
                                    primary=name,
                                    hedge=srcs[winner][0], won=True)
                        continue
                    # the (decided or only) runner raised: relay, with
                    # the ACTUAL culprit attached so stream()'s death
                    # verdict lands on the right replica
                    e = a
                    try:
                        e.replica_name = srcs[tag][0]
                    except Exception:  # noqa: BLE001 — builtin excs
                        pass           # without a __dict__: verdict
                    #                    falls back to the primary
                    raise e
        finally:
            if hedge_claimed:
                with self._lock:
                    self._hedges_active -= 1

    def _cancel_async(self, name, handle, trace, reason=None):
        """_cancel_on from a daemon thread: the race's winner path must
        NEVER wait on the loser to deliver its token — a cancel verb
        aimed at a browned-out replica blocks on the very step lock
        whose slowness the hedge just escaped (the engine admits
        cancels between steps), which would re-couple the client's
        TTFT to the straggler."""
        threading.Thread(target=self._cancel_on,
                         args=(name, handle, trace, reason),
                         daemon=True,
                         name=f"cancel:{name}").start()

    def _cancel_on(self, name, handle, trace, reason=None):
        """Cancel `trace` on a specific replica (the hedge loser) —
        best-effort; the loser may already have finished or died."""
        cancel_fn = getattr(handle, "cancel", None)
        if cancel_fn is None:
            return
        _C_CANCELS_SENT.inc()
        try:
            try:
                cancel_fn(trace, reason=reason)
            except TypeError:   # an older handle: no reason kwarg
                cancel_fn(trace)
        except Exception as e:  # noqa: BLE001
            _EVENTS.record("fleet_cancel_failed", trace=trace,
                           replica=name,
                           error=f"{type(e).__name__}: {str(e)[:120]}")

    # -- the request surface ----------------------------------------------
    def stream(self, prompt, max_new_tokens=32, temperature=0.0,
               eos_token_id=None, priority=0, slo_ms=None,
               trace_id=None, tenant=None, deadline_ms=None):
        """Yield generated token ids, surviving replica death: see the
        module docstring for the failover state machine. The request is
        assigned a fleet-wide trace id HERE (router admission)
        unless the caller threads one in; the id rides the sequence
        snapshot to every replica it is placed on, so the per-process
        span timelines merge into one request trace
        (tools/trace_report.py). `tenant` attributes the request's
        latency sketches, SLO grades, and any shed to its owner
        With an admission_budget armed, an over-budget
        admission raises RequestShedError here — accounted, traced,
        and before any replica work. `deadline_ms` is the request's
        END-TO-END budget: minted here at admission (or
        derived as slo_ms * deadline_from_slo when armed), it rides
        the snapshot to every placement and is enforced at engine step
        boundaries — an expired request frees its slot and pages
        immediately and this stream raises DeadlineExceededError,
        accounted as its own outcome."""
        base = [int(t) for t in np.asarray(
            getattr(prompt, "numpy", lambda: prompt)()).reshape(-1)]
        if not base:
            raise ValueError("empty prompt")
        tenant = _TR.sanitize_tenant(tenant)   # one canonical value in
        #                                        every sketch name,
        #                                        label, and merge key
        if deadline_ms is None and self.deadline_from_slo is not None \
                and slo_ms is not None:
            deadline_ms = float(slo_ms) * self.deadline_from_slo
        if deadline_ms is not None:
            deadline_ms = float(deadline_ms)
        out = []                       # the journal: delivered tokens
        t_submit = time.perf_counter()
        ttft = None
        _C_REQS.inc()
        trace = trace_id or _TR.new_trace_id()
        t_detect = None                # set while a failover is pending
        n_reroutes = 0

        # the overload contract's front door: admit-or-shed is atomic
        # under the router lock (a concurrent burst can never observe
        # the same depth and all squeeze in); everything after this
        # point is an ADMITTED request — replica death reroutes it,
        # the budget never touches it again
        with self._lock:
            depth = self._admitted
            shed = (self.admission_budget is not None
                    and depth >= self.admission_budget)
            if not shed:
                self._admitted += 1
        if shed:
            _shed_counter("capacity", tenant).inc()
            _EVENTS.record("shed", trace=trace, tenant=tenant,
                           reason="capacity", depth=depth,
                           budget=self.admission_budget)
            _TR.record_span("request", t_submit, trace=trace,
                            tenant=tenant, tokens=0, reroutes=0,
                            outcome="shed")
            raise RequestShedError(
                f"admission shed: {depth} requests in flight >= "
                f"admission_budget {self.admission_budget} "
                f"(tenant={tenant!r})", reason="capacity",
                tenant=tenant, depth=depth,
                budget=self.admission_budget)

        def snapshot():
            return make_sequence_snapshot(
                base + out, prompt0=len(base),
                remaining=int(max_new_tokens) - len(out),
                temperature=temperature, eos_token_id=eos_token_id,
                priority=priority, slo_ms=slo_ms,
                age_s=time.perf_counter() - t_submit, ttft_s=ttft,
                trace=trace, tenant=tenant, deadline_ms=deadline_ms)

        outcome = "abandoned"   # overwritten by completion/failure; a
        #                         consumer closing the generator early
        #                         (its own timeout) leaves this — the
        #                         tail the percentiles exist to expose
        #                         must not vanish from the books

        def finish():
            # consumer-side accounting: what the USER experienced,
            # reroute stalls included — the fleet_* sketches next to the
            # replicas' engine-side ttft/tpot/e2e. Runs for EVERY
            # outcome (the closing `request` span makes abandoned and
            # failed streams visible in trace_report); only completed
            # requests feed the latency sketches — a stream cut short
            # has no honest e2e/tpot, it has a count
            # (fleet_requests_abandoned_total / _failed_total).
            now = time.perf_counter()
            if outcome == "completed":
                _TR.observe("fleet_e2e", now - t_submit, tenant=tenant)
                _TR.check_slo("fleet_e2e", now - t_submit, trace=trace,
                              tenant=tenant)
                if ttft is not None and len(out) > 1:
                    _TR.observe("fleet_tpot",
                                (now - t_submit - ttft) / (len(out) - 1),
                                tenant=tenant)
            elif outcome == "abandoned":
                _C_ABANDONED.inc()
            _TR.record_span("request", t_submit, now, trace=trace,
                            tenant=tenant, tokens=len(out),
                            reroutes=n_reroutes, outcome=outcome)

        def journal_complete():
            return len(out) >= max_new_tokens or (
                eos_token_id is not None and out
                and out[-1] == eos_token_id)

        carry_snap = None   # drain handoff: the exported snapshot
        #                     (undelivered generated tokens included —
        #                     they REPLAY on the new placement instead
        #                     of being recomputed)
        carry_kv = None     # (src_name, meta, payload) pages owed to
        #                     the next placement
        hop_src = None      # (name, handle) prefill replica owed a
        #                     prefill->decode page handoff
        try:
            while True:
                if journal_complete():
                    _C_DONE.inc()
                    outcome = "completed"
                    return
                # role-split fleets: the first token comes
                # from a compute-bound prefill replica, everything after
                # from a bandwidth-bound decode replica; untagged fleets
                # leave role=None and behave exactly as before
                role = None
                if self._role_split:
                    role = "prefill" if ttft is None else "decode"
                try:
                    name, handle = self._place(base + out, claim=True,
                                               role=role)
                except NoLiveReplicaError:
                    outcome = "failed"
                    _C_FAILED.inc()
                    _EVENTS.record("fleet_request_failed", trace=trace,
                                   delivered=len(out))
                    raise
                self._placements[trace] = (name, handle)
                self._note_progress(name)
                if hop_src is not None and hop_src[0] != name:
                    # prefill->decode handoff: move the prompt's pages
                    # as bytes so the decode replica maps them instead
                    # of re-prefilling the whole prompt
                    got = self._export_handoff_kv(
                        hop_src[0], hop_src[1], base + out, trace)
                    if got is not None:
                        carry_kv = (hop_src[0],) + got
                    _C_HANDOFF.inc()
                    _EVENTS.record("fleet_prefill_handoff", trace=trace,
                                   src=hop_src[0], dst=name,
                                   transferred=got is not None)
                hop_src = None
                if carry_kv is not None:
                    src_name, meta, payload = carry_kv
                    carry_kv = None
                    self._import_kv_into(name, handle, meta, payload,
                                         trace, src_name=src_name)
                snap = carry_snap if carry_snap is not None \
                    else snapshot()
                carry_snap = None
                if role == "prefill":
                    # the prefill replica computes the prompt's KV and
                    # the FIRST token only (TTFT is its product); the
                    # decode hop takes the rest
                    snap = dict(snap,
                                remaining=min(1, int(snap["remaining"])))
                drained_mid = False
                try:
                    if self.hedge is None:
                        pump = handle.submit(snap, start=len(out))
                    else:
                        # hedged re-placement: same
                        # (cursor, token) surface, but a progress
                        # watchdog may race a second replica against
                        # this one — first-new-token-wins, loser
                        # cancelled, duplicates suppressed inside
                        pump = self._pump_hedged(name, handle, snap,
                                                 out, trace, tenant,
                                                 snapshot)
                    for cursor, tok in pump:
                        if cursor < len(out):
                            _C_DUP.inc()          # exactly-once guard
                            continue
                        out.append(int(tok))
                        if self.hedge is None:
                            self._note_progress(name)
                        #   (hedged pumps stamp their own source —
                        #    a hedge's token must not vouch for the
                        #    straggling primary)
                        if ttft is None:
                            ttft = time.perf_counter() - t_submit
                            _TR.observe("fleet_ttft", ttft,
                                        tenant=tenant)
                            _TR.check_slo("fleet_ttft", ttft,
                                          trace=trace, target_ms=slo_ms,
                                          tenant=tenant)
                        if t_detect is not None:
                            now_rec = time.perf_counter()
                            _H_FAILOVER.observe(now_rec - t_detect)
                            _TR.record_span("reroute", t_detect,
                                            now_rec, trace=trace,
                                            replica=name,
                                            resumed_at=len(out) - 1)
                            t_detect = None
                        _C_TOKENS.inc()
                        yield int(tok)
                        if name in self._draining \
                                and not journal_complete() \
                                and any(n not in self._draining
                                        for n in self.usable_replicas()):
                            # drain handoff: export the sequence (state
                            # + KV pages) from the still-alive source
                            # BEFORE letting go of the pump, then
                            # re-place with the bytes riding along
                            carry_snap, carry_kv_got = \
                                self._drain_export(name, handle, trace)
                            if carry_kv_got is not None:
                                carry_kv = (name,) + carry_kv_got
                            drained_mid = True
                            break
                    if drained_mid:
                        try:
                            pump.close()
                        except Exception:  # noqa: BLE001
                            pass
                        n_reroutes += 1
                        _EVENTS.record(
                            "fleet_reroute", replica=name, trace=trace,
                            delivered=len(out), reason="drain",
                            remaining=max_new_tokens - len(out),
                            transferred=carry_snap is not None)
                    elif role == "prefill" and not journal_complete():
                        hop_src = (name, handle)
                    # stream ended NORMALLY — but only the loop-top
                    # budget/EOS check decides "completed": an
                    # engine-side early retirement (remove_request
                    # drain: "a lingering stream sees EOS") ends the
                    # replica stream short, and the journaled sequence
                    # must re-place, not silently truncate the
                    # consumer's answer
                    continue
                except (ReplicaDeadError, ConnectionError, OSError) as e:
                    if t_detect is None:
                        t_detect = time.perf_counter()
                    culprit = getattr(e, "replica_name", name)
                    if culprit != name:
                        # a hedged pump attributes the death to the
                        # replica that actually raised (the hedge
                        # winner may not be the primary placement)
                        self.mark_dead(culprit, str(e))
                    elif self._replicas.get(name) is handle:
                        # the death verdict belongs to the INCARNATION
                        # this stream was pumping: if a supervisor
                        # already replaced it under the same name, the
                        # successor is innocent — marking the name dead
                        # here would kill the fresh replica and burn
                        # its restart budget on our stale error
                        self.mark_dead(name, str(e))
                    _C_REROUTED.inc()
                    n_reroutes += 1
                    _EVENTS.record("fleet_reroute", replica=name,
                                   trace=trace, delivered=len(out),
                                   remaining=max_new_tokens - len(out))
                    continue
                except DeadlineExceededError:
                    # the engine expired the request at a step boundary
                    # (slot + pages already freed): an ACCOUNTED
                    # outcome in its own bucket — not failed (nothing
                    # broke), not shed (it was admitted)
                    outcome = "deadline_exceeded"
                    _C_DEADLINE_X.inc()
                    _EVENTS.record("fleet_request_deadline_exceeded",
                                   replica=name, trace=trace,
                                   delivered=len(out),
                                   deadline_ms=deadline_ms)
                    raise
                except RequestCancelledError:
                    # someone cancelled the live placement (a second
                    # consumer path, an operator, a hedge loser whose
                    # stream we are) — accounted, never failed
                    outcome = "cancelled"
                    _C_CANCELLED.inc()
                    _EVENTS.record("fleet_request_cancelled",
                                   replica=name, trace=trace,
                                   delivered=len(out))
                    raise
                except Exception as e:
                    # NOT a death: a request the engine rejected (e.g.
                    # the sequence exceeds max_seq_len) or a worker-side
                    # engine error. Rerouting would recur on every peer,
                    # so the request fails — but it fails ACCOUNTED,
                    # inside the fleet contract's books, not as an
                    # escaped exception the zero-failed gauge never saw
                    outcome = "failed"
                    _C_FAILED.inc()
                    _EVENTS.record("fleet_request_failed", replica=name,
                                   trace=trace, delivered=len(out),
                                   error=f"{type(e).__name__}: "
                                         f"{str(e)[:160]}")
                    raise
                finally:
                    with self._lock:
                        if name in self._inflight:
                            self._inflight[name] -= 1
                        #   (a force-removed replica keeps its slot
                        #    entry for exactly this decrement; a
                        #    clean remove() only runs at 0)
        finally:
            if outcome == "abandoned" and trace in self._placements:
                # the consumer walked away mid-stream (its own timeout/
                # disconnect): propagate the cancel so the engine frees
                # the slot and pages within one step instead of
                # decoding to budget — the accounting bucket
                # stays "abandoned" (the consumer's verdict), the
                # engine-side teardown is the resource release
                self.cancel(trace, reason="abandoned")
            self._placements.pop(trace, None)
            with self._lock:
                self._admitted -= 1   # the budget's slot frees for ANY
                #                       outcome — a stuck decrement
                #                       would shed forever
            finish()    # every outcome — completion, failure, and the
            #             consumer abandoning the generator — closes the
            #             books (see the outcome note above)

    def generate(self, prompt, max_new_tokens=32, **kw):
        """Blocking convenience: the full generated token list."""
        return list(self.stream(prompt, max_new_tokens, **kw))

    def shutdown(self):
        self.stop()
        for h in self._replicas.values():
            try:
                h.shutdown()
            except Exception:  # noqa: BLE001
                pass
