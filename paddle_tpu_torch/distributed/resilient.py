"""Resilient training runtime — closes the detect→recover loop.

The reference stack treats failure as a first-class event: the comm-task
watchdog raises on per-collective timeouts (comm_task_manager.h:37), the
ElasticManager notices peer change via heartbeats (fleet/elastic/
manager.py:121), and the launcher restarts in place (--elastic_level 1).
Until now this repo only had the DETECTION half. This module supplies the
recovery half as one state machine:

    train step ──ok──────────────► periodic verified checkpoint
        │                          (checkpoint.save_checkpoint: crc32
        │                           shards + barrier + atomic LATEST)
        ├─non-finite loss/grads──► BadStepGuard: skip the update; after
        │                          N consecutive bad steps roll back to
        │                          the rolling in-memory host snapshot
        └─CommTimeoutError / ────► recover(): jittered-exponential
          peer death (elastic      backoff under a bounded restart
          heartbeat RESTART)       budget, then reload from
                                   checkpoint.find_latest_valid()
                                   (inline), or exit with a restart
                                   code so the elastic launcher
                                   re-execs the worker (process mode)

The counterpart of ``paddle_tpu/distributed/resilient.py``, with the
same state machine, counters (``resilient_*_total``), histograms and
``resilient_<event>`` events. In the port:

- checkpoints go through the port's ``distributed.checkpoint`` (the JAX
  package's file format; with ``world_size`` > 1 each save commits
  through its multi-host barrier), and a save runs under
  ``perf.phase_scope("checkpoint")``;
- the rolling snapshot is a host-memory copy (``_capture_state``) of the
  parameters and buffers, the optimizer's accumulators, masters and step,
  and the scaler's state; a rollback or a restore copies back INTO the
  live tensors (``copy_``), never rebinding them, since the optimizer and
  any captured graph hold references to them (a restore from a
  checkpoint loads into the same live tensors);
- ``run`` observes step N-1's loss (held as a device tensor) before step
  N dispatches, as the JAX loop does: the host read of a loss happens
  one step late, never right after its own step;
- the re-rendezvous and the peer watch are no-ops for one process and
  run over any store with ``add``/``get``/``set`` otherwise.
"""

from __future__ import annotations

import json
import math
import random
import sys
import time

import torch

from ..observability.metrics import REGISTRY as _REG
from ..observability.events import EVENTS as _EVENTS
from ..observability import flight_recorder as _flight
from ..observability import perf as _perf
from . import checkpoint as dck
from .watchdog import CommTimeoutError
from .fleet.elastic import ElasticStatus

__all__ = [
    "ResilientTrainer", "BadStepGuard", "PeerFailureError",
    "RestartBudgetExceededError", "CommTimeoutError", "run",
    "RESTART_EXIT_CODE",
]

# exit code a launcher-supervised worker uses to request an in-place
# elastic restart (paddle_tpu.distributed.launch --elastic_level 1
# restarts on ANY non-zero exit; a dedicated code keeps logs readable)
RESTART_EXIT_CODE = 23


class PeerFailureError(RuntimeError):
    """A peer worker died or stopped heartbeating (ElasticStatus.RESTART)."""


class RestartBudgetExceededError(RuntimeError):
    """Recovery was attempted more than max_restarts times."""


def _default_log(kind, **info):
    print(f"[resilient] {kind}: " +
          " ".join(f"{k}={v}" for k, v in info.items()),
          file=sys.stderr, flush=True)


# recovery telemetry: the fault state machine was stderr-only —
# these series make a preemption storm or a skipped-step streak visible
# without scraping logs, and every on_event also mirrors into the
# structured event log (kind "resilient_<event>") for the run report.
_C_FAULTS = _REG.counter("resilient_faults_total",
                         "faults entering the recovery state machine")
_C_RECOVERIES = _REG.counter("resilient_recoveries_total",
                             "inline recovery episodes (backoff + restore)")
_C_BADSTEPS = _REG.counter("resilient_bad_steps_total",
                           "non-finite steps skipped by BadStepGuard")
_C_ROLLBACKS = _REG.counter("resilient_rollbacks_total",
                            "snapshot rollbacks after a bad-step streak")
_G_BUDGET = _REG.gauge("resilient_restart_budget_remaining",
                       "restarts left in the current fault episode")
_H_RESTORE = _REG.histogram("resilient_restore_seconds",
                            "restore() wall time (find + load + apply)")
_H_RECOVERY = _REG.histogram(
    "resilient_recovery_seconds",
    "full recovery episode wall time (fault observed -> restored and "
    "ready to step): backoff + rerendezvous + restore",
    buckets=(0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0))


def _instrumented(on_event):
    """Wrap a user/stderr event sink so every resilient event ALSO lands
    in the observability event log."""
    if getattr(on_event, "_obs_wrapped", False):
        return on_event     # trainer hands its sink to the guard: no
        #                     double-recording

    def emit(kind, **info):
        _EVENTS.record(f"resilient_{kind}", **info)
        on_event(kind, **info)
    emit._obs_wrapped = True
    return emit


class _Backoff:
    """Jittered exponential backoff: min(cap, base*2^n) * (1 + U[0,jitter])
    — the jitter decorrelates simultaneous restarts across workers so a
    shared store/master is not thundering-herded after a cluster event."""

    def __init__(self, base=0.5, cap=30.0, jitter=0.5, seed=None):
        self.base, self.cap, self.jitter = base, cap, jitter
        self._n = 0
        self._rng = random.Random(seed)
        self.last_delay = 0.0

    def next_delay(self):
        d = min(self.cap, self.base * (2.0 ** self._n))
        self._n += 1
        d *= 1.0 + self._rng.uniform(0.0, self.jitter)
        self.last_delay = d
        return d

    def reset(self):
        self._n = 0


def _loss_value(loss):
    """The loss as a Python float (a host read: a sync on the card)."""
    try:
        if isinstance(loss, torch.Tensor):
            return float(loss.detach().float())
        return float(loss)
    except (TypeError, ValueError, RuntimeError):
        return float("nan")


def _host_copy(t):
    return t.detach().to("cpu", copy=True)


def _capture_state(model, optimizer=None, scaler=None):
    """Host-memory copy of everything a rollback must restore: params
    (and buffers), optimizer accumulators/masters/step, scaler state."""
    params = {k: _host_copy(t) for k, t in model.state_dict().items()
              if isinstance(t, torch.Tensor)}
    snap = {"params": params}
    if optimizer is not None:
        snap["opt_acc"] = {
            pid: {name: _host_copy(v) for name, v in accs.items()}
            for pid, accs in optimizer._accumulators.items()}
        snap["opt_master"] = {
            pid: _host_copy(v)
            for pid, v in optimizer._master_weights.items()}
        snap["opt_step"] = optimizer._step_count
    if scaler is not None:
        snap["scaler"] = dict(scaler.state_dict())
    return snap


def _copy_into(live, saved, device):
    """`saved` copied into the live tensor (same shape and type: in
    place), else a fresh copy on `device`."""
    if live is not None and live.shape == saved.shape and \
            live.dtype == saved.dtype:
        live.copy_(saved)
        return live
    return saved.to(device, copy=True)


@torch.no_grad()
def _apply_state(snap, model, optimizer=None, scaler=None):
    """Bit-exact restore of a _capture_state snapshot, into the live
    tensors. Optimizer state made after the snapshot is dropped (the next
    step starts it afresh, as from the snapshot's state)."""
    for k, t in model.state_dict().items():
        if isinstance(t, torch.Tensor) and k in snap["params"]:
            t.copy_(snap["params"][k])
    if optimizer is not None and "opt_acc" in snap:
        dev = {id(p): p.device for p in optimizer._parameter_list}
        accs = optimizer._accumulators
        for pid in [p for p in accs if p not in snap["opt_acc"]]:
            del accs[pid]
        for pid, saved in snap["opt_acc"].items():
            live = accs.setdefault(pid, {})
            for name, v in saved.items():
                live[name] = _copy_into(live.get(name), v,
                                        dev.get(pid, v.device))
        masters = optimizer._master_weights
        for pid in [p for p in masters if p not in snap["opt_master"]]:
            del masters[pid]
        for pid, v in snap["opt_master"].items():
            masters[pid] = _copy_into(masters.get(pid), v,
                                      dev.get(pid, v.device))
        optimizer._step_count = snap["opt_step"]
    if scaler is not None and "scaler" in snap:
        scaler.set_state_dict(snap["scaler"])


class BadStepGuard:
    """Non-finite step protection.

    Works with or without amp.GradScaler:

    - WITH a scaler, the scaler already skips optimizer.step() when
      unscale_ found inf/nan grads; the guard reads
      ``scaler.last_found_inf`` (which survives scaler.update()) and only
      counts the streak / decides rollback.
    - WITHOUT a scaler the update may have already applied non-finite
      grads by the time the loss is observed — which is exactly why the
      guard keeps a rolling HOST-MEMORY snapshot (params + optimizer
      accumulators/masters + scaler state) taken every ``snapshot_every``
      good steps: ``rollback()`` restores it bit-exactly.

    After ``max_consecutive_bad`` bad steps in a row the guard rolls back
    instead of letting a divergence corrupt the params for good.
    """

    def __init__(self, model, optimizer=None, scaler=None,
                 snapshot_every=10, max_consecutive_bad=3, on_event=None):
        self._model = model
        self._optimizer = optimizer
        self._scaler = scaler
        self.snapshot_every = max(1, int(snapshot_every))
        self.max_consecutive_bad = max(1, int(max_consecutive_bad))
        self._on_event = _instrumented(on_event or _default_log)
        self._snap = None
        self._snap_step = -1
        self._consecutive_bad = 0
        self.skipped = 0
        self.rollbacks = 0

    # -- snapshot --------------------------------------------------------
    def snapshot(self, step):
        """Host copy of everything a rollback must restore."""
        self._snap = _capture_state(self._model, self._optimizer,
                                    self._scaler)
        self._snap_step = step

    def maybe_snapshot(self, step):
        """Refresh the rolling snapshot every snapshot_every steps — but
        never mid-bad-streak: without a scaler the params may already
        hold a non-finite update, and snapshotting them would destroy
        the only clean restore point."""
        if self._consecutive_bad:
            return
        if self._snap is None or step - self._snap_step >= \
                self.snapshot_every:
            self.snapshot(step)

    @property
    def snapshot_step(self):
        return self._snap_step

    # -- observe/rollback ------------------------------------------------
    def observe(self, loss, step):
        """Classify the step just taken. Returns 'good', 'skipped', or
        'rolled_back'."""
        lv = _loss_value(loss)
        bad = not math.isfinite(lv)
        if self._scaler is not None and \
                getattr(self._scaler, "last_found_inf", False):
            bad = True
        if not bad:
            self._consecutive_bad = 0
            return "good"
        self.skipped += 1
        _C_BADSTEPS.inc()
        self._consecutive_bad += 1
        self._on_event("bad_step", step=step, loss=lv,
                       consecutive=self._consecutive_bad)
        if self._consecutive_bad >= self.max_consecutive_bad and \
                self._snap is not None:
            self.rollback()
            self._consecutive_bad = 0
            return "rolled_back"
        return "skipped"

    def rollback(self):
        """Restore params/optimizer/scaler from the snapshot, bit-exact."""
        if self._snap is None:
            raise RuntimeError("BadStepGuard has no snapshot to roll back "
                               "to — call snapshot()/maybe_snapshot first")
        _apply_state(self._snap, self._model, self._optimizer, self._scaler)
        self.rollbacks += 1
        _C_ROLLBACKS.inc()
        self._on_event("rollback", to_step=self._snap_step,
                       rollbacks=self.rollbacks)


class ResilientTrainer:
    """Auto-resume loop: wraps a train loop with
    periodic verified checkpoints, converts watchdog timeouts and peer
    death into recovery, and guards against non-finite steps.

        trainer = ResilientTrainer(model, optimizer, ckpt_root=root,
                                   scaler=scaler, ckpt_every=25)
        trainer.run(step_fn, total_steps)   # step_fn(step) -> loss

    ``recover`` selects the fault policy:
      - "inline"  (default): backoff + reload-from-latest-valid in
        process, bounded by ``max_restarts`` (transient wedges).
      - "exit": drain async saves and sys.exit(RESTART_EXIT_CODE) so the
        elastic launcher re-execs the worker (a restarted process calls
        restore() and resumes — the e2e kill→resume path).
      - "raise": propagate to the caller.
    """

    def __init__(self, model, optimizer=None, *, ckpt_root, scaler=None,
                 ckpt_every=25, keep_last_n=3, async_save=False,
                 max_restarts=3, backoff_base=0.5, backoff_cap=30.0,
                 backoff_jitter=0.5, snapshot_every=10,
                 max_consecutive_bad=3, guard=True, elastic=None,
                 store=None, rank=0, world_size=1, recover="inline",
                 barrier_timeout=120.0, on_event=None, backoff_seed=None,
                 doctor=True):
        if recover not in ("inline", "exit", "raise"):
            raise ValueError(f"recover must be inline/exit/raise, "
                             f"got {recover!r}")
        self._model = model
        self._optimizer = optimizer
        self._scaler = scaler
        self._root = ckpt_root
        self.ckpt_every = max(1, int(ckpt_every))
        self.keep_last_n = keep_last_n
        self.async_save = async_save
        self.max_restarts = int(max_restarts)
        self.recover = recover
        self._elastic = elastic
        self._store = store
        self._rank = rank
        self._world = world_size
        self._barrier_timeout = barrier_timeout
        self._on_event = _instrumented(on_event or _default_log)
        self._backoff = _Backoff(backoff_base, backoff_cap, backoff_jitter,
                                 seed=backoff_seed)
        self.restarts_used = 0
        _G_BUDGET.set(self.max_restarts)   # a fresh trainer has its full
        #                                    budget; 0 must mean exhausted
        self._good_since_fault = 0
        self._last_watch = 0.0
        # restore lineage: step of the checkpoint the current params came
        # from (-1 = the initial state captured below). Scopes the commit
        # barrier so a re-save of a step after a rewind cannot be
        # satisfied by a peer's stale progress post from the aborted
        # attempt of that same step. If a SINGLE rank restores inline
        # (rank-local fault) the lineages diverge and the coordinator's
        # next commit barrier times out — that timeout is itself a fault,
        # so the coordinator restores from the same committed LATEST and
        # the tags re-converge after one barrier_timeout cycle.
        self._lineage = -1
        # initial-state snapshot: restore() with NO valid checkpoint must
        # mean "back to step 0's actual state", not "keep whatever
        # partially-trained/faulted params are live and call them step 0"
        self._init_snap = _capture_state(model, optimizer, scaler)
        self.guard = BadStepGuard(
            model, optimizer, scaler, snapshot_every=snapshot_every,
            max_consecutive_bad=max_consecutive_bad,
            on_event=self._on_event) if guard else None
        # fleet doctor, training home: a streaming detector
        # sweep baselined at run() start; every recovery episode and
        # rollback gets a diagnosis event naming coincident anomalies
        self._use_doctor = bool(doctor)
        self._doctor = None

    def _diagnose(self, context, **info):
        """One doctor sweep + a per-episode ``diagnosis`` event (see
        observability/doctor.py). Never raises: diagnosis is evidence,
        not a recovery step."""
        if self._doctor is None:
            return
        try:
            self._doctor.diagnose_episode(context, **info)
        except Exception as e:  # noqa: BLE001
            self._on_event("diagnosis_failed", error=str(e)[:120])

    # -- state (de)assembly ---------------------------------------------
    def _opt_template(self):
        """optimizer.state_dict() with accumulators/masters FORCED into
        existence: a freshly-built optimizer has no state yet, and a
        template without those keys would silently drop the saved Adam
        moments on restore."""
        opt = self._optimizer
        for p in opt._parameter_list:
            opt._state_of(p)
            opt._get_master(p)
        return opt.state_dict()

    def _state_template(self, next_step=0):
        sd = {}
        for k, t in self._model.state_dict().items():
            sd[f"model::{k}"] = t
        if self._optimizer is not None:
            osd = self._opt_template()
            lr_state = osd.pop("LR_Scheduler", None)
            for k, v in osd.items():
                sd[f"opt::{k}"] = v
            if lr_state is not None:
                sd["opt::LR_Scheduler@json"] = json.dumps(lr_state)
        if self._scaler is not None:
            sd["scaler@json"] = json.dumps(self._scaler.state_dict())
        sd["resilient::step"] = int(next_step)
        sd["resilient::world"] = int(self._world)
        return sd

    def save(self, step):
        """Checkpoint after completing `step` (resume target step+1)."""
        sd = self._state_template(next_step=step + 1)
        # checkpoint time is a named goodput phase: when a StepTimer has a
        # step open, the save's wall time attributes to it
        with _perf.phase_scope("checkpoint"):
            h = dck.save_checkpoint(
                sd, self._root, step, async_save=self.async_save,
                keep_last_n=self.keep_last_n, store=self._store,
                world_size=self._world, rank=self._rank,
                barrier_timeout=self._barrier_timeout,
                barrier_tag=f"r{self._lineage}")
        self._on_event("checkpoint", step=step,
                       dir=dck.checkpoint_dir(self._root, step),
                       **{"async": self.async_save})
        return h

    def restore(self):
        """Reload from the newest VALID checkpoint (corrupt/partial dirs
        are skipped — checkpoint.find_latest_valid). Returns the step to
        resume from (0 when no checkpoint exists). Loading reshards
        automatically if the device count changed since the save."""
        with _H_RESTORE.time():
            return self._restore_impl()

    def _restore_impl(self):
        # multi-host: only a BARRIER-COMMITTED checkpoint (<= LATEST) is a
        # legal restore point — a newer dir that looks valid locally may
        # be missing peer shards, and resuming from it would desync the
        # survivors from the cluster's agreed step
        found = dck.find_latest_valid(self._root,
                                      committed_only=self._world > 1)
        if found is None:
            # no restore point: reset to the captured INITIAL state —
            # recovery before the first checkpoint must not silently
            # "resume" step 0 with partially-trained (or fault-corrupted)
            # live params and stale optimizer moments
            _apply_state(self._init_snap, self._model, self._optimizer,
                         self._scaler)
            self._lineage = -1
            self._on_event("restored_initial", next_step=0)
            if self.guard is not None:
                self.guard.snapshot(0)
            return 0
        ckpt_step, path = found
        tmpl = self._state_template()
        # the template holds the live parameters and optimizer state, so
        # the load copies into them in place; what is left to set are the
        # optimizer's scalars
        dck.load_state_dict(tmpl, path, verify=False)   # just verified
        if self._optimizer is not None:
            opt = self._optimizer
            opt._step_count = int(tmpl.get("opt::@step", opt._step_count))
            lr_json = tmpl.get("opt::LR_Scheduler@json")
            if isinstance(lr_json, str) and lr_json and \
                    opt._lr_scheduler is not None:
                opt._lr_scheduler.set_state_dict(json.loads(lr_json))
        scaler_json = tmpl.get("scaler@json")
        if self._scaler is not None and isinstance(scaler_json, str) \
                and scaler_json:
            self._scaler.set_state_dict(json.loads(scaler_json))
        next_step = int(tmpl.get("resilient::step", 0))
        self._lineage = ckpt_step
        self._on_event("restored", ckpt_step=ckpt_step, next_step=next_step,
                       path=path,
                       saved_world=tmpl.get("resilient::world"))
        if self.guard is not None:
            self.guard.snapshot(next_step)   # clean restore point
        return next_step

    # -- fault handling ---------------------------------------------------
    def _handle_fault(self, exc):
        _C_FAULTS.inc()
        self._on_event("fault", type=type(exc).__name__,
                       error=str(exc)[:200])
        # flight-recorder evidence BEFORE recovery mutates anything: a
        # CommTimeoutError's watchdog path already dumped, but peer-death
        # and store faults reach here without one (dump() is idempotent —
        # a second write just refreshes the same flight_<rank>.json)
        _flight.dump_active(reason=f"fault:{type(exc).__name__}")
        # the budget-decay counter counts good steps SINCE the last
        # fault: without this reset it accumulates across episodes and
        # one good step between recurring faults would reset the budget
        # forever, hiding a persistent fault behind an infinite
        # backoff loop
        self._good_since_fault = 0
        try:
            dck.wait_async_save()
        except Exception as e:   # a failed save must not block recovery
            self._on_event("async_save_failed", error=str(e)[:200])
        if self.recover == "raise":
            raise exc
        if self.recover == "exit":
            self._on_event("exit_for_restart", code=RESTART_EXIT_CODE)
            sys.exit(RESTART_EXIT_CODE)
        self.restarts_used += 1
        _C_RECOVERIES.inc()
        _G_BUDGET.set(max(0, self.max_restarts - self.restarts_used))
        if self.restarts_used > self.max_restarts:
            raise RestartBudgetExceededError(
                f"recovery attempted {self.restarts_used} times "
                f"(budget {self.max_restarts}); last fault: "
                f"{type(exc).__name__}: {exc}") from exc
        delay = self._backoff.next_delay()
        self._on_event("backoff", attempt=self.restarts_used,
                       delay=round(delay, 3))
        time.sleep(delay)
        self._rerendezvous()
        # inline recovery committed: reset the flight ring so this
        # episode's pending entries (dumped above) can't masquerade as
        # in-flight ops in the NEXT post-mortem
        _flight.clear_active()

    def _rerendezvous(self):
        """Best-effort elastic re-rendezvous after an inline fault: wait
        for every live rank to arrive at a shared barrier so survivors
        resume from the SAME checkpoint instead of racing ahead.

        The generation is the step of the committed LATEST pointer, read
        from the SHARED checkpoint root — ranks recovering from the same
        cluster event observe the same value (LATEST cannot advance while
        the coordinator is itself recovering), unlike any locally-counted
        ordinal, which diverges as soon as one rank has had a private
        transient fault. The barrier is an optimization, not a safety
        requirement (restore() takes only committed checkpoints), so on
        timeout we log and proceed rather than killing a job whose peers
        are merely slow. For the same reason the arrived counter is not
        cleared between episodes: a second fault at the same generation
        finds it already satisfied and proceeds straight to restore —
        the safe direction (the wait is purely a stampede dampener)."""
        if self._store is None or self._world <= 1:
            return
        latest = dck.read_latest(self._root)
        gen = latest[0] if latest is not None else -1
        arrived_key = f"resilient/gen/{gen}/arrived"
        try:
            self._store.add(arrived_key, 1)
            deadline = time.monotonic() + self._barrier_timeout
            while self._store.add(arrived_key, 0) < self._world:
                if time.monotonic() > deadline:
                    self._on_event(
                        "rerendezvous_timeout", generation=gen,
                        arrived=self._store.add(arrived_key, 0),
                        world=self._world)
                    return
                time.sleep(0.05)
        except (ConnectionError, OSError) as e:   # store still down
            self._on_event("rerendezvous_skipped", error=str(e)[:120])
            return
        self._on_event("rerendezvous", generation=gen, world=self._world)

    def _check_peers(self):
        """Poll the elastic watch, at most once per heartbeat interval:
        the verdict cannot change faster than peers beat, and a watch
        pass costs (world-1) blocking store gets — per-step polling would
        put the network on the training hot path (and a briefly-stalled
        store would stall the loop it is supposed to protect)."""
        if self._elastic is None:
            return
        now = time.monotonic()
        interval = getattr(self._elastic, "_interval", 1.0)
        if now - self._last_watch < interval:
            return
        self._last_watch = now
        status = self._elastic.watch()
        if status == ElasticStatus.RESTART:
            raise PeerFailureError(
                "elastic heartbeat watch reported a dead/failed peer")

    # -- the loop ---------------------------------------------------------
    def _should_ckpt(self, step, total_steps):
        return (step + 1) % self.ckpt_every == 0 or step == total_steps - 1

    def _after_good_step(self, step, total_steps):
        self._backoff.reset()
        # restart-budget decay: the budget bounds retries per fault
        # EPISODE, not per job lifetime — a full checkpoint period of
        # healthy steps closes the episode, so isolated transient faults
        # days apart on a long run can't accumulate into a fatal
        # RestartBudgetExceededError
        self._good_since_fault += 1
        if self.restarts_used and \
                self._good_since_fault >= self.ckpt_every:
            self._on_event("budget_reset",
                           after_good_steps=self._good_since_fault)
            self.restarts_used = 0
            _G_BUDGET.set(self.max_restarts)
        if self._should_ckpt(step, total_steps):
            self.save(step)

    def run(self, step_fn, total_steps, start_step=None):
        """Drive step_fn(step)->loss from the latest valid checkpoint (or
        start_step) to total_steps, recovering per the policy. Returns the
        number of steps completed in THIS process life.

        With the guard enabled, step N-1's loss is observed while step N
        dispatches (one step deferred): forcing the device->host loss
        sync inline every step would serialize the card's asynchronous
        launches on the hot path. The deferral costs at most one extra bad update
        before a skip/rollback decision — the rolling snapshot covers it.
        """
        step = self.restore() if start_step is None else start_step
        if self._use_doctor and self._doctor is None:
            try:
                from ..observability.doctor import Doctor
                self._doctor = Doctor(name="trainer")
                self._doctor.observe()       # baseline window
            except Exception:  # noqa: BLE001 — telemetry-optional
                self._doctor = None
        completed = 0
        pending = None               # (loss, step) awaiting observation
        while step < total_steps:
            try:
                self._check_peers()
                if pending is not None:
                    p_loss, p_step = pending
                    pending = None
                    verdict = self.guard.observe(p_loss, p_step)
                    if verdict == "good":
                        self._after_good_step(p_step, total_steps)
                    elif verdict == "rolled_back":
                        self._diagnose("rollback", step=p_step)
                if self.guard is not None:
                    self.guard.maybe_snapshot(step)
                loss = step_fn(step)
                if self.guard is None:
                    self._after_good_step(step, total_steps)
                else:
                    pending = (loss, step)
            # TimeoutError: a wedged store key or a commit barrier whose
            # peer died mid-save; ConnectionError: the rendezvous store
            # went away (its master host is restarting in place) — same
            # recovery as a comm timeout
            except (CommTimeoutError, PeerFailureError, TimeoutError,
                    ConnectionError) as e:
                t_fault = time.monotonic()
                self._handle_fault(e)        # raises in exit/raise modes
                pending = None               # replayed from the ckpt
                step = self.restore()
                # episode closed: one structured event carries what the
                # per-fault counters cannot — how long detect->ready
                # took and how much restart budget this episode left
                # (obs_report's recovery timeline summarizes these)
                duration = time.monotonic() - t_fault
                _H_RECOVERY.observe(duration)
                self._on_event(
                    "recovery_complete",
                    duration_s=round(duration, 3),
                    fault=type(e).__name__, resume_step=step,
                    attempt=self.restarts_used,
                    restart_budget_remaining=max(
                        0, self.max_restarts - self.restarts_used))
                self._diagnose(f"fault:{type(e).__name__}",
                               resume_step=step,
                               duration_s=round(duration, 3))
                continue
            step += 1
            completed += 1
        if pending is not None:              # flush the final deferred step
            p_loss, p_step = pending
            if self.guard.observe(p_loss, p_step) == "good":
                self._after_good_step(p_step, total_steps)
        dck.wait_async_save()
        return completed


def run(step_fn, *, model, optimizer=None, ckpt_root, total_steps, **kw):
    """Functional entry: resilient.run(step_fn, model=..., optimizer=...,
    ckpt_root=..., total_steps=N) — builds a ResilientTrainer and drives
    the loop under its recovery state machine."""
    trainer = ResilientTrainer(model, optimizer, ckpt_root=ckpt_root, **kw)
    trainer.run(step_fn, total_steps)
    return trainer
