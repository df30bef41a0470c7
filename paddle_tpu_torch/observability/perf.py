"""Step-scope performance accounting: phase attribution, goodput, MFU.

The counterpart of ``paddle_tpu/observability/perf.py``, with the same
phases, series and arithmetic, so one dashboard and
``tools/obs_report.py`` read both packages. The goodput-accounting line
of work (PAPERS.md) answers "where did the step's wall time go" with a
small fixed vocabulary of phases:

- ``data_wait``   — blocked on the input pipeline (``io.DataLoader``
                    feeds this automatically via ``note()`` when a timer
                    is active),
- ``dispatch``    — host-side work launching the step (the Python of the
                    eager forward, backward and update, and the CUDA
                    launches it enqueues),
- ``compute``     — device execution, measured at a real synchronisation
                    point: the loss's ``.item()``, ``float(loss)``, an
                    event's ``synchronize()`` or
                    ``torch.cuda.synchronize()``,
- ``optimizer``   — eager ``Optimizer.step`` (``jit.compile_train_step``
                    folds the update into its own step, as the JAX
                    package's fused program folds it into ``compute``),
- ``checkpoint``  — resilient/checkpoint saves,
- ``other``       — whatever of the step wall the caller didn't annotate.

Per phase: a ``step_phase_seconds{phase=}`` histogram (one observation
per step, so phase sums reconstruct the wall-time split) plus the
``step_wall_seconds`` histogram. Derived gauges, updated live every step:

- ``perf_goodput`` — cumulative productive fraction: time in *productive*
  phases (default compute+dispatch) over total step wall. Checkpoint
  stalls, input starvation and unattributed overhead all pull it down.
- ``perf_mfu`` — model flops utilization: ``flops_per_step * steps /
  busy_seconds / peak_flops``, where busy is the sum of the productive
  phases (compute + dispatch). On the card the step is eager and
  asynchronous: dispatch is the host's launch time and compute the wait
  at the sync for the rest of the device's work, so busy is the step's
  wall less the unproductive phases. A step timed without a sync inside
  a phase measures only launches in ``dispatch`` and leaves the device
  work to whatever waits next (``other``, or the next step), and
  ``perf_mfu`` then reads far too high. On the CPU the work lands inside
  the call, i.e. in ``dispatch``. ``flops_per_step`` comes either from
  the caller or from a program counted in observability/xla_introspect.py
  (``program="train_step"``); peak flops from the table below.

Stdlib-only by design (the fake-clock tests and the import graph both
need it); torch is only touched lazily for platform detection.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

from .metrics import REGISTRY as _REG, _ENABLED, DEFAULT_LATENCY_BUCKETS

__all__ = ["StepTimer", "phase_scope", "note", "current_timer",
           "peak_flops", "PEAK_FLOPS", "mfu", "goodput", "window_stats"]

# bf16 dense peak FLOP/s per device kind. "cpu" is a nominal 1 TFLOP/s so
# CPU smokes publish a finite, round-comparable (not absolute-meaningful)
# MFU — the same convention bench.py's analytic table uses. The TPU
# entries are the JAX package's; the H100's are the SXM card ("NVIDIA
# H100 80GB HBM3", 989 TFLOP/s) and the PCIe card ("NVIDIA H100 PCIe",
# 756 TFLOP/s).
PEAK_FLOPS = {
    # order matters: more-specific keys first (substring match against a
    # normalized device name like "tpuv5lite" / "nvidiah100pcie")
    "v5e": 197e12, "v5litepod": 197e12, "v5lite": 197e12, "v5p": 459e12,
    "v6e": 918e12, "v6lite": 918e12, "v4": 275e12,
    "h100pcie": 756e12, "h100": 989e12, "cpu": 1e12,
}

PRODUCTIVE_PHASES = ("compute", "dispatch")

_PHASE_BUCKETS = DEFAULT_LATENCY_BUCKETS


def peak_flops(platform=None):
    """Peak FLOP/s for a platform string ('h100', 'cpu', a device name
    like 'NVIDIA H100 80GB HBM3'); None detects from the local card
    (``torch.cuda.get_device_name()``), the nominal cpu entry without
    one."""
    if platform is None:
        try:
            import torch
            platform = torch.cuda.get_device_name() \
                if torch.cuda.is_available() else "cpu"
        except Exception:  # noqa: BLE001 — no backend: nominal cpu
            platform = "cpu"
    key = str(platform).lower().replace(" ", "")
    for k, v in PEAK_FLOPS.items():
        if k in key:
            return v
    return PEAK_FLOPS["cpu"]


def mfu(flops_per_step, steps, busy_seconds, peak):
    """steps * flops_per_step achieved over busy (device-compute + host
    dispatch) seconds, vs peak."""
    if not busy_seconds or not peak or not flops_per_step:
        return None
    return (float(flops_per_step) * steps / busy_seconds) / peak


def goodput(phase_totals, wall_seconds, productive=PRODUCTIVE_PHASES):
    if not wall_seconds:
        return None
    good = sum(phase_totals.get(p, 0.0) for p in productive)
    return min(1.0, good / wall_seconds)


# the active timer cell: DataLoader/Optimizer/checkpoint call sites
# attribute into the attached timer with a single list-index check when
# none is. A timer attaches at its first step() and STAYS attached after
# the step closes — the work these call sites measure (the loader pull in
# `for batch in loader:`, a checkpoint between steps) happens BETWEEN
# steps, and dropping it would silently hide exactly the input-starvation
# signal goodput exists to expose. Between-step attributions count toward
# cumulative phase AND wall totals (see StepTimer.add). detach() releases.
_ACTIVE = [None]


def current_timer():
    return _ACTIVE[0]


@contextmanager
def phase_scope(name):
    """Attribute a with-block to phase `name` of the active StepTimer —
    no-op (one compare) when no timer is active. How subsystem call sites
    (optimizer.step, resilient.save, DataLoader) report without holding a
    timer reference."""
    t = _ACTIVE[0]
    if t is None:
        yield
        return
    with t.phase(name):
        yield


def note(name, seconds):
    """Attribute already-measured seconds to phase `name` of the active
    timer (no-op when none). For call sites that measured anyway
    (DataLoader's wait histogram)."""
    t = _ACTIVE[0]
    if t is not None:
        t.add(name, seconds)


class StepTimer:
    """Train/serve step-scope wall-time attribution.

        timer = perf.StepTimer(program="train_step")
        for batch in loader:                  # data_wait auto-attributed
            with timer.step():
                with timer.phase("dispatch"):
                    loss = step(*batch)       # host half of the eager step
                with timer.phase("compute"):
                    float(loss)               # a real sync

    Every step-exit observes the per-phase histograms and refreshes the
    perf_goodput / perf_mfu gauges. `flops_per_step` may be given
    directly, or resolved from a registered program's counted analysis
    (`program=`, see xla_introspect) — resolution is a cached lookup each
    step; resolve_flops() also runs a pending registered thunk. `clock`
    is injectable for scripted tests.
    """

    def __init__(self, flops_per_step=None, program=None, peak=None,
                 platform=None, productive=PRODUCTIVE_PHASES,
                 clock=time.perf_counter):
        self.flops_per_step = flops_per_step
        self.program = program
        self.peak = peak if peak is not None else peak_flops(platform)
        self.productive = tuple(productive)
        self._clock = clock
        self._lock = threading.Lock()
        self._step_t0 = None
        self._step_phases = {}
        self.steps = 0
        self.wall_seconds = 0.0
        self.phase_seconds = {}
        self._hists = {}
        self._wall_hist = _REG.histogram(
            "step_wall_seconds", "per-step wall time",
            buckets=_PHASE_BUCKETS)
        self._g_goodput = _REG.gauge(
            "perf_goodput", "productive fraction of step wall time")
        self._g_mfu = _REG.gauge(
            "perf_mfu",
            "model flops utilization over productive (busy) step time")
        self._g_last = _REG.gauge("perf_last_step_seconds",
                                  "most recent step wall time")
        self._c_steps = _REG.counter("perf_steps_total",
                                     "steps accounted by StepTimer")

    def _hist(self, phase):
        h = self._hists.get(phase)
        if h is None:
            h = self._hists[phase] = _REG.histogram(
                "step_phase_seconds", "per-step wall time by phase",
                labels={"phase": phase}, buckets=_PHASE_BUCKETS)
        return h

    # -- recording -------------------------------------------------------
    @contextmanager
    def step(self):
        """One training/serving step; phases recorded inside attribute
        slices of its wall time. The timer stays attached (receiving
        between-step note()/phase_scope attributions — loader waits,
        checkpoints) after the step closes; a nested foreign timer is
        restored, and detach() releases explicitly."""
        prev = _ACTIVE[0]
        _ACTIVE[0] = self
        with self._lock:
            self._step_phases = {}
            self._step_t0 = self._clock()
        try:
            yield self
        finally:
            t1 = self._clock()
            # restore prev only for a genuinely nested step (prev still
            # has one open); a STALE attached timer is replaced, not
            # resurrected
            if prev is not None and prev is not self \
                    and prev._step_t0 is not None:
                _ACTIVE[0] = prev
            else:
                _ACTIVE[0] = self
            self._close_step(t1)

    def detach(self):
        """Stop receiving between-step attributions (note/phase_scope)."""
        if _ACTIVE[0] is self:
            _ACTIVE[0] = None

    @contextmanager
    def phase(self, name):
        t0 = self._clock()
        try:
            yield
        finally:
            self.add(name, self._clock() - t0)

    def add(self, name, seconds):
        """Attribute measured seconds to a phase (inside a step: counts
        toward that step; outside — a loader wait or checkpoint between
        steps: counts toward cumulative phase AND wall totals, so goodput
        honestly degrades on between-step stalls, and observes the phase
        histogram directly)."""
        seconds = float(seconds)
        with self._lock:
            if self._step_t0 is not None:
                self._step_phases[name] = \
                    self._step_phases.get(name, 0.0) + seconds
                return
            self.phase_seconds[name] = \
                self.phase_seconds.get(name, 0.0) + seconds
            self.wall_seconds += seconds
        self._hist(name).observe(seconds)
        # keep the exported ledger consistent: phase-hist sums must keep
        # reconstructing the wall-hist sum (obs_report renders shares as
        # phase_sum/wall_sum), so a between-step stall observes both
        self._wall_hist.observe(seconds)
        self.publish()

    def _close_step(self, t1):
        with self._lock:
            wall = max(0.0, t1 - self._step_t0)
            phases = self._step_phases
            self._step_t0 = None
            self._step_phases = {}
            accounted = sum(phases.values())
            if wall > accounted:
                phases["other"] = wall - accounted
            self.steps += 1
            self.wall_seconds += wall
            for k, v in phases.items():
                self.phase_seconds[k] = self.phase_seconds.get(k, 0.0) + v
        for k, v in phases.items():
            self._hist(k).observe(v)
        self._wall_hist.observe(wall)
        self._g_last.set(wall)
        self._c_steps.inc()
        self.publish()

    # -- derived gauges --------------------------------------------------
    def _resolved_flops(self, harvest=False):
        if self.flops_per_step is None and self.program is not None:
            from . import xla_introspect as xi
            self.flops_per_step = xi.flops_of(self.program,
                                              harvest_missing=harvest)
        return self.flops_per_step

    def resolve_flops(self):
        """Force flops resolution from the attached program, running its
        pending thunk if it has one. Call after warmup, before a timed
        window, so harvesting never lands inside measured steps."""
        return self._resolved_flops(harvest=True)

    def publish(self):
        """Refresh perf_goodput / perf_mfu from cumulative totals."""
        if not _ENABLED[0]:
            return
        g = goodput(self.phase_seconds, self.wall_seconds, self.productive)
        if g is not None:
            self._g_goodput.set(round(g, 6))
        busy = sum(self.phase_seconds.get(p, 0.0) for p in self.productive)
        m = mfu(self._resolved_flops(), self.steps, busy, self.peak)
        if m is not None:
            self._g_mfu.set(round(m, 6))

    # -- inspection ------------------------------------------------------
    def totals(self):
        """Copy of cumulative accounting: {steps, wall, phases:{...},
        goodput, mfu} — diff two snapshots for per-window stats."""
        with self._lock:
            phases = dict(self.phase_seconds)
            steps, wall = self.steps, self.wall_seconds
        busy = sum(phases.get(p, 0.0) for p in self.productive)
        return {"steps": steps, "wall": wall, "phases": phases,
                "goodput": goodput(phases, wall, self.productive),
                "mfu": mfu(self.flops_per_step, steps, busy, self.peak)}


def window_stats(before, after, flops_per_step=None, peak=None,
                 productive=PRODUCTIVE_PHASES):
    """Per-window goodput/mfu from two StepTimer.totals() snapshots."""
    steps = after["steps"] - before["steps"]
    wall = after["wall"] - before["wall"]
    phases = {k: after["phases"].get(k, 0.0) - before["phases"].get(k, 0.0)
              for k in after["phases"]}
    busy = sum(phases.get(p, 0.0) for p in productive)
    return {"steps": steps, "wall": wall, "phases": phases,
            "goodput": goodput(phases, wall, productive),
            "mfu": mfu(flops_per_step, steps, busy, peak)}
