"""Program introspection: per-program flops, bytes and the HBM ledger.

The counterpart of ``paddle_tpu/observability/xla_introspect.py``, rebuilt
for eager PyTorch on CUDA. The series keep the JAX package's names,
``xla_`` prefix included, so one dashboard and ``tools/obs_report.py``
read both packages:

- ``xla_program_flops{program=}`` / ``xla_program_bytes_accessed{program=}``
  gauges: a program's flops and the bytes its ops read and write;
- ``xla_hbm_bytes{program=,kind=args|outputs|temps|code|total}`` gauges,
  the process-wide ``xla_hbm_high_watermark_bytes`` gauge, and an
  ``hbm_over_budget`` event when one program's footprint exceeds the
  budget (``PADDLE_TPU_HBM_BUDGET_GB``, else the card's
  ``total_memory``).

XLA compiles a program without running it and its ``cost_analysis``
reads the compiled HLO. Nothing here compiles, and a port program cannot
be run again to be measured: a train step would step the optimizer, an
engine step would write KV pages. So a program is counted during a run
that happens anyway, through ``Counter`` (``count(name, ...)``): the
first step of ``jit.compile_train_step``, and the eager warm-up that
``inference.programs`` makes before each capture. A counter is a
``torch.utils.flop_counter.FlopCounterMode`` (the matmul, attention and
convolution products of the torch ops) plus a dispatch mode of its own
(bytes, temps), plus each hand-written kernel's cost from its shapes
(``ops.kernels._cost``: the kernels are ctypes launches the modes cannot
see inside; the dispatch mode charges each kernel's op,
``ops.kernels._ops``, and a wrapper called outside an op charges
itself). So the flops are the products of the program (elementwise torch
ops count no flops, as in ``FlopCounterMode``; the kernels count theirs),
``bytes accessed`` is what each eager op reads and writes (view ops move
nothing), and the memory kinds are: args, the bytes of the tensors the
program reads (the caller names them); outputs, what it returns; temps,
the peak of memory above the start during the run (on the card
``torch.cuda.memory_allocated`` after each op; on the CPU the live
outputs of the ops the mode saw); code 0. Counting slows the step it
wraps (a Python call per op), which is why it runs once, on a step that
is no part of a timed window.

``register_call(name, fn, *args, **kwargs)`` runs the live call under a
counter the first time `name` is seen and plainly afterwards (the JAX
version only registers; here registering is measuring, since nothing
can be re-run); ``register_thunk(name, thunk)`` defers a thunk returning
``{"flops", "bytes_accessed", "mem"}`` to ``harvest()``; ``flops_of``
reads what a program counted. ``perf.StepTimer`` divides those flops by
the measured busy seconds and the card's peak.
"""

from __future__ import annotations

import collections
import os
import threading
import weakref

from .metrics import REGISTRY as _REG, _ENABLED
from .events import EVENTS as _EVENTS

__all__ = [
    "register_call", "register_thunk", "record_analysis", "harvest",
    "flops_of", "program_count", "pending_count", "programs", "registered",
    "count", "Counter", "set_hbm_budget", "hbm_budget_bytes",
    "hbm_high_watermark_bytes", "reset",
]

_MAX_PROGRAMS = 512          # drop-oldest: label cardinality stays bounded
_LOCK = threading.Lock()
_PROGRAMS = collections.OrderedDict()   # name -> entry dict
_WATERMARK = [0.0]           # process-wide HBM high watermark (bytes)
_BUDGET = [None]             # explicit override via set_hbm_budget()
_WARNED = set()              # programs already flagged over-budget
_GiB = 1024 ** 3

_G_WATERMARK = _REG.gauge(
    "xla_hbm_high_watermark_bytes",
    "largest single-program HBM footprint seen (args+outputs+temps+code)")


def _new_entry(thunk=None):
    return {"thunk": thunk, "harvested": False, "error": None,
            "flops": None, "hbm_total": None}


def registered(name):
    with _LOCK:
        return name in _PROGRAMS


def _claim(name, thunk=None):
    """Add `name` (drop-oldest past the cap); False when it was there."""
    with _LOCK:
        if name in _PROGRAMS:
            return False
        while len(_PROGRAMS) >= _MAX_PROGRAMS:
            _PROGRAMS.popitem(last=False)
        _PROGRAMS[name] = _new_entry(thunk)
    return True


def register_thunk(name, thunk):
    """Register `thunk() -> {"flops", "bytes_accessed", "mem"}` under
    `name`, run by ``harvest()``. Returns True when newly registered."""
    if not _ENABLED[0]:
        return False
    return _claim(name, thunk)


def register_call(name, fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` and return its result. The first call
    of a `name` (while telemetry is enabled) runs under a counter whose
    args are the tensors among `args`/`kwargs`, and publishes the
    program's analysis; later calls run `fn` as it is."""
    if not _ENABLED[0] or registered(name):
        return fn(*args, **kwargs)
    with count(name, args=(args, kwargs)) as c:
        out = fn(*args, **kwargs)
        c.outputs = out
    return out


def program_count():
    return len(_PROGRAMS)


def pending_count():
    with _LOCK:
        return sum(1 for e in _PROGRAMS.values() if not e["harvested"])


def programs():
    """{name: {flops, hbm_total, harvested, error, ...}} snapshot (no
    thunks)."""
    with _LOCK:
        return {n: {k: v for k, v in e.items() if k != "thunk"}
                for n, e in _PROGRAMS.items()}


# -- budgets ----------------------------------------------------------------

def set_hbm_budget(nbytes):
    """Explicit HBM budget override (None restores the card's)."""
    _BUDGET[0] = None if nbytes is None else float(nbytes)
    _WARNED.clear()


def hbm_budget_bytes():
    """Effective budget: set_hbm_budget > PADDLE_TPU_HBM_BUDGET_GB env >
    the card's ``total_memory`` > None (no card)."""
    if _BUDGET[0] is not None:
        return _BUDGET[0]
    env = os.environ.get("PADDLE_TPU_HBM_BUDGET_GB")
    if env:
        try:
            return float(env) * _GiB
        except ValueError:
            pass
    try:
        import torch
        if torch.cuda.is_available():
            return float(torch.cuda.get_device_properties(
                torch.cuda.current_device()).total_memory)
    except Exception:  # noqa: BLE001 — budget lookup is best-effort
        pass
    return None


def hbm_high_watermark_bytes():
    return _WATERMARK[0]


# -- analysis ingestion -----------------------------------------------------

def record_analysis(name, flops=None, bytes_accessed=None, mem=None):
    """Publish one program's analysis into the registry gauges and the
    HBM ledger. `mem` is {args, outputs, temps, code, alias} in bytes.
    Also the injection point for tests."""
    if flops is not None:
        _REG.gauge("xla_program_flops", "XLA cost_analysis flops",
                   labels={"program": name}).set(float(flops))
    if bytes_accessed is not None:
        _REG.gauge("xla_program_bytes_accessed",
                   "XLA cost_analysis bytes accessed",
                   labels={"program": name}).set(float(bytes_accessed))
    total = None
    if mem:
        total = (mem.get("args", 0) + mem.get("outputs", 0)
                 + mem.get("temps", 0) + mem.get("code", 0)
                 - mem.get("alias", 0))
        for kind in ("args", "outputs", "temps", "code"):
            _REG.gauge("xla_hbm_bytes", "XLA memory_analysis HBM bytes",
                       labels={"program": name, "kind": kind}
                       ).set(float(mem.get(kind, 0)))
        _REG.gauge("xla_hbm_bytes", "XLA memory_analysis HBM bytes",
                   labels={"program": name, "kind": "total"}
                   ).set(float(total))
        if total > _WATERMARK[0]:
            _WATERMARK[0] = float(total)
        _G_WATERMARK.set(_WATERMARK[0])
        budget = hbm_budget_bytes()
        if budget and total > budget and name not in _WARNED:
            _WARNED.add(name)
            _EVENTS.record("hbm_over_budget", program=name,
                           hbm_bytes=int(total), budget_bytes=int(budget),
                           over=round(total / budget, 3))
    with _LOCK:
        e = _PROGRAMS.get(name)
        if e is not None:
            e["harvested"] = True
            if flops is not None:
                e["flops"] = float(flops)
            if bytes_accessed is not None:
                e["bytes_accessed"] = float(bytes_accessed)
            if total is not None:
                e["hbm_total"] = float(total)
    return total


def _harvest_one(name, entry):
    with _LOCK:
        thunk = entry["thunk"]
        entry["thunk"] = None   # one-shot
    if thunk is None:           # counted at registration, or lost a race
        return False
    try:
        res = thunk() or {}
        record_analysis(name, flops=res.get("flops"),
                        bytes_accessed=res.get("bytes_accessed"),
                        mem=res.get("mem"))
        return True
    except Exception as e:  # noqa: BLE001 — introspection never breaks a run
        entry["harvested"] = True      # don't retry-storm a broken program
        entry["error"] = f"{type(e).__name__}: {str(e)[:160]}"
        _EVENTS.record("xla_introspect_error", program=name,
                       error=entry["error"])
        return False


def harvest(limit=None):
    """Run every pending registered thunk and publish its analysis.
    Returns the newly harvested names (programs counted at registration
    are harvested already)."""
    if not _ENABLED[0]:
        return []
    with _LOCK:
        todo = [(n, e) for n, e in _PROGRAMS.items() if not e["harvested"]]
    if limit is not None:
        todo = todo[-int(limit):]
    return [name for name, entry in todo if _harvest_one(name, entry)]


def flops_of(name, harvest_missing=True):
    """Counted flops of a program (None when unknown). With
    harvest_missing, a pending thunk runs first."""
    with _LOCK:
        e = _PROGRAMS.get(name)
    if e is None:
        return None
    if e["flops"] is None and not e["harvested"] and harvest_missing:
        _harvest_one(name, e)
    return e["flops"]


def reset():
    """Forget every registered program and the ledger (test isolation)."""
    with _LOCK:
        _PROGRAMS.clear()
    _WATERMARK[0] = 0.0
    _WARNED.clear()
    _G_WATERMARK.set(0.0)


# -- the counter ----------------------------------------------------------------

def _tensors(obj, out):
    """Every torch tensor in a nest of lists, tuples and dicts."""
    import torch
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _tensors(o, out)
    elif isinstance(obj, dict):
        for o in obj.values():
            _tensors(o, out)
    return out


def _storage_bytes(tensors):
    """Bytes of the distinct storages under `tensors` (views count
    once)."""
    seen, total = set(), 0
    for t in tensors:
        try:
            st = t.untyped_storage()
            key = (t.device.type, st.data_ptr())
            if key not in seen:
                seen.add(key)
                total += st.nbytes()
        except (RuntimeError, NotImplementedError):
            total += t.numel() * t.element_size()
    return total


def _make_mode(counter):
    from torch.utils._python_dispatch import TorchDispatchMode
    from ..ops.kernels._ops import COSTS

    class _CountMode(TorchDispatchMode):
        """Bytes each op reads and writes, and the peak of temps; a
        kernel's op (``ops.kernels._ops``) is charged its own cost."""

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            spec = COSTS.get(func)
            if spec is not None:
                return counter._kernel_op(func, spec, args, kwargs or {})
            out = func(*args, **(kwargs or {}))
            try:
                counter._op(func, args, kwargs, out)
            except Exception:  # noqa: BLE001 — counting never breaks a run
                pass
            return out

    return _CountMode()


class Counter:
    """Count one run of a program (see the module docstring): enter it
    around the run, set ``outputs`` to what the run returned, and on exit
    the analysis is published under `name` (``record_analysis``) and the
    program is registered. `args` are the tensors (or nests of them) the
    program reads. `device`: the card whose allocator gives the temps
    (default: that of the first CUDA tensor among `args`), else the CPU
    rule. An exception inside leaves nothing recorded."""

    def __init__(self, name, args=(), device=None):
        self.name = name
        self.outputs = None
        self._args = args
        self._device = device
        self._fc = None
        self.mode = None
        self.kernels = {}           # kernel name -> [calls, flops, bytes]
        self._bytes = 0
        self._hidden_flops = 0      # flops the modes saw inside kernels
        self._start = self._peak = 0
        self._live = {}             # CPU: storage key -> bytes
        self._lock = threading.Lock()
        self.analysis = None

    # -- the modes' and the kernels' hooks --------------------------------
    def _op(self, func, args, kwargs, out):
        if func.is_view:
            return
        outs = _tensors(out, [])
        nb = sum(t.numel() * t.element_size() for t in
                 _tensors((args, kwargs or {}), []) + outs)
        with self._lock:
            self._bytes += nb
        if self._device is not None and self._device.type == "cuda":
            import torch
            now = torch.cuda.memory_allocated(self._device)
            with self._lock:
                self._peak = max(self._peak, now)
            return
        for t in outs:
            try:
                key = t.untyped_storage().data_ptr()
                size = t.untyped_storage().nbytes()
            except (RuntimeError, NotImplementedError):
                continue
            with self._lock:
                if key in self._live:
                    continue
                self._live[key] = size
                live = sum(self._live.values())
                self._peak = max(self._peak, live)
            weakref.finalize(t, self._free, key)

    def _kernel_op(self, func, spec, args, kwargs):
        """Run a kernel's op and charge it its cost from the op's
        arguments (``_ops.COSTS``): the wrapper inside runs with the modes
        popped, so it charges nothing itself."""
        name, cost = spec
        since = self.mark()
        out = func(*args, **kwargs)
        try:
            self._op(func, args, kwargs, out)
            flops, nbytes = cost(*args, **kwargs)
        except Exception:  # noqa: BLE001 — counting never breaks a run
            flops = nbytes = None
        self.kernel(name, flops, nbytes, since)
        return out

    def _free(self, key):
        with self._lock:
            self._live.pop(key, None)

    def mark(self):
        """(flops, bytes) the modes have counted so far."""
        with self._lock:
            return self._fc.get_total_flops(), self._bytes

    def kernel(self, name, flops, nbytes, since):
        """Charge one kernel call: its own cost, in place of what the modes
        counted since `since` (its plain version, its allocations)."""
        f0, b0 = since
        f1, b1 = self.mark()
        with self._lock:
            self._hidden_flops += f1 - f0
            self._bytes -= b1 - b0
            k = self.kernels.setdefault(name, [0, 0, 0])
            k[0] += 1
            k[1] += int(flops or 0)
            k[2] += int(nbytes or 0)
            self._bytes += int(nbytes or 0)

    # -- the run -----------------------------------------------------------
    def __enter__(self):
        import torch
        from torch.utils.flop_counter import FlopCounterMode
        from ..ops.kernels import _cost
        if self._device is None:
            self._device = next((t.device for t in _tensors(self._args, [])
                                 if t.device.type == "cuda"), None)
        if self._device is not None and self._device.type == "cuda":
            self._start = self._peak = torch.cuda.memory_allocated(
                self._device)
        self._fc = FlopCounterMode(display=False)
        self._fc.__enter__()
        self.mode = _make_mode(self)
        self.mode.__enter__()
        _cost.ACTIVE.append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        from ..ops.kernels import _cost
        _cost.ACTIVE.remove(self)
        self.mode.__exit__(exc_type, exc, tb)
        self._fc.__exit__(exc_type, exc, tb)
        if exc_type is not None:
            return False
        try:
            self._publish()
        except Exception:  # noqa: BLE001 — telemetry never breaks a step
            pass
        return False

    def _publish(self):
        flops = self._fc.get_total_flops() - self._hidden_flops + sum(
            k[1] for k in self.kernels.values())
        temps = max(0, self._peak - self._start)
        mem = {"args": _storage_bytes(_tensors(self._args, [])),
               "outputs": _storage_bytes(_tensors(self.outputs, [])),
               "temps": temps, "code": 0, "alias": 0}
        self.analysis = {"flops": flops, "bytes_accessed": self._bytes,
                         "mem": mem,
                         "kernels": {n: {"calls": c, "flops": f, "bytes": b}
                                     for n, (c, f, b)
                                     in self.kernels.items()}}
        _claim(self.name)
        record_analysis(self.name, flops=flops,
                        bytes_accessed=self._bytes, mem=mem)
        with _LOCK:
            e = _PROGRAMS.get(self.name)
            if e is not None:
                e["kernels"] = self.analysis["kernels"]


def count(name, args=(), device=None):
    """A ``Counter`` for program `name` (see the class)."""
    return Counter(name, args=args, device=device)
