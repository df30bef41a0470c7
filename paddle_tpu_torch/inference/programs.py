"""Compiled step programs: the port's counterpart of the JAX engine's
programs compiled once per shape bucket and then reused
(``paddle_tpu/inference/engine.py``: ``_build_decode`` keyed (steps,
sampling), ``_build_prefill`` (c, s_pad, sampling), ``_build_ragged`` (c,
s_pad, sampling), ``_build_spec_verify`` (c, s_pad), ``_build_copy`` (n)
and ``_build_upload`` (n; here also the staged pages' dtype, on which
``jax.jit`` retraces)).

A program is one engine step over static device input buffers. The
engine's host arrays (numpy arrays; CPU tensors for an upload's staged KV
pages, since numpy has no bfloat16) are written into pinned staging
tensors and copied to the static buffers with ``non_blocking=True``; the step reads only those
buffers, the engine's pools and the model, and returns its output
tensors, which the caller copies to the host. That copy is the step's one
host sync; it always follows the program and is never inside it.

On the card a program is a ``torch.cuda.CUDAGraph``. Its first use runs
the step eagerly on the capture stream (a side stream, one per device):
that run is the warm-up that reaches every lazy set-up of the path (a
kernel's ``cudaFuncSetAttribute``, the cuBLAS handle and workspaces of
that stream, the decode split plan's check) outside any capture, and it
computes this step's result. Then the same step is captured on that
stream into a graph that every later use replays. All of an engine's
graphs share one memory pool, which nothing outlives: a workspace first
allocated inside a capture would land in the pool and keep it alive
after its graphs are gone. A capture that
fails raises; nothing falls back to eager. On the CPU, and on the card
when the engine's private ``_graphs`` is False (the eager twin that
``chip_smoke.py`` measures beside the graphs), every use runs the step
eagerly through the same static buffers.

Each program built adds one to the engine's trace counter of its kind,
under the JAX engine's names (``TRACE_COUNTERS``): once per capture on the
card, so a repeat wave of the same shapes leaves every counter unchanged.

The kernels' launch counters (``ops.kernels.launch_counts``) count in the
Python wrappers, which run at capture and never at replay. A capture
therefore records the counts it added and takes them back (it launched
nothing), and each replay adds them again.

A sampling program registers the engine's generator with its graph, so a
replay draws from the generator's offset at that moment, as the eager
step does: the same seed gives the same tokens with and without graphs.
Programs hold the parameters' addresses; ``revalidate`` (run after a
weight swap) drops them all when one has moved.

Each step program of the kinds the JAX engine registers with its XLA
introspection (decode, prefill, ragged, verify; not the CoW copy or the
upload) is counted at its first use, during the eager warm-up that runs
anyway, under the JAX engine's label (``program_label``:
``engine:ragged:{c}x{s_pad}:greedy``, ``engine:decode:{steps}:sample``,
``engine:spec_verify:{c}x{s_pad}``, ...): ``observability.xla_introspect``
publishes its flops, bytes and memory. Labels are process-wide, as in
JAX: the first program of a label is the one counted. A mesh engine's
labels carry its suffix (``:tp2``, ``:tp2fsdp2``), and the same first run
happens inside the engine's ``_program_scope``, where the mesh engine
records the program's collectives for the sharding observatory.

Several engines in one process (a fleet's replicas, each stepped by its
own thread) share the device's capture stream. One engine's warm-up or
capture must never meet another engine's work on that stream (the work
would land inside the capture), and two captures cannot share a stream.
So every program run on the card, warm-up, capture or replay, holds one
process-wide lock (``CAPTURE_LOCK``) while it enqueues; the host copy that
follows a program, and an engine's eager work outside programs, run
unlocked on the caller's stream, which never synchronizes implicitly
with the capture stream (a non-blocking stream) and which a thread-local
capture mode lets other threads use meanwhile.
"""

from __future__ import annotations

import contextlib
import gc
import threading

import numpy as np
import torch

from ..ops import kernels as K

# program kind -> the engine attribute counting the programs built (the
# JAX engine's names; the verify program's is the spec counter)
TRACE_COUNTERS = {"decode": "decode_trace_count",
                  "prefill": "prefill_trace_count",
                  "ragged": "ragged_trace_count",
                  "verify": "spec_trace_count",
                  "copy": "copy_trace_count",
                  "upload": "upload_trace_count"}

_STREAMS = {}           # device -> the capture stream

# held by every program run on the card (see the module docstring);
# reentrant, so a program may run another engine's program inside it
CAPTURE_LOCK = threading.RLock()

_DTYPES = {np.dtype(np.int64): torch.int64, np.dtype(np.int32): torch.int32,
           np.dtype(np.float32): torch.float32,
           np.dtype(np.bool_): torch.bool}


def program_label(kind, key):
    """The JAX engine's xla_introspect label of program (kind, key), or
    None for the kinds it does not register (copy, upload)."""
    if kind == "decode":
        steps, sampling = key
        return f"engine:decode:{steps}:{'sample' if sampling else 'greedy'}"
    if kind in ("prefill", "ragged"):
        c, s_pad, sampling = key
        return (f"engine:{kind}:{c}x{s_pad}:"
                f"{'sample' if sampling else 'greedy'}")
    if kind == "verify":
        c, s_pad = key
        return f"engine:spec_verify:{c}x{s_pad}"
    return None


def _leading(src, dst):
    """The index of `dst` that `src` fills: all of it for equal shapes;
    for a tensor short of `dst` in its second dimension only (an upload's
    staged pages, padded to a power of two), its leading part, the rest
    of the buffer keeping what it held. None when the shapes disagree
    otherwise."""
    if tuple(src.shape) == tuple(dst.shape):
        return (slice(None),)
    if torch.is_tensor(src) and src.dim() == dst.dim() >= 2 \
            and src.shape[1] < dst.shape[1] \
            and src.shape[:1] + src.shape[2:] == dst.shape[:1] + dst.shape[2:]:
        return (slice(None), slice(0, src.shape[1]))
    return None


class Program:
    """One step over static device inputs, named as the host arrays of
    its first use (of their shapes, or of `shapes` where it names one);
    `fn(inputs)` computes the step from them. On the card the inputs are
    filled from pinned staging tensors."""

    def __init__(self, fn, host, device, shapes=None):
        self.fn = fn
        self.inputs, self.staging = {}, {}
        pinned = device.type == "cuda"
        for name, arr in host.items():
            dtype = arr.dtype if torch.is_tensor(arr) \
                else _DTYPES[np.asarray(arr).dtype]
            shape = (shapes or {}).get(name, arr.shape)
            # zeros: a part that no load fills is defined
            self.inputs[name] = torch.zeros(shape, dtype=dtype,
                                            device=device)
            if pinned:
                self.staging[name] = torch.zeros(shape, dtype=dtype,
                                                 pin_memory=True)
        # recorded after each upload's copies, waited for before the next
        # upload rewrites the staging tensors
        self._staged = torch.cuda.Event() if pinned else None
        self._uploaded = False
        self.graph = None
        self.outputs = None
        self.launches = {}      # kernel launches one replay makes

    def load(self, host):
        """Copy host arrays into the static inputs (through the staging
        tensors on the card, which a copy still in flight may read: the
        previous upload's event is waited for first)."""
        if self._uploaded:
            self._staged.synchronize()
        for name, arr in host.items():
            dst = self.inputs[name]
            src = arr if torch.is_tensor(arr) \
                else torch.from_numpy(np.ascontiguousarray(arr))
            buf = self.staging.get(name)
            part = _leading(src, dst)
            if part is None:
                raise ValueError(f"program input {name}: shape "
                                 f"{tuple(arr.shape)} != {tuple(dst.shape)}")
            if buf is None:
                dst[part].copy_(src)
            else:
                buf[part].copy_(src)
                dst.copy_(buf, non_blocking=True)
        if self._staged is not None:
            self._staged.record()
            self._uploaded = True


class StepPrograms:
    """An engine's programs by (kind, key), and the runner that builds,
    captures and replays them."""

    def __init__(self, engine):
        self.engine = engine
        self._progs = {}
        self._pool = None
        self._weights = None    # parameter addresses the programs read

    def __len__(self):
        return len(self._progs)

    def captured(self):
        """{kind: programs captured as CUDA graphs}."""
        out = dict.fromkeys(TRACE_COUNTERS, 0)
        for (kind, _), prog in self._progs.items():
            out[kind] += prog.graph is not None
        return out

    def run(self, kind, key, host, fn, shapes=None):
        """Run program (kind, key) on `host` ({name: np.ndarray}, the
        same shapes at every call of one key; a "temps" array marks a
        sampling program; `shapes` may give an input a larger static
        shape that later loads fill in part, see ``_leading``);
        `fn(inputs)` computes the step from the static
        inputs (a dict of device tensors) and returns its outputs. Returns
        the outputs (static ones after a replay: read them before the next
        program runs)."""
        eng = self.engine
        locked = eng._graphs and eng.device.type == "cuda"
        with torch.inference_mode(), \
                (CAPTURE_LOCK if locked else contextlib.nullcontext()):
            prog = self._progs.get((kind, key))
            if prog is not None:
                prog.load(host)
                if prog.graph is None:
                    return prog.fn(prog.inputs)
                prog.graph.replay()
                K.add_launch_counts(prog.launches)
                return prog.outputs
            prog = Program(fn, host, eng.device, shapes)
            prog.load(host)
            counter = self._counter(kind, key, prog)
            scope = eng._program_scope(kind, key)
            if eng._graphs and eng.device.type == "cuda":
                out = self._warm_and_capture(prog, "temps" in host, counter,
                                             scope)
            else:
                with scope:
                    out = self._warm(prog, counter)
            if self._weights is None:
                self._weights = self._addresses()
            self._progs[(kind, key)] = prog
            name = TRACE_COUNTERS[kind]
            setattr(eng, name, getattr(eng, name) + 1)
            return out

    def _counter(self, kind, key, prog):
        """An xla_introspect counter for the first use of program (kind,
        key), or None (a kind JAX does not register, a label already
        counted, telemetry off)."""
        from ..observability import metrics, xla_introspect
        label = program_label(kind, key)
        eng = self.engine
        if label is None or not metrics.enabled():
            return None
        label += eng._prog_suffix
        if xla_introspect.registered(label):
            return None
        return xla_introspect.count(label, args=(
            prog.inputs, eng._param_tensors(), eng._pool_tensors()),
            device=eng.device)

    @staticmethod
    def _warm(prog, counter):
        """`prog`'s step eagerly, under `counter` when there is one."""
        if counter is None:
            return prog.fn(prog.inputs)
        with counter:
            out = prog.fn(prog.inputs)
            counter.outputs = out
        return out

    def _warm_and_capture(self, prog, sampling, counter=None,
                          scope=contextlib.nullcontext()):
        """The first use on the card: `prog`'s step eagerly on the capture
        stream (its result is returned; counted by `counter`), then
        captured there into a CUDA graph in the engine's pool. The
        wrappers' launch counts the capture added are taken back and kept
        for the replays."""
        dev = self.engine.device
        stream = _STREAMS.get(dev)
        if stream is None:
            stream = _STREAMS[dev] = torch.cuda.Stream(dev)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        cur = torch.cuda.current_stream(dev)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream), scope:
            out = self._warm(prog, counter)
        graph = torch.cuda.CUDAGraph()
        if sampling:
            graph.register_generator_state(self.engine._gen)
        before = K.launch_counts()
        # no collection while capturing: a dead engine's graphs and pinned
        # buffers (engines and their programs form reference cycles) would
        # be freed inside the capture, and a cudaFree there invalidates it
        collecting = gc.isenabled()
        gc.disable()
        try:
            self._capture_on(stream, graph, prog)
        finally:
            if collecting:
                gc.enable()
        cur.wait_stream(stream)
        after = K.launch_counts()
        prog.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        K.add_launch_counts(prog.launches, sign=-1)  # captured, not run
        prog.graph = graph
        return out

    def _capture_on(self, stream, graph, prog):
        with torch.cuda.stream(stream):
            # thread_local: another thread (a stream consumer waiting for
            # the step lock) may allocate while this one captures
            graph.capture_begin(pool=self._pool,
                                capture_error_mode="thread_local")
            try:
                outputs = prog.fn(prog.inputs)
            except BaseException:
                try:
                    graph.capture_end()    # leave capture mode, then raise
                except RuntimeError:
                    pass
                raise
            graph.capture_end()
        prog.outputs = outputs

    def _addresses(self):
        return tuple(t.data_ptr() for t in self.engine._param_tensors())

    def revalidate(self):
        """After the model's weights changed: keep the programs when every
        parameter and buffer kept its address (an in-place load), else
        drop them all, so the next use of each shape builds it again and
        the trace counters show it. Returns True when they were dropped."""
        if self._weights is None or self._addresses() == self._weights:
            return False
        self._progs.clear()
        self._pool = None           # the next capture starts a new pool
        self._weights = None
        return True
