"""Compiled step programs: the port's counterpart of the JAX engine's
programs compiled once per shape bucket and then reused
(``paddle_tpu/inference/engine.py``: ``_build_decode`` keyed (steps,
sampling), ``_build_prefill`` (c, s_pad, sampling), ``_build_ragged`` (c,
s_pad, sampling), ``_build_spec_verify`` (c, s_pad) and ``_build_copy``
(n)).

A program is one engine step over static device input buffers. The
engine's host arrays are written into pinned staging tensors and copied to
the static buffers with ``non_blocking=True``; the step reads only those
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
"""

from __future__ import annotations

import gc
import itertools

import numpy as np
import torch

from ..ops import kernels as K

# program kind -> the engine attribute counting the programs built (the
# JAX engine's names; the verify program's is the spec counter)
TRACE_COUNTERS = {"decode": "decode_trace_count",
                  "prefill": "prefill_trace_count",
                  "ragged": "ragged_trace_count",
                  "verify": "spec_trace_count",
                  "copy": "copy_trace_count"}

_STREAMS = {}           # device -> the capture stream

_DTYPES = {np.dtype(np.int64): torch.int64, np.dtype(np.int32): torch.int32,
           np.dtype(np.float32): torch.float32,
           np.dtype(np.bool_): torch.bool}


class Program:
    """One step over static device inputs, named as the host arrays of
    its first use; `fn(inputs)` computes the step from them. On the card
    the inputs are filled from pinned staging tensors."""

    def __init__(self, fn, host, device):
        self.fn = fn
        self.inputs, self.staging = {}, {}
        pinned = device.type == "cuda"
        for name, arr in host.items():
            dtype = _DTYPES[np.asarray(arr).dtype]
            self.inputs[name] = torch.empty(arr.shape, dtype=dtype,
                                            device=device)
            if pinned:
                self.staging[name] = torch.empty(arr.shape, dtype=dtype,
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
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"program input {name}: shape "
                                 f"{tuple(arr.shape)} != {tuple(dst.shape)}")
            buf = self.staging.get(name)
            if buf is None:
                dst.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
            else:
                buf.numpy()[...] = arr
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

    def run(self, kind, key, host, fn):
        """Run program (kind, key) on `host` ({name: np.ndarray}, the
        same shapes at every call of one key; a "temps" array marks a
        sampling program); `fn(inputs)` computes the step from the static
        inputs (a dict of device tensors) and returns its outputs. Returns
        the outputs (static ones after a replay: read them before the next
        program runs)."""
        with torch.inference_mode():
            prog = self._progs.get((kind, key))
            if prog is not None:
                prog.load(host)
                if prog.graph is None:
                    return prog.fn(prog.inputs)
                prog.graph.replay()
                K.add_launch_counts(prog.launches)
                return prog.outputs
            eng = self.engine
            prog = Program(fn, host, eng.device)
            prog.load(host)
            if eng._graphs and eng.device.type == "cuda":
                out = self._warm_and_capture(prog, "temps" in host)
            else:
                out = fn(prog.inputs)
            if self._weights is None:
                self._weights = self._addresses()
            self._progs[(kind, key)] = prog
            name = TRACE_COUNTERS[kind]
            setattr(eng, name, getattr(eng, name) + 1)
            return out

    def _warm_and_capture(self, prog, sampling):
        """The first use on the card: `prog`'s step eagerly on the capture
        stream (its result is returned), then captured there into a CUDA
        graph in the engine's pool. The wrappers' launch counts the
        capture added are taken back and kept for the replays."""
        dev = self.engine.device
        stream = _STREAMS.get(dev)
        if stream is None:
            stream = _STREAMS[dev] = torch.cuda.Stream(dev)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        cur = torch.cuda.current_stream(dev)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            out = prog.fn(prog.inputs)
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
        model = self.engine.model
        return tuple(t.data_ptr() for t in
                     itertools.chain(model.parameters(), model.buffers()))

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
