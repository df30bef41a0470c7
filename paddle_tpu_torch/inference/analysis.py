"""Inference analysis and serving features: the counterpart of
``paddle_tpu/inference/analysis.py``.

``ProgramAnalysis`` reports on a ``jit.save`` program: the exported
graph's call targets by name (``aten.*``, the kernels' ``ptt.*``), the
tensors it holds as constants, its inputs, and the FLOPs of its matrix
products counted as the JAX package counts its ``dot_general``s (2*M*N*K
each): the matmul-type ATen nodes, and a flash attention node as the two
products of the JAX package's XLA attention (4*B*H*S*S_k*D, causal or
not); convolutions are not counted, as XLA's are not ``dot_general``s.

``DynamicBatcher`` and its futures are the JAX package's, unchanged
(stdlib and numpy): requests enqueue single samples, a worker drains up
to ``max_batch``, pads to the nearest bucket and runs one call.
"""

from __future__ import annotations

import collections
import queue
import threading

import numpy as np
import torch

# the matmul-type ATen ops and the position of their left operand
_MATMUL_LHS = {"aten.matmul": 0, "aten.mm": 0, "aten.bmm": 0,
               "aten.linear": 0, "aten.addmm": 1, "aten.baddbmm": 1}
_ATTENTION = ("ptt.flash_attention_fwd", "ptt.flashmask_attention_fwd")


def _target_name(target):
    if isinstance(target, torch._ops.OpOverload):
        return f"{target.namespace}.{target.overloadpacket.__name__}"
    return getattr(target, "__name__", str(target))


class ProgramAnalysis:
    """Static analysis of a jit.save'd program (the counterpart of the
    reference's analysis-pass summary logs)."""

    def __init__(self, path):
        from ..jit import _load_program
        self._program, self._meta = _load_program(path)

    def _calls(self):
        return [n for n in self._program.graph.nodes
                if n.op == "call_function"]

    def op_histogram(self):
        """call target name -> count (what the program runs)."""
        return dict(collections.Counter(
            _target_name(n.target) for n in self._calls()))

    def constant_count(self):
        """Tensors the program holds as constants (non-persistent
        buffers, lifted tensor constants)."""
        return len(self._program.constants)

    def dot_flops(self, dynamic_dim=1):
        """FLOPs of the program's matrix products (see the module
        docstring) from the nodes' shapes; dynamic dims count as
        `dynamic_dim` (per-sample FLOPs by default)."""
        def dims(t):
            return [d if isinstance(d, int) else dynamic_dim
                    for d in t.shape]
        total = 0
        for n in self._calls():
            name = _target_name(n.target)
            if name in _MATMUL_LHS:
                k = dims(n.args[_MATMUL_LHS[name]].meta["val"])[-1]
                total += 2 * int(np.prod(dims(n.meta["val"]))) * k
            elif name in _ATTENTION:
                b, s, h, d = dims(n.args[0].meta["val"])
                s_k = dims(n.args[1].meta["val"])[1]
                total += 4 * b * h * s * s_k * d
        return total

    def input_specs(self):
        """(shape, dtype) of every program input: the parameters, the
        buffers and constants, then the user inputs (a dynamic dim is its
        symbol's name)."""
        return [(tuple(d if isinstance(d, int) else str(d)
                       for d in n.meta["val"].shape),
                 str(n.meta["val"].dtype).removeprefix("torch."))
                for n in self._program.graph.nodes
                if n.op == "placeholder"]

    def summary(self):
        hist = self.op_histogram()
        top = sorted(hist.items(), key=lambda kv: -kv[1])[:12]
        lines = ["--- inference program analysis ---",
                 f"inputs: {self.input_specs()}",
                 f"total graph ops: {sum(hist.values())} "
                 f"({len(hist)} kinds), constants held in the program: "
                 f"{self.constant_count()}",
                 f"dot FLOPs/run (matmuls, attention): "
                 f"{self.dot_flops()/1e9:.3f} GF",
                 "top ops: " + ", ".join(f"{k}x{v}" for k, v in top)]
        return "\n".join(lines)


class DynamicBatcher:
    """Request batching over bucketed compiled programs (the serving
    capability the reference gets from its predictor pool + TRT dynamic
    shapes). Requests enqueue single samples; a background worker drains
    up to `max_batch` at a time, pads to the nearest bucket (one compiled
    executable per bucket — no retrace storms), runs ONE program, and
    resolves per-request futures with the unpadded rows."""

    def __init__(self, predict_fn, max_batch=8, buckets=(1, 2, 4, 8),
                 timeout_ms=2.0):
        self._fn = predict_fn
        self.max_batch = max_batch
        self.buckets = sorted(buckets)
        self.timeout = timeout_ms / 1000.0
        self._q = queue.Queue()
        self._stop = False
        self.batches_run = 0
        self.rows_served = 0
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def _bucket(self, n):
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def submit(self, sample):
        """sample: [*feature_shape] (no batch dim). Returns a Future-like
        with .result(timeout)."""
        box = {"event": threading.Event(), "out": None, "err": None}
        self._q.put((np.asarray(sample), box))
        return _Future(box)

    def _loop(self):
        while not self._stop:
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = self.timeout
            while len(batch) < self.max_batch:
                try:
                    batch.append(self._q.get(timeout=deadline))
                except queue.Empty:
                    break
            samples = [s for s, _ in batch]
            boxes = [b for _, b in batch]
            n = len(samples)
            bucket = self._bucket(n)
            x = np.stack(samples)
            if bucket > n:   # pad with repeats to the bucket batch size
                pad = np.repeat(x[-1:], bucket - n, axis=0)
                x = np.concatenate([x, pad], axis=0)
            try:
                out = self._fn(x)
                out = np.asarray(out.numpy() if hasattr(out, "numpy")
                                 else out)
                self.batches_run += 1
                self.rows_served += n
                for i, box in enumerate(boxes):
                    box["out"] = out[i]
                    box["event"].set()
            except Exception as e:  # noqa: BLE001 — propagate per-request
                for box in boxes:
                    box["err"] = e
                    box["event"].set()

    def close(self):
        self._stop = True
        self._worker.join(timeout=2)


class _Future:
    def __init__(self, box):
        self._box = box

    def result(self, timeout=30.0):
        if not self._box["event"].wait(timeout):
            raise TimeoutError("inference request timed out")
        if self._box["err"] is not None:
            raise self._box["err"]
        return self._box["out"]
