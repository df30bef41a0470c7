"""paddle.amp.debugging: the counterpart of
``paddle_tpu/amp/debugging.py`` (ref: python/paddle/amp/debugging.py —
TensorChecker, enable_operator_stats_collection, compare_accuracy).

The JAX package hooks every op its dispatcher runs. The port has no
dispatcher: its hook points are the named op sites of ``amp.amp_cast``
(the functionals, layers and models call it under the JAX op names where
the JAX package dispatches those ops) and every call through the op
surface (``paddle_tpu_torch.<op>``, ``ops.registry``: counted under its
name, its outputs scanned as the JAX dispatcher scans them). There:

- ``FLAGS_check_nan_inf`` (``check_numerics_guard``,
  ``enable_tensor_checker``) scans the op's floating tensors and raises a
  ``FloatingPointError`` naming the op. JAX scans each op's OUTPUT, the
  port the tensors a named op READS: for a NaN or an Inf that enters
  through a parameter or an input, both name the op that consumes it; one
  that an op makes from finite inputs is named at the next counted op.
- the operator stats count calls per op name, published as the JAX
  dispatcher publishes its counts (``dispatch_op_calls{op=}``).

The port counts ``linear``, ``matmul``, ``embedding``, ``add`` (the
models' residual and embedding sums), ``layer_norm``, ``rms_norm``,
``dropout``, ``gelu``, ``relu``, ``tanh``, ``swiglu``, ``fused_rope``,
``scaled_dot_product_attention``, ``flashmask_attention`` and
``fused_linear_cross_entropy`` (``fused_rope`` twice where the port
rotates q and k in one call, since the JAX model rotates them apart), as
many times as the JAX dispatcher counts them. Every other op name the
JAX dispatcher counts is a plain tensor operation on the port and is not
counted: for the Llama forward ``getitem`` and ``reshape``, for GPT's
also ``arange`` and ``unsqueeze`` (and, in other code, the rest of the
tensor surface: indexing, reshapes, casts, arithmetic, reductions). A
known difference, listed in ROADMAP §C.
"""

from __future__ import annotations

import contextlib

import numpy as np

from ..framework.flags import set_flags, get_flag


class DebugMode:
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL_FOR_OVERFLOW = 2
    CHECK_ALL = 3


class TensorCheckerConfig:
    """ref: debugging.py TensorCheckerConfig — which tensors to scan and
    what to do when nan/inf appears."""

    def __init__(self, enable=True, debug_mode=DebugMode.CHECK_NAN_INF,
                 output_dir=None, checked_op_list=None,
                 skipped_op_list=None, debug_step=None, stack_height_limit=1):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir
        self.checked_op_list = checked_op_list
        self.skipped_op_list = skipped_op_list
        self.debug_step = debug_step

    def _apply(self, on):
        set_flags({"FLAGS_check_nan_inf": bool(on and self.enable)})


def enable_tensor_checker(config):
    config._apply(True)


def disable_tensor_checker():
    set_flags({"FLAGS_check_nan_inf": False})


@contextlib.contextmanager
def check_numerics_guard(config=None):
    cfg = config or TensorCheckerConfig()
    prev = get_flag("FLAGS_check_nan_inf")
    cfg._apply(True)
    try:
        yield
    finally:
        set_flags({"FLAGS_check_nan_inf": bool(prev)})


# ---------------- operator stats (ref enable_operator_stats_collection) ---

from . import OP_STATS as _OP_STATS


def enable_operator_stats_collection():
    _OP_STATS["enabled"] = True
    _OP_STATS["counts"] = {}


def disable_operator_stats_collection():
    _OP_STATS["enabled"] = False


def get_operator_stats():
    return dict(_OP_STATS["counts"])


@contextlib.contextmanager
def collect_operator_stats():
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()


# ---------------- two-run accuracy comparison (ref compare_accuracy) ------

def _to_numpy(o):
    """A tensor (any type and device) or array as a float32 numpy array."""
    import torch
    if isinstance(o, torch.Tensor):
        return o.detach().float().cpu().numpy()
    return np.asarray(o)


def compare_accuracy(run_fn, dtypes=("float32", "bfloat16"), rtol=1e-2,
                     atol=1e-2, verbose=True):
    """Run `run_fn(dtype)` once per dtype and report elementwise drift of
    the returned tensors/arrays — the reference's workflow of dumping both
    runs and diffing, collapsed into one call."""
    results = {}
    for dt in dtypes:
        out = run_fn(dt)
        results[dt] = [_to_numpy(o) for o in
                       (out if isinstance(out, (list, tuple)) else [out])]
    base, other = dtypes[0], dtypes[1]
    report = []
    for i, (a, b) in enumerate(zip(results[base], results[other])):
        a32 = a.astype(np.float32)
        b32 = b.astype(np.float32)
        abs_diff = np.abs(a32 - b32)
        rel = abs_diff / np.maximum(np.abs(a32), 1e-12)
        entry = {"index": i, "max_abs_diff": float(abs_diff.max()),
                 "max_rel_diff": float(rel.max()),
                 "mismatch": bool((abs_diff > atol + rtol *
                                   np.abs(a32)).any())}
        report.append(entry)
        if verbose:
            print(f"[compare_accuracy] out{i}: max_abs="
                  f"{entry['max_abs_diff']:.3e} max_rel="
                  f"{entry['max_rel_diff']:.3e} "
                  f"{'MISMATCH' if entry['mismatch'] else 'ok'}")
    return report


__all__ = ["DebugMode", "TensorCheckerConfig", "check_numerics_guard",
           "collect_operator_stats", "compare_accuracy",
           "disable_operator_stats_collection", "disable_tensor_checker",
           "enable_operator_stats_collection", "enable_tensor_checker",
           "get_operator_stats"]
