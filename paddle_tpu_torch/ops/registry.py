"""The op registry: the counterpart of ``paddle_tpu/ops/registry.py``.

``@register_op(name, amp=, inplace=)`` records an op in ``OP_TABLE``
under the JAX package's name and returns its public function. That
function is what the JAX dispatcher is for each call
(``paddle_tpu/core/dispatch.py:595-631``), minus the tape:

- its tensor arguments (and tensors inside list or tuple arguments) go
  through ``amp.amp_cast(name, ...)``: under ``auto_cast`` the op's
  float32 inputs are cast as the JAX dispatcher casts them (ops
  registered with amp=False are not cast), and ``amp.debugging``'s
  operator stats count the call under the op's name;
- under ``FLAGS_check_nan_inf`` its floating outputs are scanned and a
  ``FloatingPointError`` names the op, as the JAX dispatcher scans them;
- under ``FLAGS_benchmark`` the call waits for the card to finish its
  work ("sync after each op for timing", the JAX flag's doc);
- the op's body runs with ``amp._STATE.in_op`` raised, so the named op
  sites it reaches inside (the functionals a fused op calls) are not
  counted or cast again: the JAX package's bodies are plain ``jnp`` code
  that the dispatcher never sees.

Autograd is torch's own: nothing is recorded here.

``inplace=True`` also makes ``name_(x, ...)``, which computes the op and
writes the result into ``x`` and returns ``x`` (the JAX package rebinds
``x`` instead). The ops are functions over ``torch.Tensor``: nothing is
installed on ``torch.Tensor``.
"""

from __future__ import annotations

import functools

import torch

from .. import amp as _amp
from ..framework.flags import _FLAGS

OP_TABLE = {}   # name -> {"fn", "api", "amp", "inplace", "doc"}


def _flat_tensors(args, kwargs):
    """The tensors of a call's arguments (top level, and one level into
    lists and tuples), in order."""
    out = []
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(e for e in a if isinstance(e, torch.Tensor))
    return out


def _replace(args, kwargs, new):
    """args/kwargs with their tensors replaced, in order, by `new`."""
    it = iter(new)

    def sub(a):
        if isinstance(a, torch.Tensor):
            return next(it)
        if isinstance(a, (list, tuple)) and any(
                isinstance(e, torch.Tensor) for e in a):
            return type(a)(next(it) if isinstance(e, torch.Tensor) else e
                           for e in a)
        return a

    args = tuple(sub(a) for a in args)
    kwargs = {k: sub(v) for k, v in kwargs.items()}
    return args, kwargs


def _check_outputs(name, out):
    vals = out if isinstance(out, (tuple, list)) else [out]
    for i, v in enumerate(vals):
        if isinstance(v, torch.Tensor) and v.is_floating_point() and \
                not bool(torch.isfinite(v).all()):
            raise FloatingPointError(
                f"op '{name}' output {i} contains NaN/Inf "
                "(FLAGS_check_nan_inf=1)")


def _sync_outputs(out):
    """Wait for the card that holds the op's first CUDA output."""
    vals = out if isinstance(out, (tuple, list)) else [out]
    for v in vals:
        if isinstance(v, torch.Tensor) and v.is_cuda:
            torch.cuda.synchronize(v.device)
            return


def _wrap(name, fn, amp):
    state = _amp._STATE

    @functools.wraps(fn)
    def api(*args, **kwargs):
        if state.in_op:              # an op's body calling another op
            return fn(*args, **kwargs)
        tensors = _flat_tensors(args, kwargs)
        cast = _amp.amp_cast(name, *tensors, cast=amp, check=False)
        if tensors:
            cast = (cast,) if len(tensors) == 1 else cast
            if any(a is not b for a, b in zip(cast, tensors)):
                args, kwargs = _replace(args, kwargs, cast)
        state.in_op += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            state.in_op -= 1
        if _FLAGS["check_nan_inf"]:
            _check_outputs(name, out)
        if _FLAGS["benchmark"]:
            _sync_outputs(out)
        return out

    api.__name__ = name
    return api


def write_into(x, out):
    """Write `out` into `x` and return `x`: the in-place form of an op.
    Same shape and type: ``copy_`` (autograd records it, and refuses it on
    a leaf that requires grad, as Paddle does); a new shape or type (a
    reshape or a cast in place): ``x`` takes `out`'s data, outside
    autograd."""
    if not isinstance(x, torch.Tensor):
        return out
    if out.shape == x.shape and out.dtype == x.dtype:
        return x.copy_(out)
    x.data = out.detach()
    return x


def _needs_clone(args, kwargs):
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in _flat_tensors(args, kwargs))


def make_inplace(name, api):
    """``name_(x, ...)``: `api`'s result written into x (``write_into``).
    Under autograd x is read through a clone, so that the op's saved
    inputs are not the tensor the write changes."""
    def inplace_api(x, *args, **kwargs):
        src = x.clone() if isinstance(x, torch.Tensor) and \
            _needs_clone((x,) + args, kwargs) else x
        return write_into(x, api(src, *args, **kwargs))

    inplace_api.__name__ = name + "_"
    inplace_api.__qualname__ = name + "_"
    inplace_api.__doc__ = (f"In-place form of ``{name}``: the result is "
                           f"written into the first argument, which is "
                           f"returned.")
    return inplace_api


def register_op(name, amp=True, inplace=False, wrap=True):
    """Register op `name`: returns its public function (``_wrap``), or
    `fn` itself with wrap=False (an op that handles its tensors itself,
    as the JAX package's ``wrap=False`` ops do, uncounted); inplace=True
    adds ``name_`` (``make_inplace``)."""

    def deco(fn):
        api = _wrap(name, fn, amp) if wrap else fn
        entry = {"fn": fn, "api": api, "amp": amp, "inplace": inplace,
                 "doc": fn.__doc__ or ""}
        if inplace:
            entry["inplace_api"] = make_inplace(name, api)
        OP_TABLE[name] = entry
        return api

    return deco


def export_namespace(ns, modules=None):
    """Put every registered op's public function (and ``name_``) into the
    namespace dict `ns`; with `modules`, only the ops whose body is
    defined in one of those modules."""
    for name, entry in OP_TABLE.items():
        if modules is not None and entry["fn"].__module__ not in modules:
            continue
        ns[name] = entry["api"]
        if "inplace_api" in entry:
            ns[name + "_"] = entry["inplace_api"]


__all__ = ["OP_TABLE", "export_namespace", "make_inplace",
           "register_op", "write_into"]
