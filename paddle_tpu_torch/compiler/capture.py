"""Capture: a Python function of tensors as one ATen-level fx graph, the
counterpart of ``jax.make_jaxpr`` in the JAX package's compiler.

``capture(fn, tensors)`` runs ``fn`` once under
``torch.fx.experimental.proxy_tensor.make_fx`` with fake tensors: no
kernel runs, nothing is allocated on the card, and a stray ``data_ptr``,
``.item()`` or Python branch on a tensor's value raises. Each kernel is a
custom op (``ops.kernels._ops``), so it lands as one node with its own
backward. The rules a capture keeps:

- no kernel may vanish: a kernel is a node, or the capture raises;
- every ``torch.autograd.Function`` outside torch keeps its own backward:
  a capture that reaches one (the mpu layers' collectives, a user's)
  raises ``GraphBreak`` rather than inline its forward;
- a program that draws random numbers breaks too (a random ATen op, or
  the bias-dropout-LayerNorm op with p > 0, whose seed the host drew):
  a replay would draw otherwise than eager does;
- the dispatch modes active around the call (``xla_introspect``'s
  counter) do not see the capture, only the replay; the capture runs
  without grad, so an enclosing checkpoint saves nothing for it.

Any failure raises ``GraphBreak`` with its reason; ``compiler.optimize``
and ``jit.to_static`` then run that signature eagerly and count it.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.utils._pytree as pytree

__all__ = ["GraphBreak", "capture", "state_key", "leaf_key"]


class GraphBreak(Exception):
    """The function cannot be captured as one program (the reason is the
    message); run it eagerly."""


_TLS = threading.local()
_LOCK = threading.Lock()
_INSTALLED = [0]
_ORIG_APPLY = torch.autograd.function.Function.__dict__["apply"]


def _capturing():
    return getattr(_TLS, "depth", 0) > 0


@classmethod
def _guarded_apply(cls, *args, **kwargs):
    if _capturing() and not cls.__module__.startswith("torch."):
        raise GraphBreak(
            f"autograd.Function {cls.__module__}.{cls.__qualname__}: a "
            "capture would inline its forward and drop its backward")
    return _ORIG_APPLY.__func__(cls, *args, **kwargs)


@contextlib.contextmanager
def _guard():
    """Refuse autograd Functions in this thread while capturing (others
    pass through the guard untouched)."""
    Function = torch.autograd.function.Function
    with _LOCK:
        if _INSTALLED[0] == 0:
            Function.apply = _guarded_apply
        _INSTALLED[0] += 1
    _TLS.depth = getattr(_TLS, "depth", 0) + 1
    try:
        yield
    finally:
        _TLS.depth -= 1
        with _LOCK:
            _INSTALLED[0] -= 1
            if _INSTALLED[0] == 0:
                Function.apply = _ORIG_APPLY


def _arg(n, name):
    """Node n's argument `name` (by schema position or keyword), or None
    when its op has no such argument."""
    for i, a in enumerate(n.target._schema.arguments):
        if a.name == name:
            if name in n.kwargs:
                return n.kwargs[name]
            return n.args[i] if i < len(n.args) else a.default_value
    return None


def _random_node(n):
    """Why node n draws random numbers, or None. An op with a dropout
    probability (attention, dropout) draws only when it is above 0."""
    t = n.target
    if not isinstance(t, torch._ops.OpOverload):
        return None
    if torch.Tag.nondeterministic_seeded in t.tags:
        p = _arg(n, "dropout_p")
        p = _arg(n, "p") if p is None else p
        if isinstance(p, (int, float)) and p == 0.0:
            return None
        if _arg(n, "train") is False:
            return None
        return f"{t} draws random numbers"
    if t.namespace == "ptt" and "bias_dropout_residual_ln" in t.name() \
            and float(n.args[6]) > 0.0:
        return f"{t} drops with a seed drawn on the host"
    return None


def capture(fn, tensors):
    """(GraphModule, output treespec) of fn(*tensors) captured with fake
    tensors; fn returns any pytree of tensors. Raises GraphBreak."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.utils._python_dispatch import _disable_current_modes
    spec = []

    def flat(*ts):
        leaves, tree = pytree.tree_flatten(fn(*ts))
        spec.append(tree)
        return leaves

    try:
        # grad off: nothing is recorded (or saved, under an enclosing
        # checkpoint's hooks) while capturing; the replay records autograd
        with _disable_current_modes(), _guard(), torch.no_grad():
            gm = make_fx(flat, tracing_mode="fake",
                         _allow_non_fake_inputs=True)(*tensors)
    except GraphBreak:
        raise
    except Exception as e:  # noqa: BLE001 — any failure breaks the graph
        raise GraphBreak(f"{type(e).__name__}: {e}"[:500]) from e
    for n in gm.graph.nodes:
        why = _random_node(n)
        if why is not None:
            raise GraphBreak(why)
    return gm, spec[-1]


def leaf_key(x):
    """A cache key for one argument: a tensor's shape, type, device and
    whether it requires grad; any other value itself (or its id)."""
    if isinstance(x, torch.Tensor):
        return ("t", tuple(x.shape), x.dtype, x.device, x.requires_grad)
    try:
        hash(x)
        return ("v", type(x).__name__, x)
    except TypeError:
        return ("id", id(x))


def state_key():
    """What a capture may have read besides its arguments: the flags'
    epoch, the amp state, grad and inference mode."""
    from ..amp import _STATE
    from ..framework.flags import FLAGS_EPOCH
    return (FLAGS_EPOCH[0], _STATE.level, _STATE.dtype, _STATE.white,
            _STATE.black, torch.is_grad_enabled(),
            torch.is_inference_mode_enabled())
