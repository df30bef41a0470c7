"""``paddle.autograd``: the counterpart of ``paddle_tpu/autograd/__init__.py``
over torch's autograd.

- ``backward`` and ``grad`` (Paddle's signatures: ``grad`` returns a list,
  one gradient per input, None for an unused one with allow_unused) over
  ``torch.autograd``;
- ``PyLayer`` / ``PyLayerContext`` over ``torch.autograd.Function``:
  ``forward(ctx, *args, **kwargs)`` and ``backward(ctx, *grads)``, the
  backward returning one gradient per tensor input (Paddle's rule; the
  non-tensor arguments get None here);
- ``saved_tensors_hooks`` over ``torch.autograd.graph``;
- the functional forms ``Jacobian`` / ``jacobian``, ``Hessian`` /
  ``hessian``, ``vjp`` and ``jvp`` over ``torch.func`` (their layouts are
  the JAX package's: one input gives one block, several a tuple).
  ``jacobian`` also takes tensors (ys computed from xs) and differentiates
  the recorded graph, where the JAX package raises.
"""

from __future__ import annotations

import torch

no_grad = torch.no_grad
enable_grad = torch.enable_grad


def is_grad_enabled():
    return torch.is_grad_enabled()


def _listed(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def backward(tensors, grad_tensors=None, retain_graph=False):
    """Accumulate the gradients of `tensors` into the leaves' ``.grad``."""
    tensors = _listed(tensors)
    if grad_tensors is not None:
        grad_tensors = _listed(grad_tensors)
    torch.autograd.backward(tensors, grad_tensors, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """The gradients of `outputs` with respect to `inputs`, without
    writing ``.grad``: a list, one per input. create_graph records the
    backward, for a second one."""
    outputs, inputs = _listed(outputs), _listed(inputs)
    if grad_outputs is not None:
        grad_outputs = _listed(grad_outputs)
    if retain_graph is None:
        retain_graph = create_graph
    out = torch.autograd.grad(outputs, inputs, grad_outputs,
                              retain_graph=retain_graph,
                              create_graph=create_graph,
                              allow_unused=True)
    if not allow_unused and any(g is None for g in out):
        raise RuntimeError(
            "One of the differentiated tensors appears to not have been "
            "used in the graph. Set allow_unused=True to return None for "
            "it.")
    return list(out)


class PyLayerContext:
    """What a PyLayer's forward and backward share (torch's ctx inside)."""

    def __init__(self, ctx=None):
        self._ctx = ctx
        self._saved = []
        self.materialize_grads = True
        self.not_inplace_tensors = ()

    def save_for_backward(self, *tensors):
        if self._ctx is not None and all(
                t is None or isinstance(t, torch.Tensor) for t in tensors):
            self._ctx.save_for_backward(*tensors)
            self._saved = None
        else:
            self._saved = list(tensors)

    def saved_tensor(self):
        """Paddle's method form: the tensors saved in the forward."""
        if self._saved is None:
            return list(self._ctx.saved_tensors)
        return self._saved

    def mark_not_inplace(self, *args):
        self.not_inplace_tensors = args

    def set_materialize_grads(self, value):
        self.materialize_grads = bool(value)
        if self._ctx is not None:
            self._ctx.set_materialize_grads(bool(value))


def _function_of(cls):
    """The ``torch.autograd.Function`` running PyLayer subclass `cls`."""
    fn = cls.__dict__.get("_torch_function")
    if fn is not None:
        return fn

    def forward(ctx, kwargs, *args):
        pctx = PyLayerContext(ctx)
        ctx.pctx = pctx
        ctx.tensor_args = [isinstance(a, torch.Tensor) for a in args]
        return cls.forward(pctx, *args, **kwargs)

    def backward(ctx, *grads):
        out = cls.backward(ctx.pctx, *grads)
        out = list(out) if isinstance(out, (tuple, list)) else [out]
        n_tensors = sum(ctx.tensor_args)
        aligned, it = [None], iter(out)
        if len(out) == n_tensors:
            for is_t in ctx.tensor_args:
                aligned.append(next(it) if is_t else None)
        else:            # one gradient per argument
            aligned.extend(out + [None] * (len(ctx.tensor_args) - len(out)))
        return tuple(aligned)

    fn = type(f"{cls.__name__}Function", (torch.autograd.Function,),
              {"forward": staticmethod(forward),
               "backward": staticmethod(backward)})
    cls._torch_function = fn
    return fn


class PyLayer:
    """A user-defined differentiable function::

        class Exp(PyLayer):
            @staticmethod
            def forward(ctx, x):
                y = ptt.exp(x)
                ctx.save_for_backward(y)
                return y

            @staticmethod
            def backward(ctx, dy):
                (y,) = ctx.saved_tensor()
                return dy * y

        y = Exp.apply(x)
    """

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *args):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        return _function_of(cls).apply(kwargs, *args)


class saved_tensors_hooks(torch.autograd.graph.saved_tensors_hooks):
    """Pack and unpack hooks for the tensors autograd saves (activation
    offload)."""


# ---- functional forms -------------------------------------------------------

def _inputs(xs):
    return tuple(xs) if isinstance(xs, (list, tuple)) else (xs,)


class Jacobian:
    """The Jacobian of `func` at `xs`: [*out.shape, *x.shape] for one
    input, a tuple over the inputs for several (``torch.func.jacrev``)."""

    def __init__(self, func, xs, is_batched=False):
        vals = _inputs(xs)
        jac = torch.func.jacrev(func, argnums=tuple(range(len(vals))))(
            *vals)
        if len(vals) == 1 and isinstance(jac, tuple):
            jac = jac[0]
        self._jac = jac

    def __getitem__(self, idx):
        return self._jac[idx]

    @property
    def value(self):
        return self._jac

    @property
    def shape(self):
        return self._jac.shape


class Hessian:
    """The Hessian of scalar `func` at `xs` (``torch.func.hessian``)."""

    def __init__(self, func, xs, is_batched=False):
        vals = _inputs(xs)
        hes = torch.func.hessian(func, argnums=tuple(range(len(vals))))(
            *vals)
        if len(vals) == 1 and isinstance(hes, tuple):
            hes = hes[0]
            if isinstance(hes, tuple):
                hes = hes[0]
        self._hes = hes

    def __getitem__(self, idx):
        return self._hes[idx]

    @property
    def value(self):
        return self._hes


def _tape_jacobian(ys, xs):
    """[*y.shape, *x.shape] blocks of dy/dx from the recorded graph."""
    ys_l, xs_l = _inputs(ys), _inputs(xs)
    blocks = []
    for y in ys_l:
        flat = y.reshape(-1)
        rows = [torch.autograd.grad(flat[i], xs_l, retain_graph=True,
                                    allow_unused=True)
                for i in range(flat.numel())]
        row_blocks = []
        for j, x in enumerate(xs_l):
            g = [r[j] if r[j] is not None else torch.zeros_like(x)
                 for r in rows]
            row_blocks.append(torch.stack(g).reshape(y.shape + x.shape))
        blocks.append(row_blocks[0] if len(xs_l) == 1 and not isinstance(
            xs, (list, tuple)) else tuple(row_blocks))
    return blocks[0] if not isinstance(ys, (list, tuple)) else tuple(blocks)


def jacobian(ys, xs, batch_axis=None):
    """The Jacobian of `ys` with respect to `xs`: ys a callable (the
    functional form, ``Jacobian``) or tensors computed from xs (the
    recorded graph)."""
    if callable(ys):
        return Jacobian(ys, xs, is_batched=batch_axis is not None)
    return _tape_jacobian(ys, xs)


def hessian(func, xs, batch_axis=None):
    return Hessian(func, xs, is_batched=batch_axis is not None)


def vjp(func, xs, v=None):
    """(func(xs), the vector-Jacobian products with v, ones by default: a
    list, one per input)."""
    vals = _inputs(xs)
    out, fn = torch.func.vjp(func, *vals)
    if v is None:
        v = torch.ones_like(out) if isinstance(out, torch.Tensor) else \
            type(out)(torch.ones_like(o) for o in out)
    elif isinstance(v, list):
        v = tuple(v)
    return out, list(fn(v))


def jvp(func, xs, v=None):
    """(func(xs), the Jacobian-vector product with v, ones by
    default)."""
    vals = _inputs(xs)
    tangents = tuple(torch.ones_like(t) for t in vals) if v is None else \
        _inputs(v)
    return torch.func.jvp(func, vals, tangents)


__all__ = ["Hessian", "Jacobian", "PyLayer", "PyLayerContext", "backward",
           "enable_grad", "grad", "hessian", "is_grad_enabled", "jacobian",
           "jvp", "no_grad", "saved_tensors_hooks", "vjp"]
