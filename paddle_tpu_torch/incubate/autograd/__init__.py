"""``paddle.incubate.autograd``: the counterpart of
``paddle_tpu/incubate/autograd/__init__.py`` (the functional forms, and
the prim switch, a flag as in the JAX package: torch's autograd needs no
decomposition into primitives)."""

from ...autograd import Hessian, Jacobian, jvp, vjp


def forward_grad(func, xs, v=None):
    return jvp(func, xs, v)


def grad(func, xs, v=None):
    return vjp(func, xs, v)


_PRIM_ENABLED = [False]


def enable_prim():
    _PRIM_ENABLED[0] = True


def disable_prim():
    _PRIM_ENABLED[0] = False


def prim_enabled():
    return _PRIM_ENABLED[0]


__all__ = ["Hessian", "Jacobian", "disable_prim", "enable_prim",
           "forward_grad", "grad", "jvp", "prim_enabled", "vjp"]
