"""Shared harness of the op-surface parity tests (``test_torch_ops_*.py``,
``test_torch_autograd.py``, ``test_torch_device.py``): the same numpy
inputs through ``paddle_tpu.<op>`` (JAX on the CPU, x64 on) and
``paddle_tpu_torch.<op>`` (torch on the CPU), outputs compared in shape,
dtype and value.

Tolerances, by the output's type: float64 1e-10 relative (1e-12
absolute), float32 1e-5 relative (1e-6 absolute), complex as its real
type, integers and bools exact. ``SPECIAL`` (the special functions:
lgamma, digamma, polygamma, erfinv, the Bessel and incomplete-gamma
families) take 1e-8 relative in float64, where the two libraries'
series differ in the last digits.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor as JTensor

import paddle_tpu_torch as ptt
from paddle_tpu_torch import device as tdevice

def _load_sweep():
    """``ops_sweep_torch`` (the case tables, at the repo's root)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "ops_sweep_torch.py")
    spec = importlib.util.spec_from_file_location("ops_sweep_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SWEEP = _load_sweep()

TOL = {"float64": (1e-10, 1e-12), "float32": (1e-5, 1e-6),
       "float16": (1e-3, 1e-3), "bfloat16": (1e-2, 1e-2),
       "complex128": (1e-10, 1e-12), "complex64": (1e-5, 1e-6)}
SPECIAL_TOL = SWEEP.SPECIAL_TOL


@pytest.fixture(autouse=True)
def cpu_device():
    """Every case runs on the port's CPU path; the current device is
    restored after."""
    prev = tdevice._CURRENT[0]
    ptt.set_device("cpu")
    yield
    tdevice._CURRENT[0] = prev


def rng(seed=0):
    return np.random.default_rng(seed)


def to_jax(v, grad=False):
    if isinstance(v, np.ndarray):
        return paddle.to_tensor(v, stop_gradient=not (
            grad and v.dtype.kind == "f"))
    if isinstance(v, dict):
        return {k: to_jax(e) for k, e in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(to_jax(e, grad) for e in v)
    return v


def to_port(v, grad=False):
    if isinstance(v, np.ndarray):
        t = torch.from_numpy(v.copy())
        if grad and v.dtype.kind == "f":
            t.requires_grad_(True)
        return t
    if isinstance(v, dict):
        return {k: to_port(e) for k, e in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(to_port(e, grad) for e in v)
    return v


def to_np(v):
    if isinstance(v, JTensor):
        return np.asarray(v.numpy())
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().resolve_conj().resolve_neg()
        if v.dtype == torch.bfloat16:
            return ("bfloat16", v.float().numpy())
        return v.numpy()
    if isinstance(v, (list, tuple)):
        return [to_np(e) for e in v]
    return np.asarray(v)


def _dtype_name(a):
    if isinstance(a, tuple) and a and a[0] == "bfloat16":
        return "bfloat16"
    return np.asarray(a).dtype.name


def _values(a):
    if isinstance(a, tuple) and a and a[0] == "bfloat16":
        return a[1]
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def assert_same(got, want, tol=None, check_dtype=True, where="out"):
    """`got` (the port's, as numpy) equals `want` (JAX's): nesting, shape,
    dtype and values (see the module docstring)."""
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (
            f"{where}: {len(got) if isinstance(got, list) else got} "
            f"outputs, want {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, tol, check_dtype, f"{where}[{i}]")
        return
    gd, wd = _dtype_name(got), _dtype_name(want)
    g, w = _values(got), _values(want)
    assert g.shape == w.shape, f"{where}: shape {g.shape}, want {w.shape}"
    if check_dtype:
        assert gd == wd, f"{where}: dtype {gd}, want {wd}"
    if w.dtype.kind in "fc":
        rtol, atol = tol or TOL.get(wd, TOL["float32"])
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   equal_nan=True, err_msg=where)
    else:
        np.testing.assert_array_equal(g, w, err_msg=where)


def call_both(name, args, kwargs=None, ns=("", "")):
    """(port output, JAX output) of op `name` on the same inputs; ns
    names a namespace ("fft", "linalg", "signal") on both sides."""
    kwargs = kwargs or {}
    jmod = getattr(paddle, ns[0]) if ns[0] else paddle
    tmod = getattr(ptt, ns[1]) if ns[1] else ptt
    want = getattr(jmod, name)(*to_jax(args), **to_jax(kwargs))
    got = getattr(tmod, name)(*to_port(args), **to_port(kwargs))
    return got, want


def check(name, args, kwargs=None, tol=None, check_dtype=True,
          ns=("", "")):
    got, want = call_both(name, args, kwargs, ns)
    assert_same(to_np(got), to_np(want), tol, check_dtype, name)
    return got, want


def _weights(out, r):
    """Fixed random cotangents for the float outputs of `out`."""
    outs = out if isinstance(out, (list, tuple)) else [out]
    return [r.standard_normal(tuple(o.shape)) if o is not None and (
        np.asarray(to_np(o)).dtype.kind == "f") else None for o in outs]


def check_grad(name, args, kwargs=None, tol=(1e-9, 1e-11), ns=("", ""),
               diff=None):
    """The gradients of sum(w * op(args)) with respect to every float
    array argument (those at the positions `diff` when given; fixed
    random w) equal JAX's tape's."""
    kwargs = kwargs or {}
    jmod = getattr(paddle, ns[0]) if ns[0] else paddle
    tmod = getattr(ptt, ns[1]) if ns[1] else ptt
    on = [diff is None or i in diff for i in range(len(args))]
    jargs = tuple(to_jax(a, grad=g) for a, g in zip(args, on))
    targs = tuple(to_port(a, grad=g) for a, g in zip(args, on))

    def leaves(v, cls):
        if isinstance(v, (list, tuple)):
            return [x for e in v for x in leaves(e, cls)]
        return [v] if isinstance(v, cls) and (
            not getattr(v, "stop_gradient", True) if cls is JTensor
            else v.requires_grad) else []

    jx, tx = leaves(jargs, JTensor), leaves(targs, torch.Tensor)
    jout = getattr(jmod, name)(*jargs, **to_jax(kwargs))
    tout = getattr(tmod, name)(*targs, **to_port(kwargs))
    ws = _weights(jout, rng(7))
    jouts = jout if isinstance(jout, (list, tuple)) else [jout]
    touts = tout if isinstance(tout, (list, tuple)) else [tout]
    jloss = sum((o * paddle.to_tensor(w)).sum()
                for o, w in zip(jouts, ws) if w is not None)
    tloss = sum((o * torch.from_numpy(w)).sum()
                for o, w in zip(touts, ws) if w is not None)
    jg = paddle.grad(jloss, jx, allow_unused=True)
    tg = torch.autograd.grad(tloss, tx, allow_unused=True)
    for i, (g, w) in enumerate(zip(tg, jg)):
        if w is None or g is None:     # unused: the other side is zero
            other = g if w is None else w
            assert other is None or not np.any(to_np(other)), \
                f"{name} grad {i}"
            continue
        assert_same(to_np(g), to_np(w), tol, True, f"{name} grad {i}")


def case_id(case):
    return case[0] if len(case) < 4 or not case[3].get("id") else \
        f"{case[0]}-{case[3]['id']}"
