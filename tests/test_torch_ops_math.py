"""The port's elementwise and binary math ops (``ops/impl/math.py``)
against the JAX package's, on the CPU: values, dtypes and shapes, and
the gradients of the differentiable ops against JAX's tape in float64.

Tolerances (``torch_parity``): float64 1e-10 relative, float32 1e-5,
integers and bools exact; the special functions (lgamma, digamma,
polygamma, erfinv, i0/i0e/i1/i1e) 1e-8 relative in float64. Integer
inputs check the JAX package's result types (a Python float with an
integer tensor gives float64; a floating function of int32 float32, of
int64 float64).
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from torch_parity import (SWEEP, case_id, check, check_grad,  # noqa: F401
                          cpu_device)

torch.set_num_threads(1)

S = SWEEP.MATH
A = S.A
B = S.B
CASES = S.CASES
POS = S.POS



@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_math_op_matches_jax(case):
    name, args, kwargs, opts = case
    check(name, args, kwargs, tol=opts.get("tol"))


GRAD_CASES = [c for c in CASES if c[3].get("grad")]


@pytest.mark.parametrize("case", GRAD_CASES,
                         ids=[case_id(c) for c in GRAD_CASES])
def test_math_op_grad_matches_jax(case):
    name, args, kwargs, opts = case
    tol = opts.get("tol")
    check_grad(name, args, kwargs,
               tol=(tol[0] * 10, tol[1] * 10) if tol else (1e-9, 1e-11))


def test_inplace_forms_write_into_their_argument():
    x = torch.from_numpy(A.copy())
    y = torch.from_numpy(B.copy())
    out = ptt.add_(x, y)
    assert out is x
    np.testing.assert_allclose(x.numpy(), A + B, rtol=1e-12)
    z = torch.from_numpy(POS.copy())
    assert ptt.sqrt_(z) is z
    np.testing.assert_allclose(z.numpy(), np.sqrt(POS), rtol=1e-12)
    # under autograd the op reads a clone, so the write does not break
    # the saved inputs of the product
    w = torch.from_numpy(A.copy()).requires_grad_(True)
    h = w * 1.0
    ptt.multiply_(h, w)
    h.sum().backward()
    np.testing.assert_allclose(w.grad.numpy(), 2 * A, rtol=1e-12)
