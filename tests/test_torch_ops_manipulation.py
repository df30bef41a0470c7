"""The port's shape, indexing and scatter ops
(``ops/impl/manipulation.py``) against the JAX package's, on the CPU:
values, dtypes and shapes (float64 1e-10 relative, integers and bools
exact), and gradients against JAX's tape for the differentiable ones in
float64.

Scatters with duplicate indices: which duplicate wins an overwrite is
undefined on CUDA, so the overwrite forms (``scatter``, ``index_put``,
``put_along_axis`` assign) are held without duplicates and the
accumulating forms with them. Paddle's ``pad`` list order (per-dim
pairs over every dim, or from the last spatial dim backwards) is held in
every mode.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from torch_parity import (SWEEP, assert_same, case_id, check,  # noqa: F401
                          check_grad, cpu_device, to_np)

torch.set_num_threads(1)

S = SWEEP.MANIPULATION
A = S.A
CASES = S.CASES



@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_manipulation_op_matches_jax(case):
    name, args, kwargs, _ = case
    check(name, args, kwargs)


GRAD_CASES = [c for c in CASES if c[3].get("grad")]


@pytest.mark.parametrize("case", GRAD_CASES,
                         ids=[case_id(c) for c in GRAD_CASES])
def test_manipulation_op_grad_matches_jax(case):
    name, args, kwargs, _ = case
    check_grad(name, args, kwargs)


def test_inplace_shape_forms_and_no_tensor_patching():
    x = torch.from_numpy(A.copy())
    assert ptt.reshape_(x, [4, 3]) is x and tuple(x.shape) == (4, 3)
    assert ptt.unsqueeze_(x, 0) is x and tuple(x.shape) == (1, 4, 3)
    assert ptt.cast_(x, "float32") is x and x.dtype == torch.float32
    y = torch.from_numpy(A.copy())
    ptt.index_put_(y, (torch.tensor([0]), torch.tensor([0])),
                   torch.tensor([5.0], dtype=torch.float64))
    assert float(y[0, 0]) == 5.0
    # torch's own methods keep torch's semantics
    t = torch.arange(6.0).reshape(2, 3)
    assert len(t.split(1)) == 2 and len(ptt.split(t, 3, axis=1)) == 3
    assert_same(to_np(ptt.gather(t, torch.tensor([1]), 1)),
                to_np(paddle.gather(paddle.to_tensor(t.numpy()),
                                    paddle.to_tensor(np.array([1])), 1)))
