"""The port's activations (``ops/impl/activation.py``) and fused names
(``ops/impl/fused.py``) against the JAX package's, on the CPU.

The JAX fused names take their XLA compositions off the TPU
(``paddle_tpu/ops/impl/fused.py:17-25``); the port's reach its kernels'
plain versions on the CPU (the RMSNorm, RoPE, SwiGLU and bias + dropout
+ residual + LayerNorm wrappers, computing in float32 as the kernels
do). Activations: float64 1e-10 relative and their gradients against
JAX's tape; fused names: float32 inputs, 1e-5 relative (2e-5 for their
gradients), dropout off (its draws differ by design).
"""

import pytest
import torch

import paddle_tpu_torch as ptt
from torch_parity import (SWEEP, case_id, check, check_grad,  # noqa: F401
                          cpu_device)

torch.set_num_threads(1)

S = SWEEP.ACTIVATION
CASES = S.CASES



@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_activation_or_fused_op_matches_jax(case):
    name, args, kwargs, opts = case
    check(name, args, kwargs, tol=opts.get("tol"))


GRAD_CASES = [c for c in CASES if c[3].get("grad")]


@pytest.mark.parametrize("case", GRAD_CASES,
                         ids=[case_id(c) for c in GRAD_CASES])
def test_activation_or_fused_op_grad_matches_jax(case):
    name, args, kwargs, opts = case
    tol = opts.get("tol")
    check_grad(name, args, kwargs,
               tol=(2e-5, 2e-6) if tol else (1e-9, 1e-11),
               diff=opts.get("diff"))


def test_random_activations_and_p2p_transfer():
    ptt.seed(1)
    x = torch.randn(2000, dtype=torch.float64)
    y = ptt.rrelu(x, training=True)
    slope = (y[x < 0] / x[x < 0])
    assert float(slope.min()) >= 0.125 and float(slope.max()) <= 0.333333
    g = ptt.gumbel_softmax(torch.zeros(500, 4), hard=True)
    assert torch.equal(g.sum(-1), torch.ones(500))
    assert abs(float(g.mean(0).max()) - 0.25) < 0.08
    src = torch.ones(3, requires_grad=True)
    moved = ptt.p2p_transfer(src, "cpu")
    moved.sum().backward()
    assert torch.equal(src.grad, torch.ones(3))
