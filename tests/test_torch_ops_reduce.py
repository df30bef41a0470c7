"""The port's reductions, sorting and search (``ops/impl/reduce.py``)
against the JAX package's, on the CPU: values, dtypes and shapes
(float64 1e-10 relative, float32 1e-5, integers exact), and gradients
against JAX's tape in float64.

Held where the libraries differ: ``median(mode="avg")`` averages the two
middle values; ties in ``sort``/``argsort``/``topk``/``kthvalue`` keep
positions (inputs with repeated values); ``mode`` picks the first of the
tied counts; ``histogram`` and ``histogramdd`` bin as numpy does (the
last bin closed).
"""

import pytest
import torch

from torch_parity import (SWEEP, case_id, check, check_grad,  # noqa: F401
                          cpu_device)

torch.set_num_threads(1)

S = SWEEP.REDUCE
CASES = S.CASES



@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_reduce_op_matches_jax(case):
    name, args, kwargs, _ = case
    check(name, args, kwargs)


GRAD_CASES = [c for c in CASES if c[3].get("grad")]


@pytest.mark.parametrize("case", GRAD_CASES,
                         ids=[case_id(c) for c in GRAD_CASES])
def test_reduce_op_grad_matches_jax(case):
    name, args, kwargs, _ = case
    check_grad(name, args, kwargs)
