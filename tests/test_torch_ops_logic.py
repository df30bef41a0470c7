"""The port's comparison, logical and bitwise ops (``ops/impl/logic.py``)
against the JAX package's, on the CPU: exact (bool and integer
outputs)."""

import pytest
import torch

from torch_parity import SWEEP, case_id, check, cpu_device  # noqa: F401

torch.set_num_threads(1)

S = SWEEP.LOGIC
CASES = S.CASES



@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_logic_op_matches_jax(case):
    name, args, kwargs, _ = case
    check(name, args, kwargs)
