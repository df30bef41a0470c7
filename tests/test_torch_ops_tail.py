"""The port's top-level tail (``tensor_tail.py``) against the JAX
package's, on the CPU: the registered small ops (values, dtypes and
shapes: float64 1e-10 relative, ``gammainc``/``multigammaln`` 1e-8,
integers exact; gradients against JAX's tape in float64), the in-place
``_`` forms of the tail's list, and the helpers.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from torch_parity import (SWEEP, assert_same, case_id, check,  # noqa: F401
                          check_grad, cpu_device, to_np)

torch.set_num_threads(1)

S = SWEEP.TAIL
A = S.A
CASES = S.CASES
POS = S.POS
V = S.V
X3 = S.X3



@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_tail_op_matches_jax(case):
    name, args, kwargs, opts = case
    check(name, args, kwargs, tol=opts.get("tol"))


GRAD_CASES = [c for c in CASES if c[3].get("grad")]


@pytest.mark.parametrize("case", GRAD_CASES,
                         ids=[case_id(c) for c in GRAD_CASES])
def test_tail_op_grad_matches_jax(case):
    name, args, kwargs, _ = case
    check_grad(name, args, kwargs)


# an in-place form of the tail's list per family: the value written into
# the argument equals the JAX package's result
INPLACE = [
    ("log_", (POS,)), ("square_", (A,)), ("erf_", (A,)), ("t_", (A,)),
    ("transpose_", (X3, [2, 0, 1])), ("pow_", (POS, 2.0)),
    ("floor_divide_", (A, POS)), ("hypot_", (A, POS)), ("logit_",
                                                        (POS / 4,)),
    ("lgamma_", (POS,)), ("nan_to_num_", (np.array([np.nan, 1.0]),)),
    ("floor_mod_", (A, POS)), ("renorm_", (A, 2.0, 0, 1.0)),
    ("scatter_", (A, np.array([1]), V[None])), ("where_", (A > 0, A, POS)),
]


@pytest.mark.parametrize("name,args", INPLACE, ids=[n for n, _ in INPLACE])
def test_inplace_form_writes_the_jax_result(name, args):
    targs = [torch.from_numpy(a.copy()) if isinstance(a, np.ndarray) else a
             for a in args]
    out = getattr(ptt, name)(*targs)
    assert out is targs[0]
    want = getattr(paddle, name[:-1] if name != "floor_mod_" else
                   "remainder")(*[paddle.to_tensor(a) if isinstance(
                       a, np.ndarray) else a for a in args])
    assert_same(to_np(out), to_np(want))


def test_helpers_match_jax():
    x = torch.from_numpy(A)
    assert ptt.finfo("float32").eps == float(paddle.finfo("float32").eps)
    assert ptt.iinfo("int8").max == int(paddle.iinfo("int8").max)
    assert ptt.is_tensor(x) and not ptt.is_tensor(A)
    assert ptt.is_floating_point(x) and ptt.is_integer(torch.tensor([1]))
    assert ptt.is_complex(torch.tensor([1j]))
    assert int(ptt.rank(torch.zeros(2, 3, 4))) == 3
    assert ptt.broadcast_shape([2, 1, 4], [3, 1]) == \
        paddle.broadcast_shape([2, 1, 4], [3, 1])
    assert ptt.check_shape(x, [-1, 4])
    with pytest.raises(ValueError):
        ptt.check_shape(x, [4])
    for got, want in zip(ptt.tensor_split(x, 3, axis=1),
                         paddle.tensor_split(paddle.to_tensor(A), 3, axis=1)):
        assert_same(to_np(got), to_np(want))
    for fn in ("hsplit", "vsplit"):
        for got, want in zip(getattr(ptt, fn)(x, [1]),
                             getattr(paddle, fn)(paddle.to_tensor(A), [1])):
            assert_same(to_np(got), to_np(want))
    assert len(ptt.dsplit(torch.from_numpy(X3), 2)) == 2
    assert tuple(ptt.atleast_2d(torch.tensor(1.0)).shape) == (1, 1)
    assert tuple(ptt.atleast_3d(x).shape) == (3, 4, 1)
    assert ptt.tolist(torch.tensor([1, 2])) == [1, 2]
    with ptt.set_grad_enabled(False):
        assert not torch.is_grad_enabled()
    assert torch.is_grad_enabled()
    assert isinstance(x.dtype, ptt.dtype)
    state = ptt.get_cuda_rng_state()
    ptt.set_cuda_rng_state(state)
    reader = ptt.batch(lambda: iter(range(5)), 2)
    assert list(reader()) == [[0, 1], [2, 3], [4]]
    with ptt.LazyGuard():
        pass
