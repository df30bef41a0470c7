"""The port's creation ops (``ops/impl/creation.py``), ``to_tensor``,
``tensor`` and ``create_parameter`` against the JAX package's, on the
CPU: values, dtypes and shapes (float64 1e-10, float32 1e-5 relative,
integers exact).

The random ops draw from the port's generators, not ``jax.random``'s
streams, so they are held to their distributions instead: the moments
of 20,000 draws within 5 standard errors of the law's (the same seed
gives the same draws; a nonzero ``seed=`` argument its own stream), and
their shapes and dtypes to the JAX package's.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from torch_parity import (SWEEP, assert_same, case_id, check,  # noqa: F401
                          cpu_device, to_np)

torch.set_num_threads(1)

S = SWEEP.CREATION
CASES = S.CASES



@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_creation_op_matches_jax(case):
    name, args, kwargs, _ = case
    check(name, args, kwargs)


TO_TENSOR = [
    ([1.5, 2.0], {}, "pyfloat"), ([1, 2, 3], {}, "pyint"),
    (np.array([1, 2], np.int32), {}, "np-int32"),
    (np.array([1.0], np.float64), {}, "np-f64"), (True, {}, "bool"),
    ([[1, 2]], {"dtype": "float64"}, "dtype"), (3.0, {}, "scalar"),
]


@pytest.mark.parametrize("data,kw,tag", TO_TENSOR,
                         ids=[t for _, _, t in TO_TENSOR])
def test_to_tensor_dtype_rules_match_jax(data, kw, tag):
    assert_same(to_np(ptt.to_tensor(data, **kw)),
                to_np(paddle.to_tensor(data, **kw)))
    assert_same(to_np(ptt.tensor(data, **kw)),
                to_np(paddle.tensor(data, **kw)))


def test_to_tensor_grad_place_and_create_parameter():
    t = ptt.to_tensor([1.0, 2.0], stop_gradient=False)
    assert t.requires_grad and t.device.type == "cpu"
    src = torch.ones(2, requires_grad=True)
    c = ptt.to_tensor(src, dtype="float64")
    assert c.dtype == torch.float64 and not c.requires_grad
    assert ptt.to_tensor([1], place="cpu").device.type == "cpu"
    assert ptt.to_tensor([1], place=ptt.CPUPlace()).device.type == "cpu"
    p = ptt.create_parameter([3, 4], "float32")
    assert isinstance(p, torch.nn.Parameter) and p.shape == (3, 4)
    assert ptt.create_parameter([4], "float32", is_bias=True).abs().sum() \
        == 0
    jp = paddle.create_parameter([4], "float32", is_bias=True)
    assert_same(to_np(ptt.create_parameter([4], "float32", is_bias=True)),
                to_np(jp))


def _moments(x):
    v = x.double().reshape(-1)
    return float(v.mean()), float(v.std())


# (op, args, kwargs, mean, std, JAX dtype check)
RANDOM = [
    ("rand", ([20000],), {}, 0.5, (1 / 12) ** 0.5),
    ("randn", ([20000],), {}, 0.0, 1.0),
    ("standard_normal", ([20000],), {"dtype": "float64"}, 0.0, 1.0),
    ("normal", (1.0, 2.0, [20000]), {}, 1.0, 2.0),
    ("uniform", ([20000],), {"min": -2.0, "max": 4.0}, 1.0, 6 / 12 ** 0.5),
    ("randint", (0, 10, [20000]), {}, 4.5, (99 / 12) ** 0.5),
    ("randperm", (20000,), {}, 9999.5, None),
]


@pytest.mark.parametrize("case", RANDOM, ids=[c[0] for c in RANDOM])
def test_random_op_distribution_shape_and_dtype(case):
    name, args, kwargs, mu, sd = case
    ptt.seed(11)
    x = getattr(ptt, name)(*args, **kwargs)
    want = getattr(paddle, name)(*args, **kwargs)
    assert tuple(x.shape) == tuple(want.shape)
    assert str(x.dtype).replace("torch.", "") == np.asarray(
        want.numpy()).dtype.name
    m, s = _moments(x)
    n = x.numel()
    if sd is None:                       # a permutation
        assert sorted(x.tolist()) == list(range(n))
        return
    assert abs(m - mu) < 5 * sd / n ** 0.5, (m, mu)
    assert abs(s - sd) < 5 * sd / (2 * n) ** 0.5 * 1.5, (s, sd)
    ptt.seed(11)
    assert torch.equal(getattr(ptt, name)(*args, **kwargs), x)


def test_random_ops_of_a_tensor_follow_their_laws():
    ptt.seed(3)
    p = torch.full((20000,), 0.3, dtype=torch.float64)
    b = ptt.bernoulli(p)
    assert b.dtype == torch.float64 and abs(float(b.mean()) - 0.3) < 0.02
    lam = torch.full((20000,), 4.0)
    assert abs(float(ptt.poisson(lam).mean()) - 4.0) < 0.1
    probs = torch.tensor([[0.1, 0.2, 0.7]] * 4000)
    m = ptt.multinomial(probs, 1, replacement=True)
    assert m.dtype == torch.int64
    assert abs(float((m == 2).double().mean()) - 0.7) < 0.03
    nr = ptt.multinomial(torch.tensor([0.2, 0.3, 0.5]), 3)
    assert sorted(nr.tolist()) == [0, 1, 2]
    r = ptt.randint_like(torch.zeros(20000, dtype=torch.int32), 0, 4)
    assert r.dtype == torch.int32 and set(r.unique().tolist()) == \
        {0, 1, 2, 3}
    x = torch.zeros(20000)
    assert ptt.normal_(x, 2.0, 0.5) is x
    assert abs(float(x.mean()) - 2.0) < 0.02
    assert ptt.exponential_(x, 2.0) is x and abs(float(x.mean()) - 0.5) < \
        0.02
    ptt.uniform_(x, 0.0, 1.0, seed=5)
    y = torch.zeros(20000)
    ptt.uniform_(y, 0.0, 1.0, seed=5)
    assert torch.equal(x, y) and 0.0 <= float(x.min())
    u1 = ptt.uniform([8], seed=7)
    assert torch.equal(u1, ptt.uniform([8], seed=7))


def test_creation_goes_to_the_current_device():
    ptt.set_device("cpu")
    assert ptt.zeros([2]).device.type == "cpu"
    assert ptt.arange(3, device="cpu").device.type == "cpu"
    ptt.set_default_dtype("float64")
    try:
        assert ptt.zeros([1]).dtype == torch.float64
        assert ptt.to_tensor(1.5).dtype == torch.float64
    finally:
        ptt.set_default_dtype("float32")
    with pytest.raises(TypeError):
        ptt.set_default_dtype("int32")
