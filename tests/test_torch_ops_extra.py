"""The port's long-tail ops (``ops/impl/extra.py``) against the JAX
package's, on the CPU: values, dtypes and shapes (float64 1e-10
relative, ``gammaincc`` 1e-8, float32 1e-5, integers exact).

The loss scaler's ops (``check_finite_and_unscale_``,
``update_loss_scaling_``) are held to the JAX package's and to
``amp.GradScaler``'s own unscale and update on the same gradients. The
samplers whose JAX reference is red on this jax (``binomial``: the JAX
op raises under x64) or draws from ``jax.random`` are held to scipy's
moments: the mean and variance of 20,000 draws within 5 standard errors.
"""

import numpy as np
import pytest
import scipy.stats
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu_torch import amp as tamp
from torch_parity import (SWEEP, case_id, check, check_grad,  # noqa: F401
                          cpu_device, rng, to_np)

torch.set_num_threads(1)

S = SWEEP.EXTRA
CASES = S.CASES
R = rng(21)



@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_extra_op_matches_jax(case):
    name, args, kwargs, opts = case
    check(name, args, kwargs, tol=opts.get("tol"))


GRAD_CASES = [c for c in CASES if c[3].get("grad")]


@pytest.mark.parametrize("case", GRAD_CASES,
                         ids=[case_id(c) for c in GRAD_CASES])
def test_extra_op_grad_matches_jax(case):
    name, args, kwargs, _ = case
    check_grad(name, args, kwargs)


def _grads(found_inf):
    g = [R.standard_normal((3,)).astype(np.float32) * 64,
         R.standard_normal((2, 2)).astype(np.float32) * 64]
    if found_inf:
        g[1][0, 1] = np.inf
    return g


@pytest.mark.parametrize("found_inf", [False, True])
def test_loss_scaler_ops_match_jax_and_grad_scaler(found_inf):
    g = _grads(found_inf)
    tx = [torch.from_numpy(v.copy()) for v in g]
    jx = [paddle.to_tensor(v.copy()) for v in g]
    outs, found = ptt.check_finite_and_unscale_(tx, torch.tensor(64.0))
    jouts, jfound = paddle.check_finite_and_unscale_(
        jx, paddle.to_tensor(np.float32(64.0)))
    assert outs is tx and bool(found) == bool(to_np(jfound)[0]) == found_inf
    for a, b in zip(tx, jx):
        np.testing.assert_array_equal(to_np(a), to_np(b))
    # amp.GradScaler's unscale_ on the same gradients agrees
    params = [torch.nn.Parameter(torch.zeros_like(t)) for t in tx]
    for p, v in zip(params, g):
        p.grad = torch.from_numpy(v.copy())

    class _Opt:
        _parameter_list = params

    scaler = tamp.GradScaler(init_loss_scaling=64.0, incr_every_n_steps=1)
    scaler.unscale_(_Opt)
    assert scaler._found_inf == found_inf
    for p, t in zip(params, tx):
        np.testing.assert_array_equal(p.grad.numpy(), t.numpy())
    # the update step: the JAX op and GradScaler.update agree
    args = (64.0, np.array([0], np.int32), np.array([0], np.int32), 1, 1,
            2.0, 0.5)
    _, scale, good, bad = ptt.update_loss_scaling_(
        tx, found, torch.tensor([args[0]]), torch.from_numpy(args[1]),
        torch.from_numpy(args[2]), *args[3:])
    _, jscale, jgood, jbad = paddle.update_loss_scaling_(
        jx, jfound, paddle.to_tensor(np.array([args[0]], np.float32)),
        paddle.to_tensor(args[1]), paddle.to_tensor(args[2]), *args[3:])
    np.testing.assert_array_equal(to_np(scale), to_np(jscale))
    np.testing.assert_array_equal(to_np(good), to_np(jgood))
    np.testing.assert_array_equal(to_np(bad), to_np(jbad))
    for a, b in zip(tx, jx):
        np.testing.assert_array_equal(to_np(a), to_np(b))
    scaler.update()
    assert scaler._scale == float(scale[0])


def _within(draws, mean, var, name):
    n = draws.size
    m, v = draws.mean(), draws.var()
    assert abs(m - mean) < 5 * (var / n) ** 0.5, (name, m, mean)
    assert abs(v - var) < 5 * var * (2.0 / n) ** 0.5 * 2, (name, v, var)


def test_samplers_match_scipy_moments():
    ptt.seed(5)
    n = 20000
    b = ptt.binomial(torch.full((n,), 10.0), torch.full((n,), 0.3))
    assert b.dtype == torch.int64
    law = scipy.stats.binom(10, 0.3)
    _within(b.numpy().astype(float), law.mean(), law.var(), "binomial")
    g = ptt.standard_gamma(torch.full((n,), 2.5, dtype=torch.float64))
    law = scipy.stats.gamma(2.5)
    _within(g.numpy(), law.mean(), law.var(), "standard_gamma")
    d = ptt.dirichlet(torch.tensor([[1.0, 2.0, 3.0]] * n))
    np.testing.assert_allclose(d.sum(-1).numpy(), 1.0, rtol=1e-5)
    law = scipy.stats.dirichlet([1.0, 2.0, 3.0])
    _within(d[:, 2].double().numpy(), law.mean()[2], law.var()[2],
            "dirichlet")
    t = ptt.truncated_gaussian_random([n], mean=1.0, std=2.0)
    assert t.dtype == torch.float32 and tuple(t.shape) == (n,)
    law = scipy.stats.truncnorm(-2.0, 2.0, loc=1.0, scale=2.0)
    _within(t.double().numpy(), law.mean(), law.var(), "truncnorm")
    u = ptt.uniform_random_batch_size_like(torch.zeros(7, 2), [1, 3],
                                           min=0.0, max=2.0)
    assert tuple(u.shape) == (7, 3) and 0.0 <= float(u.min())
    ptt.seed(5)
    again = ptt.binomial(torch.full((n,), 10.0), torch.full((n,), 0.3))
    assert torch.equal(again, b)


def test_top_p_sampling_keeps_the_nucleus():
    probs = torch.tensor([[0.5, 0.3, 0.1, 0.1]] * 2000)
    ps = torch.full((2000,), 0.7)
    scores, ids = ptt.top_p_sampling(probs, ps, seed=3)
    assert ids.dtype == torch.int64 and tuple(ids.shape) == (2000, 1)
    assert set(ids.reshape(-1).tolist()) <= {0, 1}
    assert abs(float((ids == 0).double().mean()) - 0.5 / 0.8) < 0.04
    np.testing.assert_allclose(scores.numpy(),
                               probs.gather(1, ids).numpy())
    again = ptt.top_p_sampling(probs, ps, seed=3)[1]
    assert torch.equal(again, ids)
