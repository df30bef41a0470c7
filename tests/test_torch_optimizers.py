"""The port's optimizers beyond Adam/AdamW against the JAX package's:
SGD and Momentum (``optimizer.py:299, :306``), Adamax, Adagrad, Adadelta,
RMSProp, Lamb, NAdam and RAdam (``adam.py:99-260``), ASGD, Rprop and
LBFGS (``extra.py``).

Each case makes its starting values and its gradients with numpy from a
seed, hands the same arrays to both packages and takes the same steps
(clear_grad between them). Tolerances, each with its reason:

- float32 parameters and every accumulator after the steps: rtol 1e-6,
  atol 1e-9 (the same elementwise operations in the same order; the last
  bit may differ where a library fuses a multiply-add; Lamb's two norms
  are reductions summed in other orders);
- bfloat16 parameters under ``multi_precision`` (Momentum, Lamb, RAdam):
  the float32 masters and accumulators as above, the bfloat16 parameters
  within one bf16 ulp (a master within rounding of a bf16 tie may round
  either way);
- ``state_dict``: the same keys in the same order as JAX's;
- LBFGS on a 6-dimensional quadratic with a closure: both packages'
  iterates within 1e-5 (float32 two-loop recursions of the same history),
  and the minimiser A^-1 b within 1e-3.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.tensor import Parameter as JaxParameter
from paddle_tpu.optimizer.regularizer import L1Decay as JL1
from paddle_tpu.optimizer.regularizer import L2Decay as JL2

from paddle_tpu_torch import optimizer as topt

torch.set_num_threads(1)

SHAPES = [(6, 5), (5,), (3, 4)]
_L1 = {jopt: JL1, topt: topt.L1Decay}
_L2 = {jopt: JL2, topt: topt.L2Decay}

CASES = {
    "sgd": (lambda m, ps: m.SGD(0.1, parameters=ps), 5),
    "sgd_l2": (lambda m, ps: m.SGD(0.1, parameters=ps,
                                   weight_decay=0.01), 5),
    "sgd_step_decay": (lambda m, ps: m.SGD(m.lr.StepDecay(0.1, 2, 0.5),
                                           parameters=ps), 5),
    "momentum": (lambda m, ps: m.Momentum(0.05, 0.9, parameters=ps), 5),
    "momentum_nesterov_l1": (lambda m, ps: m.Momentum(
        0.05, 0.9, parameters=ps, use_nesterov=True,
        weight_decay=_L1[m](0.01)), 5),
    "adamax": (lambda m, ps: m.Adamax(0.02, parameters=ps), 5),
    "adagrad": (lambda m, ps: m.Adagrad(
        0.1, parameters=ps, initial_accumulator_value=0.1), 5),
    "adadelta": (lambda m, ps: m.Adadelta(1.0, parameters=ps), 5),
    "rmsprop": (lambda m, ps: m.RMSProp(0.01, parameters=ps), 5),
    "rmsprop_centered_momentum": (lambda m, ps: m.RMSProp(
        0.01, rho=0.9, momentum=0.5, centered=True, parameters=ps,
        weight_decay=_L2[m](0.02)), 5),
    "lamb": (lambda m, ps: m.Lamb(0.01, parameters=ps), 5),
    "nadam": (lambda m, ps: m.NAdam(0.01, parameters=ps), 5),
    "radam": (lambda m, ps: m.RAdam(0.01, parameters=ps), 8),
    "radam_beta2_09": (lambda m, ps: m.RAdam(0.01, beta2=0.9,
                                             parameters=ps), 8),
    "asgd": (lambda m, ps: m.ASGD(0.05, batch_num=3, parameters=ps), 5),
    "rprop": (lambda m, ps: m.Rprop(0.01, parameters=ps), 6),
}


def _f32(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(getattr(x, "_value", x)).astype(np.float32)


def _run_pair(make, dtype, steps, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [_f32(rng, s) for s in SHAPES]
    jps = [JaxParameter(jnp.asarray(a, dtype=jnp.dtype(dtype)))
           for a in arrays]
    tps = [torch.nn.Parameter(torch.from_numpy(a).to(getattr(torch, dtype)))
           for a in arrays]
    jo, to = make(jopt, jps), make(topt, tps)
    for _ in range(steps):
        # a shared sign pattern half the time, so that Rprop both grows
        # and shrinks its steps
        for jp, tp, s in zip(jps, tps, SHAPES):
            g = _f32(rng, s)
            jp.grad = paddle.to_tensor(g).astype(dtype)
            tp.grad = torch.from_numpy(g).to(tp.dtype)
        assert to.get_lr() == jo.get_lr()
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
        if jo._lr_scheduler is not None:
            jo._lr_scheduler.step()
            to._lr_scheduler.step()
    return jps, tps, jo, to


def _state_close(jo, to):
    jsd, tsd = jo.state_dict(), to.state_dict()
    assert list(tsd) == list(jsd)
    for k, v in jsd.items():
        if k == "@step":
            assert tsd[k] == v
        elif k == "LR_Scheduler":
            assert tsd[k] == v
        else:
            assert tsd[k].dtype == torch.float32, k
            np.testing.assert_allclose(_as_np(tsd[k]), _as_np(v), rtol=1e-6,
                                       atol=1e-9, err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_float32_matches_jax(case):
    make, steps = CASES[case]
    jps, tps, jo, to = _run_pair(make, "float32", steps)
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.detach().numpy(), jp.numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=case)
    _state_close(jo, to)


MP_CASES = {
    "momentum": lambda m, ps: m.Momentum(0.05, 0.9, parameters=ps,
                                         multi_precision=True),
    "lamb": lambda m, ps: m.Lamb(0.01, parameters=ps, multi_precision=True),
    "radam": lambda m, ps: m.RAdam(0.01, parameters=ps,
                                   multi_precision=True),
}


@pytest.mark.parametrize("case", sorted(MP_CASES))
def test_optimizer_bfloat16_multi_precision_matches_jax(case):
    jps, tps, jo, to = _run_pair(MP_CASES[case], "bfloat16", 8)
    for jp, tp in zip(jps, tps):
        assert tp.dtype == torch.bfloat16
        want = _as_np(jp)
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(_as_np(tp) - want) <= ulp), case
    _state_close(jo, to)
    assert sum(k.endswith(".master_weight") for k in to.state_dict()) == 3


def test_low_precision_accumulators_are_float32_without_masters():
    """bf16 parameters without multi_precision: the accumulators are
    float32 all the same (``_acc_base``), and a step leaves the parameter
    bf16."""
    for name in ("momentum", "adamax", "adagrad", "adadelta", "rmsprop",
                 "nadam", "asgd", "rprop"):
        _, tps, _, to = _run_pair(CASES[name][0], "bfloat16", 2)
        assert all(p.dtype == torch.bfloat16 for p in tps)
        for k, v in to.state_dict().items():
            if k != "@step":
                assert v.dtype == torch.float32, (name, k)


def test_state_dict_round_trip_continues_equal():
    make = CASES["rmsprop_centered_momentum"][0]
    _, tps, _, to = _run_pair(make, "float32", 3)
    clones = [torch.nn.Parameter(p.detach().clone()) for p in tps]
    fresh = make(topt, clones)
    fresh.set_state_dict(to.state_dict())
    rng = np.random.default_rng(9)
    for _ in range(3):
        for a, b in zip(tps, clones):
            g = torch.from_numpy(_f32(rng, tuple(a.shape)))
            a.grad, b.grad = g.clone(), g.clone()
        to.step()
        fresh.step()
    for a, b in zip(tps, clones):
        assert torch.equal(a, b)


def test_lbfgs_on_a_quadratic_matches_jax():
    """Four iterations of one step(closure) on each side (above the
    float32 noise floor: past it, line searches on a flat float32 loss
    take other branches on both sides), then more steps reach the
    minimiser."""
    rng = np.random.default_rng(4)
    m = rng.standard_normal((6, 6)).astype(np.float32)
    a = (m @ m.T / 6 + np.eye(6, dtype=np.float32)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    x0 = np.zeros(6, np.float32)

    jx = JaxParameter(jnp.asarray(x0))
    jo = jopt.LBFGS(1.0, max_iter=4, history_size=5, parameters=[jx])
    ja, jb = paddle.to_tensor(a), paddle.to_tensor(b)

    def jclosure():
        jo.clear_grad()
        loss = 0.5 * (jx * paddle.matmul(ja, jx)).sum() - (jb * jx).sum()
        loss.backward()
        return loss

    tx = torch.nn.Parameter(torch.from_numpy(x0.copy()))
    to = topt.LBFGS(1.0, max_iter=4, history_size=5, parameters=[tx])
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)

    def tclosure():
        to.clear_grad()
        loss = 0.5 * (tx * (ta @ tx)).sum() - (tb * tx).sum()
        loss.backward()
        return loss

    jl = jo.step(jclosure)
    tl = to.step(tclosure)
    np.testing.assert_allclose(tx.detach().numpy(), jx.numpy(), atol=1e-5)
    np.testing.assert_allclose(float(tl), float(jl.numpy()), atol=1e-5)
    assert len(to._s) == len(jo._s)
    for _ in range(3):
        to.step(tclosure)
    np.testing.assert_allclose(tx.detach().numpy(), np.linalg.solve(a, b),
                               atol=1e-3)
    assert to._step_count == 4
    with pytest.raises(ValueError, match="closure"):
        to.step()
