"""The port's learning-rate schedulers (``paddle_tpu_torch.optimizer.lr``)
against the JAX package's (``paddle_tpu.optimizer.lr``).

The port's module is a copy of the JAX one, so every rate must be EQUAL
(the same Python float arithmetic), over 30 steps, for each of the 17
classes (the base ``LRScheduler`` through a subclass defined here over
both bases); ``ReduceOnPlateau`` is fed the same metric sequence (numbers,
numpy scalars and torch tensors); ``state_dict`` round trips into a fresh
scheduler and continues equal. Then AdamW under ``StepDecay`` drives a
tiny Llama through ``compile_train_step`` beside the JAX train step:
losses within 1e-4 (float32 products in other orders over 5 steps, as in
``test_torch_train.py``), and the rate each step equal.
"""

import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import jit as jjit
from paddle_tpu import optimizer as jopt
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import weights
from paddle_tpu_torch.jit import compile_train_step
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

torch.set_num_threads(1)

STEPS = 30


def _half_every_ten(base):
    class Halving(base.LRScheduler):
        def get_lr(self):
            return self.base_lr * 0.5 ** (self.last_epoch // 10)
    return Halving(0.4)


SCHEDULERS = {
    "LRScheduler": _half_every_ten,
    "NoamDecay": lambda m: m.NoamDecay(64, 10, learning_rate=2.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([5, 12, 20],
                                                 [0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.5, 0.1),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.5, 0.2),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.1, 12, end_lr=0.001,
                                                   power=2.0),
    "PolynomialDecay_cycle": lambda m: m.PolynomialDecay(
        0.1, 7, end_lr=0.001, power=1.5, cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(0.1, 8, 0.0, 0.1),
    "LinearWarmup_inner": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.1, 15), 6, 0.001, 0.1),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.3, 0.9),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.2, [4, 9, 21], 0.3),
    "StepDecay": lambda m: m.StepDecay(0.2, 7, 0.5),
    "LambdaDecay": lambda m: m.LambdaDecay(0.1, lambda e: 1 / (1 + e)),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(
        0.1, lambda e: 0.95 if e % 2 else 0.99),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(0.1, 11, 0.002),
    "CosineAnnealingWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, 4, T_mult=2, eta_min=0.001),
    "OneCycleLR": lambda m: m.OneCycleLR(0.2, 25),
    "OneCycleLR_linear": lambda m: m.OneCycleLR(0.2, 25,
                                                anneal_strategy="linear"),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, 4),
    "CyclicLR_triangular2": lambda m: m.CyclicLR(0.01, 0.1, 3, 5,
                                                 mode="triangular2"),
    "CyclicLR_exp_range": lambda m: m.CyclicLR(0.01, 0.1, 3,
                                               mode="exp_range",
                                               exp_gamma=0.95),
    "CyclicLR_scale_fn": lambda m: m.CyclicLR(
        0.01, 0.1, 3, scale_fn=lambda c: 1 / (1 + c), scale_mode="iterations"),
}


def _rates(sched):
    out = [sched()]
    for _ in range(STEPS):
        sched.step()
        out.append(sched())
    return out


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_rates_equal_jax(name):
    make = SCHEDULERS[name]
    want = _rates(make(jopt.lr))
    got = _rates(make(topt.lr))
    assert got == want
    assert all(isinstance(r, float) or isinstance(r, int) for r in got)


def test_every_scheduler_class_is_ported():
    def classes(mod):
        return {n for n, v in vars(mod).items()
                if isinstance(v, type) and issubclass(v, mod.LRScheduler)}

    jax_classes, port_classes = classes(jopt.lr), classes(topt.lr)
    assert len(jax_classes) == 17
    assert port_classes == jax_classes
    tested = {n.split("_")[0] for n in SCHEDULERS} | {"ReduceOnPlateau"}
    assert tested == jax_classes


@pytest.mark.parametrize("mode,threshold_mode", [("min", "rel"),
                                                 ("min", "abs"),
                                                 ("max", "abs")])
def test_reduce_on_plateau_equal_jax(mode, threshold_mode):
    rng = np.random.default_rng(3)
    metrics = np.cumsum(rng.normal(0.0, 1.0, 40)).tolist()
    kw = dict(mode=mode, factor=0.5, patience=2, threshold=0.05,
              threshold_mode=threshold_mode, cooldown=1, min_lr=1e-3)
    j = jopt.lr.ReduceOnPlateau(0.1, **kw)
    t = topt.lr.ReduceOnPlateau(0.1, **kw)
    seq_j, seq_t = [j()], [t()]
    for i, m in enumerate(metrics):
        j.step(m)
        # the port reads a number, a numpy scalar or a torch tensor
        t.step([m, np.float64(m), torch.tensor(m)][i % 3])
        seq_j.append(j())
        seq_t.append(t())
    t.step()                        # no metric: nothing moves
    assert seq_t == seq_j and t() == seq_t[-1]
    assert len(set(seq_t)) > 1      # the rate did drop


@pytest.mark.parametrize("name", ["StepDecay", "LinearWarmup_inner",
                                  "MultiplicativeDecay", "CyclicLR"])
def test_state_dict_round_trip(name):
    make = SCHEDULERS[name]
    a, j = make(topt.lr), make(jopt.lr)
    for _ in range(9):
        a.step()
        j.step()
    sd = a.state_dict()
    assert sd == j.state_dict()
    b = make(topt.lr)
    b.set_state_dict(dict(sd))
    for _ in range(12):
        a.step()
        b.step()
        assert b() == a()


LR, SEQ, STEPS_TRAIN = 1e-3, 16, 5


def test_adamw_under_step_decay_trains_as_jax():
    """AdamW(StepDecay(1e-3, 2, 0.5)) on the tiny Llama: the rate is read
    each step and the scheduler stepped after it, on both sides."""
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig.tiny())
    tm = weights.from_paddle_tpu_state(
        {n: np.asarray(p._value) for n, p in jm.named_parameters()},
        LlamaForCausalLM(LlamaConfig.tiny(), device="cpu"))
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 128, (2, SEQ)).astype(np.int32)
    lab = rng.integers(0, 128, (2, SEQ)).astype(np.int32)
    loss_fn = lambda m, i, l: m(i, labels=l)  # noqa: E731
    js, ts = jopt.lr.StepDecay(LR, 2, 0.5), topt.lr.StepDecay(LR, 2, 0.5)
    jo = jopt.AdamW(js, parameters=jm.parameters())
    to = topt.AdamW(ts, parameters=tm.parameters())
    jstep = jjit.compile_train_step(jm, loss_fn, jo)
    tstep = compile_train_step(tm, loss_fn, to)
    jl, tl = [], []
    for _ in range(STEPS_TRAIN):
        assert to.get_lr() == jo.get_lr()
        jl.append(float(jstep(paddle.to_tensor(ids), paddle.to_tensor(lab))))
        tl.append(float(tstep(torch.from_numpy(ids), torch.from_numpy(lab))))
        js.step()
        ts.step()
    np.testing.assert_allclose(tl, jl, atol=1e-4)
    assert to.get_lr() == LR * 0.5 ** 2
    sd = to.state_dict()
    assert sd["LR_Scheduler"] == jo.state_dict()["LR_Scheduler"]
    fresh = topt.AdamW(topt.lr.StepDecay(LR, 2, 0.5),
                       parameters=tm.parameters())
    fresh.set_state_dict(sd)
    assert fresh.get_lr() == to.get_lr()
    assert math.isfinite(tl[-1]) and tl[-1] < tl[0]
