"""The Adam family: the counterparts of ``paddle_tpu/optimizer/adam.py``
(``Adam``, ``AdamW`` :12-96; ``Adamax``, ``Adagrad``, ``Adadelta``,
``RMSProp``, ``Lamb``, ``NAdam``, ``RAdam`` :99-260), each rule in plain
PyTorch on the parameters' device, as the JAX package leaves it to XLA,
with the JAX accumulator names. Per parameter the state is moment1,
moment2, beta1_pow, beta2_pow (and moment2_max under amsgrad), float32
for a low-precision parameter. ``torch.optim.AdamW`` is not this rule's
home: it keeps bfloat16 moments for bfloat16 parameters.

    beta1_pow *= beta1;  beta2_pow *= beta2
    m1 = beta1 * m1 + (1 - beta1) * g
    m2 = beta2 * m2 + (1 - beta2) * g^2
    p  = p * (1 - lr * wd)                      (AdamW: decoupled decay)
    p  = p - lr * (m1 / (1 - beta1_pow)) / (sqrt(m2 / (1 - beta2_pow)) + eps)
"""

from __future__ import annotations

import torch

from .optimizer import Optimizer, _weak


def _adam_moments(b1, b2, g, state):
    """Advance Adam's beta powers and moments (state[:4]) in place;
    returns the bias-corrected (m1_hat, m2_hat)."""
    m1, m2, b1p, b2p = state[:4]
    b1p.mul_(b1)
    b2p.mul_(b2)
    m1.mul_(b1).add_(_weak(1 - b1, g) * g)
    m2.mul_(b2).add_(_weak(1 - b2, g) * (g * g))
    return m1 / (1 - b1p), m2 / (1 - b2p)


class Adam(Optimizer):
    """use_multi_tensor changes nothing: the rule and its results are the
    same either way. lazy_mode=True gives the dense rule, as in the JAX
    package, whose gradients are dense: every row of a parameter is
    updated."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._amsgrad = amsgrad

    def _acc_names(self):
        names = ["moment1", "moment2", "beta1_pow", "beta2_pow"]
        if self._amsgrad:
            names.append("moment2_max")
        return names

    def _init_state(self, p):
        z = self._acc_base(p)
        one = torch.ones((), dtype=z.dtype, device=z.device)
        st = (z, z.clone(), one, one.clone())
        if self._amsgrad:
            st = st + (z.clone(),)
        return st

    def _update(self, p, g, state, lr, wd_coeff=0.0):
        m1_hat, m2_hat = _adam_moments(self._beta1, self._beta2, g, state)
        if self._amsgrad:
            m2max = state[4]
            torch.maximum(m2max, state[1], out=m2max)
            m2_hat = m2max / (1 - state[3])
        if wd_coeff:
            p = p * _weak(1.0 - lr * wd_coeff, p)
        return p - lr * m1_hat / (torch.sqrt(m2_hat) + self._epsilon)


class AdamW(Adam):
    """Decoupled weight decay (default 0.01). lr_ratio(p) multiplies a
    parameter's learning rate; apply_decay_param_fun(name) False exempts
    it from the decay (name: the parameter's ``param_name``, '' when
    unset, as a JAX Parameter's ``name``)."""

    _decoupled_wd = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 name=None):
        wd = weight_decay if weight_decay is not None else 0.0
        if isinstance(wd, int):
            wd = float(wd)
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         wd, grad_clip, lazy_mode, multi_precision,
                         amsgrad=amsgrad)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _apply_one(self, p, g, lr_mult, wd):
        if self._lr_ratio is not None:
            lr_mult = lr_mult * float(self._lr_ratio(p))
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(getattr(p, "param_name", "")):
            wd = None
        super()._apply_one(p, g, lr_mult, wd)


class Adamax(Optimizer):
    """moment = beta1 moment + (1 - beta1) g; inf_norm = max(beta2
    inf_norm, |g|); p - lr / (1 - beta1_pow) moment / (inf_norm + eps)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _acc_names(self):
        return ["moment", "inf_norm", "beta1_pow"]

    def _init_state(self, p):
        z = self._acc_base(p)
        return (z, z.clone(), torch.ones((), dtype=z.dtype, device=z.device))

    def _update(self, p, g, state, lr, wd_coeff=0.0):
        m, u, b1p = state
        b1 = self._beta1
        b1p.mul_(b1)
        m.mul_(b1).add_(_weak(1 - b1, g) * g)
        torch.maximum(self._beta2 * u, g.abs(), out=u)
        return p - lr / (1 - b1p) * m / (u + self._epsilon)


class Adagrad(Optimizer):
    """moment += g^2 (from initial_accumulator_value); p - lr g /
    (sqrt(moment) + eps)."""

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _acc_names(self):
        return ["moment"]

    def _init_state(self, p):
        return (self._acc_base(p).fill_(self._initial),)

    def _update(self, p, g, state, lr, wd_coeff=0.0):
        (acc,) = state
        acc.add_(g * g)
        return p - _weak(lr, g) * g / (torch.sqrt(acc) + self._epsilon)


class Adadelta(Optimizer):
    """The update -sqrt(avg_squared_update + eps) / sqrt(avg_squared_grad +
    eps) g, both averages decaying by rho; p + lr update."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon, self._rho = epsilon, rho

    def _acc_names(self):
        return ["avg_squared_grad", "avg_squared_update"]

    def _init_state(self, p):
        z = self._acc_base(p)
        return (z, z.clone())

    def _update(self, p, g, state, lr, wd_coeff=0.0):
        sg, su = state
        rho, eps = self._rho, self._epsilon
        sg.mul_(rho).add_(_weak(1 - rho, g) * (g * g))
        update = -torch.sqrt(su + eps) / torch.sqrt(sg + eps) * g
        su.mul_(rho).add_((1 - rho) * (update * update))
        return p + lr * update


class RMSProp(Optimizer):
    """mean_square decays by rho toward g^2 (and mean_grad toward g when
    centered); momentum = momentum_coeff momentum + lr g / sqrt(
    mean_square [- mean_grad^2] + eps); p - momentum."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _acc_names(self):
        return ["mean_square", "momentum", "mean_grad"]

    def _init_state(self, p):
        z = self._acc_base(p)
        return (z, z.clone(), z.clone())

    def _update(self, p, g, state, lr, wd_coeff=0.0):
        ms, mom, mg = state
        rho, eps = self._rho, self._epsilon
        ms.mul_(rho).add_(_weak(1 - rho, g) * (g * g))
        if self._centered:
            mg.mul_(rho).add_(_weak(1 - rho, g) * g)
            denom = torch.sqrt(ms - mg * mg + eps)
        else:
            denom = torch.sqrt(ms + eps)
        mom.mul_(self._momentum).add_(_weak(lr, g) * g / denom)
        return p - mom


class Lamb(Optimizer):
    """Adam's moments, r = m1_hat / (sqrt(m2_hat) + eps) + lamb_weight_decay
    p, and the layer's trust ratio |p| / |r| (1 where either is 0):
    p - lr trust r. exclude_from_weight_decay_fn is taken and, as in the
    JAX package, not applied."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _acc_names(self):
        return ["moment1", "moment2", "beta1_pow", "beta2_pow"]

    def _init_state(self, p):
        z = self._acc_base(p)
        one = torch.ones((), dtype=z.dtype, device=z.device)
        return (z, z.clone(), one, one.clone())

    def _update(self, p, g, state, lr, wd_coeff=0.0):
        m1_hat, m2_hat = _adam_moments(self._beta1, self._beta2, g, state)
        r = m1_hat / (torch.sqrt(m2_hat) + self._epsilon) + \
            _weak(self._lamb_wd, p) * p
        w_norm = torch.linalg.vector_norm(p.reshape(-1))
        r_norm = torch.linalg.vector_norm(r.reshape(-1))
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        return p - lr * trust * r


class NAdam(Adam):
    """Adam with Nesterov momentum: m1_hat = beta1 m1 / (1 - beta1_pow
    beta1) + (1 - beta1) g / (1 - beta1_pow)."""

    def _update(self, p, g, state, lr, wd_coeff=0.0):
        m1, b1p = state[0], state[2]
        b1 = self._beta1
        _, m2_hat = _adam_moments(b1, self._beta2, g, state)
        m1_hat = b1 * m1 / (1 - b1p * b1) + _weak(1 - b1, g) * g / (1 - b1p)
        return p - lr * m1_hat / (torch.sqrt(m2_hat) + self._epsilon)


class RAdam(Adam):
    """Rectified Adam: while the variance estimate's length rho is at most
    5, p - lr m1_hat; after, the rectified adaptive step."""

    def _update(self, p, g, state, lr, wd_coeff=0.0):
        m2, b2p = state[1], state[3]
        b2 = self._beta2
        m1_hat, _ = _adam_moments(self._beta1, b2, g, state)
        rho_inf = 2.0 / (1 - b2) - 1
        rho = rho_inf - 2.0 * b2p / (1 - b2p)
        r = torch.sqrt(((rho - 4) * (rho - 2) * rho_inf) /
                       ((rho_inf - 4) * (rho_inf - 2) * rho))
        m2_hat = torch.sqrt(m2 / (1 - b2p))
        adaptive = p - lr * r * m1_hat / (m2_hat + self._epsilon)
        return torch.where(rho > 5.0, adaptive, p - lr * m1_hat)
