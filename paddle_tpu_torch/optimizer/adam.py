"""Adam and AdamW: the counterparts of ``paddle_tpu/optimizer/adam.py``
(:12-96), the same rule in plain PyTorch on the parameters' device, as
the JAX package leaves it to XLA. Per parameter the state is moment1,
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


class Adam(Optimizer):
    """use_multi_tensor changes nothing: the rule and its results are the
    same either way. lazy_mode=True raises."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, name=None):
        if lazy_mode:
            raise NotImplementedError(
                "lazy_mode=True: the port's Adam updates every row of a "
                "parameter (the dense rule); pass lazy_mode=False")
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
        m1, m2, b1p, b2p = state[:4]
        b1, b2 = self._beta1, self._beta2
        b1p.mul_(b1)
        b2p.mul_(b2)
        m1.mul_(b1).add_(_weak(1 - b1, g) * g)
        m2.mul_(b2).add_(_weak(1 - b2, g) * (g * g))
        m1_hat = m1 / (1 - b1p)
        if self._amsgrad:
            m2max = state[4]
            torch.maximum(m2max, m2, out=m2max)
            m2_hat = m2max / (1 - b2p)
        else:
            m2_hat = m2 / (1 - b2p)
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
