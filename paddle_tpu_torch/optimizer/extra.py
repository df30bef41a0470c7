"""ASGD, Rprop and LBFGS: the counterparts of
``paddle_tpu/optimizer/extra.py``, the same rules in plain PyTorch on the
parameters' device."""

from __future__ import annotations

import torch

from .optimizer import Optimizer, _weak


class ASGD(Optimizer):
    """Averaged SGD: plain SGD steps, and ``d`` the running average of the
    iterates over ``n`` steps. batch_num is kept (at least 1) and, as in
    the JAX package, does not enter the rule."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._batch_num = max(int(batch_num), 1)

    def _acc_names(self):
        return ["d", "n"]

    def _init_state(self, p):
        z = self._acc_base(p)
        return (z, torch.zeros((), dtype=torch.float32, device=z.device))

    def _update(self, p, g, state, lr, wd_coeff=0.0):
        d, n = state
        new_p = p - _weak(lr, g) * g
        n.add_(1.0)
        d.add_((new_p - d) / n)
        return new_p


class Rprop(Optimizer):
    """Resilient backprop: each weight's step size grows by etas[1] while
    its gradient keeps its sign and shrinks by etas[0] when it flips
    (clipped to learning_rate_range); on a flip the gradient counts as 0
    (no step). p - sign(g) * step_size."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_minus, self._eta_plus = etas

    def _acc_names(self):
        return ["prev_grad", "step_size"]

    def _init_state(self, p):
        base = self._acc_base(p)
        return (base, base.clone().fill_(self.get_lr()))

    def _update(self, p, g, state, lr, wd_coeff=0.0):
        prev_g, step = state
        g = g.to(prev_g.dtype)       # the float32-accumulator invariant
        sign = torch.sign(g * prev_g)
        step.copy_(torch.where(sign > 0, step * self._eta_plus,
                               torch.where(sign < 0, step * self._eta_minus,
                                           step)))
        step.clamp_(self._lr_min, self._lr_max)
        prev_g.copy_(torch.where(sign < 0, torch.zeros_like(g), g))
        return p - torch.sign(prev_g) * step


def _number(loss):
    """A closure's loss (a tensor or a number) as a Python float."""
    return float(loss.detach()) if isinstance(loss, torch.Tensor) \
        else float(loss)


class LBFGS(Optimizer):
    """L-BFGS on a closure (``step(closure)``; the closure clears the
    gradients, computes the loss, calls backward and returns the loss):
    the two-loop recursion over the last history_size (s, y) pairs, and
    the JAX package's line search, a backtracking Armijo search (t halves
    until f(x + t d) <= f(x) + 1e-4 t g.d, at most 20 times) that it
    names strong-Wolfe-lite. line_search_fn is taken and, as in the JAX
    package, does not change the search."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False)
        self.max_iter = max_iter
        self.tolerance_grad = tolerance_grad
        self.tolerance_change = tolerance_change
        self.history_size = history_size
        self.line_search_fn = line_search_fn
        self._s, self._y = [], []

    def _flat_params(self):
        return torch.cat([p.detach().reshape(-1)
                          for p in self._parameter_list])

    @torch.no_grad()
    def _set_flat(self, flat):
        i = 0
        for p in self._parameter_list:
            n = p.numel()
            p.copy_(flat[i:i + n].reshape(p.shape))
            i += n

    def _flat_grad(self):
        return torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).detach().reshape(-1)
                          for p in self._parameter_list])

    def step(self, closure=None):
        if closure is None:
            raise ValueError("LBFGS.step requires a closure computing the "
                             "loss (with backward), like the reference")
        loss = closure()
        g = self._flat_grad()
        if float(g.abs().max()) <= self.tolerance_grad:
            return loss
        for _ in range(self.max_iter):
            q = g
            alphas = []
            for s, y in reversed(list(zip(self._s, self._y))):
                rho = 1.0 / (torch.dot(y, s) + 1e-10)
                a = rho * torch.dot(s, q)
                q = q - a * y
                alphas.append((rho, a, s, y))
            if self._y:
                y_last, s_last = self._y[-1], self._s[-1]
                q = q * (torch.dot(s_last, y_last) /
                         (torch.dot(y_last, y_last) + 1e-10))
            for rho, a, s, y in reversed(alphas):
                b = rho * torch.dot(y, q)
                q = q + s * (a - b)
            d = -q
            x0 = self._flat_params()
            f0 = _number(loss)
            g0d = float(torch.dot(g, d))
            t = float(self.get_lr())
            for _ls in range(20):
                self._set_flat(x0 + t * d)
                self.clear_grad()
                loss_new = closure()
                if _number(loss_new) <= f0 + 1e-4 * t * g0d:
                    break
                t *= 0.5
            g_new = self._flat_grad()
            s_vec = (x0 + t * d) - x0
            y_vec = g_new - g
            if float(torch.dot(s_vec, y_vec)) > 1e-10:
                self._s.append(s_vec)
                self._y.append(y_vec)
                if len(self._s) > self.history_size:
                    self._s.pop(0)
                    self._y.pop(0)
            loss = loss_new
            if float(g_new.abs().max()) <= self.tolerance_grad or \
                    float(s_vec.abs().max()) <= self.tolerance_change:
                break
            g = g_new
        self._step_count += 1
        return loss
