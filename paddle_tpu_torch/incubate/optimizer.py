"""``incubate.optimizer``: the counterpart of
``paddle_tpu/incubate/optimizer.py`` (``LookAhead``, ``ModelAverage``,
``DistributedFusedLamb``).

``LookAhead`` and ``ModelAverage`` wrap an optimizer at the eager level
and write the parameters in place (the JAX package rebinds their values).
``DistributedFusedLamb`` is the port's ``Lamb``, as the JAX package makes
it an alias of its own: the JAX package leaves the fusion to its
whole-step jit, and the port's ``Lamb`` updates every parameter in one
``step``.
"""

from __future__ import annotations

import torch

from ..optimizer import Lamb
from ..optimizer.extra import LBFGS  # noqa: F401


class LookAhead:
    """k fast steps of the inner optimizer, then the slow weights move
    alpha of the way to the fast ones, and the fast weights take them:
    slow += alpha (fast - slow); fast = slow."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = int(k)
        self._slow = {}
        self._step_num = 0
        self._parameter_list = inner_optimizer._parameter_list

    def __getattr__(self, item):
        if item == "inner_optimizer":   # guard half-built instances
            raise AttributeError(item)
        return getattr(self.inner_optimizer, item)

    @torch.no_grad()
    def _sync(self):
        for p in self._parameter_list:
            key = id(p)
            slow = self._slow.get(key)
            if slow is None:
                slow = p.detach().clone()  # first sync: adopt the fast ones
            slow = slow + self.alpha * (p.detach() - slow)
            self._slow[key] = slow
            p.copy_(slow)

    def step(self):
        self.inner_optimizer.step()
        self._step_num += 1
        if self._step_num % self.k == 0:
            self._sync()

    def clear_grad(self, set_to_zero=False):
        self.inner_optimizer.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, []

    def state_dict(self):
        sd = self.inner_optimizer.state_dict()
        for i, p in enumerate(self._parameter_list):
            if id(p) in self._slow:
                sd[f"lookahead_slow_{i}"] = self._slow[id(p)]
        sd["lookahead_step"] = self._step_num
        return sd

    def set_state_dict(self, sd):
        sd = dict(sd)
        self._step_num = int(sd.pop("lookahead_step", 0))
        for i, p in enumerate(self._parameter_list):
            key = f"lookahead_slow_{i}"
            if key in sd:
                v = sd.pop(key)
                self._slow[id(p)] = torch.as_tensor(
                    v.numpy() if hasattr(v, "numpy") and
                    not isinstance(v, torch.Tensor) else v).to(p.device)
        self.inner_optimizer.set_state_dict(sd)


class ModelAverage:
    """The running average of the weights over a trailing window, in the
    reference's two buckets (the last full window and the filling one);
    ``apply()`` / ``restore()`` swap the averages in and out (also as a
    context manager)."""

    def __init__(self, average_window_rate, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        self.rate = average_window_rate
        self.min_w = int(min_average_window)
        self.max_w = int(max_average_window)
        self._parameter_list = list(parameters or [])
        self._sum_cur = self._zeros()           # the filling window
        self._sum_prev = self._zeros()          # the last full window
        self._n_cur = 0
        self._n_prev = 0
        self._total = 0
        self._backup = None

    def _zeros(self):
        return {id(p): torch.zeros_like(p.detach())
                for p in self._parameter_list}

    @torch.no_grad()
    def step(self):
        self._total += 1
        self._n_cur += 1
        for p in self._parameter_list:
            k = id(p)
            self._sum_cur[k] = self._sum_cur[k] + p.detach()
        window = min(self.max_w,
                     max(self.min_w, int(self._total * self.rate)))
        if self._n_cur >= window:
            self._sum_prev = self._sum_cur
            self._n_prev = self._n_cur
            self._sum_cur = self._zeros()
            self._n_cur = 0

    @torch.no_grad()
    def apply(self, executor=None, need_restore=True):
        """Swap in the averaged weights."""
        n = self._n_prev + self._n_cur
        if n == 0:
            return self
        self._backup = {id(p): p.detach().clone()
                        for p in self._parameter_list}
        for p in self._parameter_list:
            k = id(p)
            p.copy_(((self._sum_prev[k] + self._sum_cur[k]) / n).to(p.dtype))
        return self

    @torch.no_grad()
    def restore(self, executor=None):
        if self._backup is None:
            return
        for p in self._parameter_list:
            p.copy_(self._backup[id(p)])
        self._backup = None

    def __enter__(self):
        return self.apply()

    def __exit__(self, *exc):
        self.restore()
        return False

    def state_dict(self):
        out = {"model_average_total": self._total,
               "model_average_n_cur": self._n_cur,
               "model_average_n_prev": self._n_prev}
        for i, p in enumerate(self._parameter_list):
            out[f"model_average_sum_cur_{i}"] = self._sum_cur[id(p)]
            out[f"model_average_sum_prev_{i}"] = self._sum_prev[id(p)]
        return out

    def set_state_dict(self, sd):
        self._total = int(sd.get("model_average_total", 0))
        self._n_cur = int(sd.get("model_average_n_cur", 0))
        self._n_prev = int(sd.get("model_average_n_prev", 0))
        for i, p in enumerate(self._parameter_list):
            for name, store in ((f"model_average_sum_cur_{i}",
                                 self._sum_cur),
                                (f"model_average_sum_prev_{i}",
                                 self._sum_prev)):
                if name in sd:
                    v = sd[name]
                    if not isinstance(v, torch.Tensor):
                        v = torch.as_tensor(v.numpy() if hasattr(v, "numpy")
                                            else v)
                    store[id(p)] = v.to(p.device)

    def minimize(self, *a, **kw):
        raise RuntimeError("ModelAverage tracks weights; call step() after "
                           "the inner optimizer's step")


class DistributedFusedLamb(Lamb):
    """The port's ``Lamb`` under the reference's name (its update of
    every parameter is one ``step``; sharding comes from
    ``dist.shard_optimizer``)."""
