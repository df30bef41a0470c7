"""Optimizer base and the SGD family: the counterparts of
``paddle_tpu/optimizer/optimizer.py`` (``Optimizer`` :25-296, ``SGD``
:299, ``Momentum`` :306) with the same imperative surface — parameter
groups with their own ``learning_rate`` multiplier and ``weight_decay``,
a float learning rate or an ``lr.LRScheduler`` (``get_lr``, ``set_lr``,
``set_lr_scheduler``), ``step`` / ``clear_grad``,
``state_dict`` / ``set_state_dict`` under the same key names (``<param
name or param_i>.<accumulator>``, ``.master_weight``, ``LR_Scheduler``,
``@step``).

Precision follows the JAX package: a bfloat16 or float16 parameter keeps
its accumulators in float32 whatever ``multi_precision`` says
(``_acc_base``), and under ``multi_precision`` every parameter is updated
through a float32 master copy, then re-emitted in its own type. The rule
of a subclass (``_update``) updates its state tensors IN PLACE and returns
the new value of the updated tensor (the master or the parameter); the
step copies it back. A Python number that meets a low-precision tensor
in the rule takes that tensor's type first (``_weak``), as under JAX's
weak typing. Parameters are torch ``nn.Parameter``s; the attributes the
JAX ``Parameter`` carries (``optimize_attr``, ``regularizer``,
``need_clip``) are read with their JAX defaults when absent,
``requires_grad`` stands for ``trainable``, and the JAX ``name`` is the
attribute ``param_name`` (a torch tensor's own ``name`` cannot be set):
``apply_decay_param_fun`` receives it and ``state_dict`` keys use it.
The scheduler is read once a step (``get_lr``) and stepped by the caller,
as in the JAX package.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from .lr import LRScheduler
from .regularizer import L1Decay, L2Decay

_LOW_PRECISION = (torch.bfloat16, torch.float16)


def _name(p, i):
    return getattr(p, "param_name", "") or f"param_{i}"


def _weak(c, t):
    """The Python number c as JAX's weak typing applies it to tensor t: in
    t's own type when that is bfloat16 or float16 (0.1 becomes
    0.10009765625 in bfloat16), else unchanged."""
    if t.dtype in _LOW_PRECISION:
        return float(torch.tensor(c, dtype=t.dtype))
    return c


class Optimizer:
    _decoupled_wd = False
    # a ZeRO engine (``distributed._zero``) that owns this optimizer's
    # update once its state is sharded; None: the whole update here
    _zero = None
    # every rule that updates element by element (a slice's update is the
    # slice of the whole's) can be sharded; Lamb's trust ratio cannot
    _elementwise = True

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        if parameters is None:
            raise ValueError(
                "parameters is required in this framework (dygraph-style)")
        self._parameter_list = list(parameters)
        self._param_groups = []
        if self._parameter_list and isinstance(self._parameter_list[0], dict):
            groups = self._parameter_list
            self._parameter_list = []
            for g in groups:
                ps = list(g["params"])
                self._param_groups.append({**g, "params": ps})
                self._parameter_list.extend(ps)
        else:
            self._param_groups.append({"params": self._parameter_list})
        self._learning_rate = learning_rate
        self._lr_scheduler = learning_rate if isinstance(
            learning_rate, LRScheduler) else None
        if isinstance(weight_decay, float) and not self._decoupled_wd:
            weight_decay = L2Decay(weight_decay)
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._accumulators = {}     # id(param) -> {name: tensor}
        self._master_weights = {}   # id(param) -> float32 tensor
        self._step_count = 0

    # -- lr ----------------------------------------------------------------
    def get_lr(self):
        if self._lr_scheduler is not None:
            return float(self._lr_scheduler())
        return float(self._learning_rate)

    def set_lr(self, value):
        if self._lr_scheduler is not None:
            raise RuntimeError("cannot set_lr when using LRScheduler")
        self._learning_rate = value

    def set_lr_scheduler(self, scheduler):
        self._lr_scheduler = scheduler
        self._learning_rate = scheduler

    # -- accumulators --------------------------------------------------------
    def _acc_names(self):
        return []

    def _init_state(self, p):
        """Initial per-parameter state tuple of fresh tensors."""
        return ()

    def _acc_base(self, p):
        """Zeros shaped as p in the accumulators' type: float32 for a
        low-precision parameter REGARDLESS of multi_precision (bf16 rounds
        beta2 = 0.999 to 1.0 and loses the moments), else p's type."""
        base = self._master_weights.get(id(p), p) \
            if self._multi_precision else p
        dtype = torch.float32 if base.dtype in _LOW_PRECISION else base.dtype
        return torch.zeros(p.shape, dtype=dtype, device=p.device)

    def _get_master(self, p):
        """The float32 master of p under multi_precision (made from p at
        first use), else None."""
        if not self._multi_precision:
            return None
        key = id(p)
        if key not in self._master_weights:
            self._master_weights[key] = p.detach().float().clone()
        return self._master_weights[key]

    def _state_of(self, p):
        key = id(p)
        names = self._acc_names()
        if key not in self._accumulators:
            self._accumulators[key] = dict(zip(names, self._init_state(p)))
        st = self._accumulators[key]
        return tuple(st[n] for n in names)

    # -- the rule ----------------------------------------------------------------
    def _update(self, p, g, state, lr, wd_coeff=0.0):
        raise NotImplementedError

    # -- step ------------------------------------------------------------------
    def step(self):
        """One update, attributed to the active ``perf.StepTimer``'s
        "optimizer" phase (as the JAX package's eager step is)."""
        from ..observability.perf import phase_scope
        with phase_scope("optimizer"):
            return self._step_impl()

    @torch.no_grad()
    def _step_impl(self):
        if self._zero is not None:       # ZeRO: the owners update slices
            return self._zero.step()
        self._step_count += 1
        for p, g, lr_mult, wd in self._grouped(self._params_grads()):
            self._apply_one(p, g, lr_mult, wd)

    def _params_grads(self):
        """(param, grad) of every trainable parameter with a gradient,
        through the gradient clip when there is one."""
        params_grads = [(p, p.grad) for p in self._parameter_list
                        if p.grad is not None
                        and getattr(p, "trainable", p.requires_grad)]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        return params_grads

    def _grouped(self, params_grads):
        """(param, grad, group lr multiplier, group decay) in group
        order."""
        for group in self._param_groups:
            group_lr_mult = group.get("learning_rate", 1.0)
            wd = group.get("weight_decay", self._weight_decay)
            if isinstance(wd, float) and not self._decoupled_wd:
                wd = L2Decay(wd)
            group_ids = {id(p) for p in group["params"]}
            for p, g in params_grads:
                if id(p) in group_ids:
                    yield p, g, group_lr_mult, wd

    def _param_rule(self, p, lr_mult, wd):
        """(lr_mult, wd) for parameter p: a subclass's per-parameter
        adjustments (AdamW's lr_ratio and apply_decay_param_fun)."""
        return lr_mult, wd

    def _apply_one(self, p, g, lr_mult, wd):
        master = self._get_master(p)
        target = master if master is not None else p.detach()
        new = self._apply_rule(p, target, g, self._state_of(p), lr_mult, wd)
        if master is not None:
            master.copy_(new)
        p.copy_(new)            # re-emitted in p's own type

    def _apply_rule(self, p, target, g, state, lr_mult, wd):
        """The update of `target` (p's master or p itself, or an owner's
        slice of either) by gradient g with the state tensors `state`
        (updated in place): the decay, the regularizer and the rule, for
        parameter p's group multiplier and decay. Returns the new value;
        elementwise, so a slice's update is the slice of the whole's."""
        lr_mult, wd = self._param_rule(p, lr_mult, wd)
        lr = self.get_lr() * lr_mult * getattr(
            p, "optimize_attr", {}).get("learning_rate", 1.0)
        if g.dtype != target.dtype:
            g = g.to(target.dtype)
        # regularizer-style decay is added to the gradient; decoupled decay
        # (AdamW) is the rule's own business
        wd_coeff = 0.0
        regularizer = getattr(p, "regularizer", None)
        if wd is not None and regularizer is None and not self._decoupled_wd:
            if isinstance(wd, L2Decay):
                g = g + _weak(wd.coeff, target) * target
            elif isinstance(wd, L1Decay):
                g = g + _weak(wd.coeff, target) * torch.sign(target)
        elif self._decoupled_wd and wd is not None:
            wd_coeff = wd.coeff if hasattr(wd, "coeff") else float(wd)
        if regularizer is not None:
            g = g + regularizer._apply(target)
        return self._update(target, g, state, lr, wd_coeff)

    @torch.no_grad()
    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    # -- state dict ------------------------------------------------------------
    def state_dict(self):
        """{key: tensor} of the live state (not copies), the scheduler's
        state dict under "LR_Scheduler" when there is one, and "@step".
        Under ZeRO the owners' slices gathered into whole tensors."""
        if self._zero is not None:
            return self._zero.state_dict()
        return self._local_state_dict()

    def _local_state_dict(self):
        sd = OrderedDict()
        for i, p in enumerate(self._parameter_list):
            key = _name(p, i)
            for n, v in self._accumulators.get(id(p), {}).items():
                sd[f"{key}.{n}"] = v
            if id(p) in self._master_weights:
                sd[f"{key}.master_weight"] = self._master_weights[id(p)]
        if self._lr_scheduler is not None:
            sd["LR_Scheduler"] = self._lr_scheduler.state_dict()
        sd["@step"] = self._step_count
        return sd

    def set_state_dict(self, state_dict):
        """Load copies of the saved state onto each parameter's device; a
        saved accumulator takes the type of the fresh state (float32 for a
        low-precision parameter). Under ZeRO each owner takes its slice."""
        self._local_set_state_dict(state_dict)
        if self._zero is not None:
            self._zero.reshard_state()

    def _local_set_state_dict(self, state_dict):
        names = self._acc_names()
        for i, p in enumerate(self._parameter_list):
            key = _name(p, i)
            saved = {n: state_dict[f"{key}.{n}"] for n in names
                     if f"{key}.{n}" in state_dict}
            if saved:
                full = dict(zip(names, self._init_state(p)))
                for n, v in saved.items():
                    full[n] = torch.as_tensor(v).to(
                        device=full[n].device, dtype=full[n].dtype,
                        copy=True)
                self._accumulators[id(p)] = full
            mk = f"{key}.master_weight"
            if mk in state_dict:
                self._master_weights[id(p)] = torch.as_tensor(
                    state_dict[mk]).to(device=p.device, dtype=torch.float32,
                                       copy=True)
        if "LR_Scheduler" in state_dict and self._lr_scheduler is not None:
            self._lr_scheduler.set_state_dict(state_dict["LR_Scheduler"])
        self._step_count = int(state_dict.get("@step", self._step_count))


class SGD(Optimizer):
    """p - lr * g."""

    def _update(self, p, g, state, lr, wd_coeff=0.0):
        return p - _weak(lr, g) * g


class Momentum(Optimizer):
    """velocity = momentum * velocity + g; p - lr * velocity, or with
    use_nesterov p - lr * (g + momentum * velocity)."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _acc_names(self):
        return ["velocity"]

    def _init_state(self, p):
        return (self._acc_base(p),)

    def _update(self, p, g, state, lr, wd_coeff=0.0):
        (v,) = state
        v.mul_(self._momentum).add_(g)
        if self._nesterov:
            return p - lr * (g + self._momentum * v)
        return p - lr * v
