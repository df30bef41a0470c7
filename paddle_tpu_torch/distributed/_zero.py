"""ZeRO stages 1-3 for the port's optimizers: the one implementation behind
``fleet.DygraphShardingOptimizer``, ``shard_optimizer`` with
``ShardingStage1-3`` and ``CompiledPipeline.compile_train_step(zero_axis=)``
(the counterparts of the JAX package's NamedSharding placements of the
optimizer state, ``dygraph_optimizer.py:76-92``, ``api.py:149-250``,
``compiled_pipeline.py:241``).

The JAX package places each state array ``Shard(d)`` over the sharding
axis and lets GSPMD derive the collectives. The port, single-controller
as everywhere (``parallel_base``), makes the ownership real: for each
sharded parameter, rank r of the sharding group owns the r-th of n equal
slices along dim d of the float32 master and of every moment, each a
tensor of its own on rank r's device. A step then runs

- stage 1: every owner takes its slice of the (global) gradient;
- stage 2: the gradient goes to its owners by a counted ``scatter`` and
  the whole gradient is freed. Gradients reach the optimizer global in
  the port (the pipeline's stages compute each once, since a stage's dp
  ranks see its activations replicated, as in the JAX package; the
  semi-auto path's values are global; ``DataParallel`` all-reduces), so
  a scatter and not a reduce-scatter moves them;
- each owner updates its slices with the optimizer's own rule
  (``Optimizer._apply_rule``): elementwise, so the result is bit-equal to
  the unsharded update of the same gradient;
- stages 1 and 2: the owners all-gather the new parameter (counted
  ``all_gather``; the float32 masters when there are masters, and the
  parameter is rebuilt from them in its own type);
- stage 3: the parameter keeps only the owners' slices between steps
  (its storage is freed) and is all-gathered on use (counted), before
  the next forward (``gather_params``, called by ``compile_train_step``,
  ``DistModel`` and the pipelines, or by a forward pre-hook for an eager
  loop).

A parameter whose shard dim does not divide by n (or a 0-d one) keeps its
state whole and replicated, updated once, as the JAX rule leaves it
replicated. The gradient clip runs on the global gradients before they
move, so it sums each gradient's squares exactly once, as the unsharded
optimizer does. Beta powers and other scalars: a copy on every owner.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from . import parallel_base as pb


class _Ref:
    """Shape, type and device of a state slice, standing in for the
    parameter in ``Optimizer._init_state``."""

    def __init__(self, shape, dtype, device):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = device


class _Shard:
    """One sharded parameter: its owners' devices, the dim, the bounds of
    each owner's slice, and each owner's state, master and (stage 3)
    parameter slices."""

    def __init__(self, p, devices, dim):
        self.p = p
        self.devices = [torch.device(d) for d in devices]
        self.dim = dim
        n, size = len(devices), p.shape[dim]
        step = size // n
        self.bounds = [(r * step, (r + 1) * step) for r in range(n)]
        self.states = None          # [rank] -> tuple of state tensors
        self.masters = None         # [rank] -> float32 slice, or None
        self.params = None          # [rank] -> slice of p (stage 3)
        self.home = p.device
        self.shape = tuple(p.shape)
        self.released = False

    def slices(self, t):
        """Each owner's slice of whole tensor t, a contiguous tensor of
        its own on the owner's device."""
        return [t.narrow(self.dim, a, b - a).to(d, copy=True).contiguous()
                for (a, b), d in zip(self.bounds, self.devices)]

    def whole(self, parts):
        """The owners' slices concatenated on the parameter's device."""
        return torch.cat([q.to(self.home) for q in parts], dim=self.dim)


def _count(op, *tensors):
    pb._count_collective(op, *tensors)


class ZeroEngine:
    """ZeRO for `optimizer` at `stage` (1, 2 or 3). `shard_of(p)` gives
    (the owners' devices, the shard dim) for parameter p, or None to
    leave it whole. Registers itself as ``optimizer._zero``: from then on
    ``optimizer.step()``, ``state_dict()`` and ``set_state_dict()`` go
    through the engine."""

    def __init__(self, optimizer, stage, shard_of):
        if stage not in (1, 2, 3):
            raise ValueError(f"ZeRO stage {stage}: 1, 2 or 3")
        if not optimizer._elementwise:
            raise ValueError(f"{type(optimizer).__name__} does not update "
                             "element by element (its rule reads whole "
                             "tensors); its state cannot be sharded")
        self.opt = optimizer
        self.stage = stage
        self.shards = OrderedDict()          # id(p) -> _Shard
        for p in optimizer._parameter_list:
            spec = shard_of(p)
            if spec is None:
                continue
            devices, dim = spec
            n = len(devices)
            if n <= 1 or p.dim() == 0 or dim is None or p.shape[dim] % n:
                continue
            self.shards[id(p)] = _Shard(p, devices, dim)
        self._hook = None
        optimizer._zero = self
        self.reshard_state()
        if stage >= 3:
            self.release_params()

    # -- state ---------------------------------------------------------------
    def _fresh(self, sh, r):
        (a, b), dev = sh.bounds[r], sh.devices[r]
        shape = list(sh.shape)
        shape[sh.dim] = b - a
        return tuple(self.opt._init_state(_Ref(shape, sh.p.dtype, dev)))

    @torch.no_grad()
    def reshard_state(self):
        """Move each sharded parameter's state (and master) from the
        optimizer's whole tensors, when it has them, or fresh, into its
        owners' slices."""
        opt = self.opt
        names = opt._acc_names()
        for sh in self.shards.values():
            key = id(sh.p)
            whole = opt._accumulators.pop(key, None)
            n = len(sh.devices)
            if whole is None:
                if sh.states is None:
                    sh.states = [self._fresh(sh, r) for r in range(n)]
            else:
                per = [[] for _ in range(n)]
                for name in names:
                    v = whole[name]
                    parts = (sh.slices(v) if v.dim() == len(sh.shape)
                             else [v.to(d, copy=True) for d in sh.devices])
                    for r in range(n):
                        per[r].append(parts[r])
                sh.states = [tuple(x) for x in per]
            master = opt._master_weights.pop(key, None)
            if master is not None:
                sh.masters = sh.slices(master)
            elif sh.masters is None and opt._multi_precision:
                sh.masters = sh.slices((sh.whole(sh.params) if sh.released
                                        else sh.p.detach()).float())

    def state_bytes(self):
        """{"per_rank": [bytes of each owner's state and master slices],
        "sharded_whole": their sum, "replicated": the bytes of the state
        kept whole}: each rank holds 1/n of the sharded whole."""
        n = max((len(sh.devices) for sh in self.shards.values()), default=1)
        per = [0] * n
        for sh in self.shards.values():
            for r in range(len(sh.devices)):
                ts = list(sh.states[r]) + (
                    [sh.masters[r]] if sh.masters is not None else [])
                per[r] += sum(t.numel() * t.element_size() for t in ts)
        rep = 0
        for key, accs in self.opt._accumulators.items():
            rep += sum(t.numel() * t.element_size() for t in accs.values())
        for t in self.opt._master_weights.values():
            rep += t.numel() * t.element_size()
        return {"per_rank": per, "sharded_whole": sum(per),
                "replicated": rep}

    def state_dict(self):
        """The unsharded optimizer's ``state_dict`` (its keys, in its
        order): the owners' slices all-gathered (counted) into whole
        tensors on each parameter's device."""
        opt = self.opt
        from ..optimizer.optimizer import _name
        sd = OrderedDict()
        names = opt._acc_names()
        for i, p in enumerate(opt._parameter_list):
            key = _name(p, i)
            sh = self.shards.get(id(p))
            if sh is None:
                for n, v in opt._accumulators.get(id(p), {}).items():
                    sd[f"{key}.{n}"] = v
                if id(p) in opt._master_weights:
                    sd[f"{key}.master_weight"] = opt._master_weights[id(p)]
                continue
            for j, n in enumerate(names):
                parts = [st[j] for st in sh.states]
                if parts[0].dim() == len(sh.shape):
                    _count("all_gather", parts)
                    sd[f"{key}.{n}"] = sh.whole(parts)
                else:
                    sd[f"{key}.{n}"] = parts[0].to(sh.home)
            if sh.masters is not None:
                _count("all_gather", sh.masters)
                sd[f"{key}.master_weight"] = sh.whole(sh.masters)
        if opt._lr_scheduler is not None:
            sd["LR_Scheduler"] = opt._lr_scheduler.state_dict()
        sd["@step"] = opt._step_count
        return sd

    # -- stage 3: the parameters' slices ------------------------------------
    @torch.no_grad()
    def release_params(self):
        """Stage 3: keep only the owners' slices of each sharded
        parameter, free its whole storage, and gather it at the next
        forward of any module (an eager loop's use)."""
        for sh in self.shards.values():
            if not sh.released:
                sh.params = sh.slices(sh.p.detach())
                self._free(sh)
        self._gather_on_use()

    @staticmethod
    def _free(sh):
        sh.p.data = sh.p.data.new_empty(0)
        sh.released = True

    def _gather_on_use(self):
        if self._hook is None:
            self._hook = torch.nn.modules.module.\
                register_module_forward_pre_hook(
                    lambda module, args: self.gather_params())

    @torch.no_grad()
    def gather_params(self):
        """Stage 3: all-gather (counted) every released parameter from its
        owners' slices, before its use."""
        if self._hook is not None:
            self._hook.remove()
            self._hook = None
        for sh in self.shards.values():
            if not sh.released:
                continue
            _count("all_gather", sh.params)
            sh.p.data = sh.whole(sh.params)
            sh.released = False

    # -- the step ------------------------------------------------------------
    @torch.no_grad()
    def step(self):
        opt = self.opt
        self.gather_params()
        opt._step_count += 1
        for p, g, lr_mult, wd in opt._grouped(opt._params_grads()):
            sh = self.shards.get(id(p))
            if sh is None:
                opt._apply_one(p, g, lr_mult, wd)
                continue
            if self.stage >= 2:
                _count("scatter", g)
                grads = sh.slices(g)
                p.grad = None                # the whole gradient is freed
            else:
                grads = [g.narrow(sh.dim, a, b - a).to(d)
                         for (a, b), d in zip(sh.bounds, sh.devices)]
            targets = (sh.masters if sh.masters is not None
                       else sh.params if sh.params is not None
                       else sh.slices(p.detach()))
            new = [opt._apply_rule(p, t, gr, st, lr_mult, wd)
                   for t, gr, st in zip(targets, grads, sh.states)]
            for t, v in zip(targets, new):
                if t is not v:
                    t.copy_(v)
            if self.stage >= 3:
                sh.params = [v.to(p.dtype) for v in new]
                self._free(sh)
            else:
                _count("all_gather", new)
                p.copy_(sh.whole(new))
        if self.stage >= 3:
            self._gather_on_use()
