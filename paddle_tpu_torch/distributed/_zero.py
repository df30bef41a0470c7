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

In a multi-process world (``parallel_base.multi_process()``) the same
engine holds the slices of this process's own rank only (the world group
is the sharding group), and the two moves become collectives across the
processes: stage 2 marks its parameters so that ``DataParallel`` leaves
their gradients local, and moves each rank's gradients to their owners by
one ``reduce_scatter`` (AVG) a parameter; the owners' new slices come back
to every process by an ``all_gather`` in the parameter's own type (the
rounding of the master is per element, so this equals gathering the
masters and rounding the whole). The gradient clip then reads the global
gradients: the squared norms of the owned slices (and, once, of the
replicated gradients) all-reduced. Stage 1 takes its slice of the
gradient ``DataParallel`` has averaged, clipped as the unsharded
optimizer clips it.
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
    """One sharded parameter: the dim, every rank's slice bounds, and the
    state, master and (stage 3) parameter slices of the ranks this process
    holds, each on its rank's device: all n ranks in the single
    controller, its own rank (`rank`) across processes."""

    def __init__(self, p, devices, dim, rank=None):
        self.p = p
        self.dim = dim
        n, size = len(devices), p.shape[dim]
        step = size // n
        self.bounds = [(r * step, (r + 1) * step) for r in range(n)]
        self.across = rank is not None
        self.ranks = [rank] if self.across else list(range(n))
        self.devices = ([p.device] if self.across
                        else [torch.device(d) for d in devices])
        self.states = None          # [local rank] -> tuple of state tensors
        self.masters = None         # [local rank] -> float32 slice, or None
        self.params = None          # [local rank] -> slice of p (stage 3)
        self.home = p.device
        self.shape = tuple(p.shape)
        self.released = False

    def slices(self, t, copy=True):
        """The local ranks' slices of whole tensor t on their devices:
        contiguous tensors of their own, or (copy=False) views where the
        device is t's."""
        out = []
        for r, d in zip(self.ranks, self.devices):
            a, b = self.bounds[r]
            s = t.narrow(self.dim, a, b - a)
            out.append(s.to(d, copy=True).contiguous() if copy else s.to(d))
        return out

    def whole(self, parts):
        """Every rank's slice concatenated on the parameter's device: the
        local ranks' parts (counted ``all_gather``), or across processes
        this rank's part all-gathered from every process."""
        if self.across:
            parts = pb.all_gather(None, parts[0].contiguous())
        else:
            _count("all_gather", parts)
        return torch.cat([q.to(self.home) for q in parts], dim=self.dim)

    def owned(self, g, stage):
        """The local owners' slices of gradient g. Stages 2 and 3 move it
        to its owners: the single controller's global g by a counted
        ``scatter``, each process's own g by a ``reduce_scatter`` (AVG)."""
        if stage < 2:
            return self.slices(g, copy=False)
        if not self.across:
            _count("scatter", g)
            return self.slices(g)
        n = len(self.bounds)
        src = g.movedim(self.dim, 0).contiguous()
        out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                          dtype=g.dtype, device=g.device)
        pb.reduce_scatter(out, src, op=pb.ReduceOp.AVG)
        return [out.movedim(0, self.dim)]


def _count(op, *tensors):
    pb._count_collective(op, *tensors)


def _nbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts)


class ZeroEngine:
    """ZeRO for `optimizer` at `stage` (1, 2 or 3). `shard_of(p)` gives
    (the owners' devices, the shard dim) for parameter p, or None to
    leave it whole. Registers itself as ``optimizer._zero``: from then on
    ``optimizer.step()``, ``state_dict()`` and ``set_state_dict()`` go
    through the engine. In a multi-process world the owners are the
    world's processes, so `shard_of(p)` must name as many as there are."""

    def __init__(self, optimizer, stage, shard_of):
        if stage not in (1, 2, 3):
            raise ValueError(f"ZeRO stage {stage}: 1, 2 or 3")
        if not optimizer._elementwise:
            raise ValueError(f"{type(optimizer).__name__} does not update "
                             "element by element (its rule reads whole "
                             "tensors); its state cannot be sharded")
        self.opt = optimizer
        self.stage = stage
        self.across = pb.multi_process()
        world = pb.get_world_size() if self.across else None
        self.shards = OrderedDict()          # id(p) -> _Shard
        for p in optimizer._parameter_list:
            spec = shard_of(p)
            if spec is None:
                continue
            devices, dim = spec
            n = len(devices)
            if n <= 1 or p.dim() == 0 or dim is None or p.shape[dim] % n:
                continue
            if self.across:
                if n != world:
                    raise ValueError(
                        f"ZeRO across processes shards over the world's "
                        f"{world} processes; the sharding axis has {n}")
                # DataParallel leaves a stage-2 gradient local: the step
                # reduce-scatters it
                p._zero_reduce_scatter = stage >= 2
            self.shards[id(p)] = _Shard(
                p, devices, dim, pb.get_rank() if self.across else None)
        self._hook = None
        optimizer._zero = self
        self.reshard_state()
        if stage >= 3:
            self.release_params()

    # -- state ---------------------------------------------------------------
    def _fresh(self, sh, r, dev):
        (a, b) = sh.bounds[r]
        shape = list(sh.shape)
        shape[sh.dim] = b - a
        return tuple(self.opt._init_state(_Ref(shape, sh.p.dtype, dev)))

    @torch.no_grad()
    def reshard_state(self):
        """Move each sharded parameter's state (and master) from the
        optimizer's whole tensors, when it has them, or fresh, into its
        local owners' slices."""
        opt = self.opt
        names = opt._acc_names()
        for sh in self.shards.values():
            key = id(sh.p)
            whole = opt._accumulators.pop(key, None)
            if whole is None:
                if sh.states is None:
                    sh.states = [self._fresh(sh, r, d)
                                 for r, d in zip(sh.ranks, sh.devices)]
            else:
                per = [[] for _ in sh.ranks]
                for name in names:
                    v = whole[name]
                    parts = (sh.slices(v) if v.dim() == len(sh.shape)
                             else [v.to(d, copy=True) for d in sh.devices])
                    for i, x in enumerate(parts):
                        per[i].append(x)
                sh.states = [tuple(x) for x in per]
            master = opt._master_weights.pop(key, None)
            if master is not None:
                sh.masters = sh.slices(master)
            elif sh.masters is None and opt._multi_precision:
                sh.masters = ([t.float().clone() for t in sh.params]
                              if sh.released
                              else sh.slices(sh.p.detach().float()))

    def state_bytes(self):
        """{"ranks": the ranks this process holds, "per_rank": the bytes
        of each one's state and master slices, "local": their sum (in the
        single controller the whole sharded state), "replicated": the
        bytes of the state kept whole}: each rank holds 1/n of the
        sharded whole."""
        ranks = max((sh.ranks for sh in self.shards.values()), key=len,
                    default=[pb.get_rank() if self.across else 0])
        per = [0] * len(ranks)
        for sh in self.shards.values():
            for i in range(len(sh.ranks)):
                per[i] += _nbytes(list(sh.states[i]) + (
                    [sh.masters[i]] if sh.masters is not None else []))
        rep = sum(_nbytes(accs.values())
                  for accs in self.opt._accumulators.values())
        rep += _nbytes(self.opt._master_weights.values())
        return {"ranks": list(ranks), "per_rank": per, "local": sum(per),
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
                sd[f"{key}.{n}"] = (sh.whole(parts)
                                    if parts[0].dim() == len(sh.shape)
                                    else parts[0].to(sh.home))
            if sh.masters is not None:
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
            sh.p.data = sh.whole(sh.params)
            sh.released = False

    # -- the step ------------------------------------------------------------
    def _grads(self):
        """(p, g, shard) of every trainable parameter with a gradient,
        through the gradient clip on the global gradients. Across
        processes at stage 2 or 3 each rank's gradients first move to
        their owners, and g is the list of the owned slices; otherwise
        the gradients are global, the unsharded clip reads them, and the
        step takes the owners' slices one parameter at a time."""
        opt = self.opt
        if not (self.across and self.stage >= 2):
            return [(p, g, self.shards.get(id(p)))
                    for p, g in opt._params_grads()]
        items = []
        for p in opt._parameter_list:
            if p.grad is None or not getattr(p, "trainable",
                                             p.requires_grad):
                continue
            sh = self.shards.get(id(p))
            g = p.grad
            if sh is not None:
                g = sh.owned(g, self.stage)[0]
                p.grad = None                # the whole gradient is freed
            items.append((p, g, sh))
        return [(p, [g] if sh is not None else g, sh)
                for p, g, sh in self._clip_across(items)]

    def _clip_across(self, items):
        """The optimizer's gradient clip over the global gradients across
        processes: items (p, g, shard) with g this rank's slice (sharded)
        or the whole, replicated gradient."""
        from ..optimizer.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                                      ClipGradByValue, _clipped)
        clip = self.opt._grad_clip
        if clip is None or not items:
            return items
        if isinstance(clip, ClipGradByValue):
            return [(p, g2, sh) for (p, g2), (_, _, sh) in
                    zip(clip([(p, g) for p, g, _ in items]), items)]
        if not isinstance(clip, (ClipGradByGlobalNorm, ClipGradByNorm)):
            raise TypeError(f"ZeRO across processes: {type(clip).__name__}"
                            " is not a clip it can take")
        first = pb.get_rank() == 0
        sq = torch.stack([
            g.float().square().sum() if sh is not None or first
            else torch.zeros((), device=g.device)
            for p, g, sh in items])
        pb.all_reduce(sq)                 # each gradient's squares, once
        keep = torch.tensor([_clipped(p, g) for p, g, _ in items],
                            device=sq.device)
        if isinstance(clip, ClipGradByGlobalNorm):
            norm = torch.sqrt((sq * keep).sum())
            scale = clip.clip_norm / norm.clamp_min(clip.clip_norm)
            return [(p, (g.float() * scale).to(g.dtype) if k else g, sh)
                    for (p, g, sh), k in zip(items, keep.tolist())]
        scales = (clip.clip_norm / torch.sqrt(sq).clamp_min(1e-12)) \
            .clamp_max(1.0)
        return [(p, g * scales[i] if k else g, sh) for i, ((p, g, sh), k)
                in enumerate(zip(items, keep.tolist()))]

    @torch.no_grad()
    def step(self):
        opt = self.opt
        self.gather_params()
        opt._step_count += 1
        items = self._grads()
        shard_of = {id(p): sh for p, _, sh in items}
        for p, g, lr_mult, wd in opt._grouped([(p, g) for p, g, _ in
                                               items]):
            sh = shard_of[id(p)]
            if sh is None:
                opt._apply_one(p, g, lr_mult, wd)
                continue
            if not isinstance(g, list):
                g = sh.owned(g, self.stage)
                if self.stage >= 2:
                    p.grad = None            # the whole gradient is freed
            targets = (sh.masters if sh.masters is not None
                       else sh.params if sh.params is not None
                       else sh.slices(p.detach()))
            new = [opt._apply_rule(p, t, gr, st, lr_mult, wd)
                   for t, gr, st in zip(targets, g, sh.states)]
            for t, v in zip(targets, new):
                if t is not v:
                    t.copy_(v)
            if self.stage >= 3:
                sh.params = [v.to(p.dtype) for v in new]
                self._free(sh)
            else:
                p.copy_(sh.whole([v.to(p.dtype) for v in new]))
        if self.stage >= 3:
            self._gather_on_use()
