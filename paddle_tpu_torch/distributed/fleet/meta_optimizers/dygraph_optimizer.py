"""Hybrid-parallel optimizers: the counterparts of
``paddle_tpu/distributed/fleet/meta_optimizers/dygraph_optimizer.py``
(``HybridParallelOptimizer`` :23, ``DygraphShardingOptimizer`` :44,
``HybridParallelGradScaler`` :123).

- ``HybridParallelOptimizer`` wraps the inner optimizer: the gradients
  are global arrays in the single controller (a pipeline's stages each
  hold their own parameters' gradients, a tied weight's two uses summed
  into its one gradient), so the global-norm clip needs no cross-axis
  surgery; the gradient clip sums every parameter's squares once.
- ``DygraphShardingOptimizer`` is ZeRO stage 1, 2 or 3 through the
  port's one ZeRO implementation (``distributed._zero``). Its rule is
  the JAX package's ``_axis_spec`` (:76-92): the ``sharding`` axis when it
  has more than one rank, else ``dp``; dim 0 when it divides; otherwise
  the state stays whole. A parameter's owners are the ranks along that
  axis at its pipeline stage (``_pp_stage``; 0 outside a pipeline), the
  other coordinates at 0.
- ``HybridParallelGradScaler``: one found-inf for the whole model, every
  stage's gradients included; each device's flag is combined by a
  counted ``all_reduce`` (MAX), so a skipped step is skipped on every
  stage and owner.
"""

from __future__ import annotations

import torch

from ... import parallel_base as pb
from ..._zero import ZeroEngine
from ...fleet.base.topology import get_hcg


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg=None, strategy=None):
        self._inner_opt = optimizer
        self._hcg = hcg or get_hcg()
        self._strategy = strategy

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    def step(self):
        self._inner_opt.step()

    def minimize(self, loss, *a, **kw):
        return self._inner_opt.minimize(loss, *a, **kw)

    def clear_grad(self, *a, **kw):
        self._inner_opt.clear_grad(*a, **kw)

    clear_gradients = clear_grad


def _inner(optimizer):
    while hasattr(optimizer, "_inner_opt"):
        optimizer = optimizer._inner_opt
    return optimizer


class DygraphShardingOptimizer:
    """ZeRO stage 1/2/3 over the hybrid mesh's sharding (else dp) axis
    (``group_sharded_stage{2,3}.py`` of the reference); see the module
    docstring."""

    def __init__(self, optimizer, hcg=None, stage=1):
        self._inner_opt = optimizer
        self._hcg = hcg or get_hcg()
        self.stage = stage
        optimizer._shard_fn = self
        self._shard_fn = self
        self.zero = ZeroEngine(_inner(optimizer), stage, self._owners)

    @property
    def mesh(self):
        return self._hcg.mesh if self._hcg is not None else None

    def _axis(self):
        mesh = self.mesh
        if mesh is None:
            return None
        for cand in ("sharding", "dp"):
            if mesh.shape.get(cand, 1) > 1:
                return cand
        return None

    def _axis_spec(self, val):
        """The PartitionSpec of `val`'s sharded state (dim 0 over the
        sharding axis), or None when it stays whole."""
        from ...auto_parallel.placement import PartitionSpec
        axis = self._axis()
        if axis is None or val.dim() == 0 or \
                val.shape[0] % self.mesh.shape[axis]:
            return None
        return PartitionSpec(axis)

    def _owners(self, p):
        if self._axis_spec(p) is None:
            return None
        stage = getattr(p, "_pp_stage", 0)
        fixed = {"pp": stage} if "pp" in self.mesh.axis_names else {}
        return self.mesh.axis_devices(self._axis(), **fixed), 0

    def grad_sharding(self, val):
        """Stage >= 2: the layout of the gradient's owners' slices."""
        if self.stage < 2:
            return None
        return self._axis_spec(val)

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    def step(self):
        self._inner_opt.step()

    def clear_grad(self, *a, **kw):
        self._inner_opt.clear_grad(*a, **kw)

    clear_gradients = clear_grad


class HybridParallelGradScaler:
    def __init__(self, scaler, hcg=None):
        self._scaler = scaler
        self._hcg = hcg or get_hcg()

    def __getattr__(self, item):
        return getattr(self._scaler, item)

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Each gradient times 1 / scale; one found-inf over every
        device's gradients (a counted MAX all-reduce of the devices'
        flags)."""
        s = self._scaler
        if not s._enable or s._unscaled:
            return
        inv = 1.0 / s._scale
        flags = {}
        for p in _inner(optimizer)._parameter_list:
            if p.grad is None:
                continue
            g = p.grad.float() * inv
            bad = (~torch.isfinite(g)).any().float()
            flags[p.device] = bad if p.device not in flags else \
                torch.maximum(flags[p.device], bad)
            p.grad.copy_(g)
        if flags:
            parts = list(flags.values())
            if len(parts) > 1:
                home = parts[0].device
                parts = [f.to(home) for f in parts]
                pb._count_collective("all_reduce", parts)
                found = torch.stack(parts).amax()
            else:
                found = parts[0]
            s._found_inf = bool(found > 0)
        else:
            s._found_inf = False
        s.last_found_inf = s._found_inf
        s._unscaled = True

    def step(self, optimizer):
        s = self._scaler
        if not s._enable:
            optimizer.step()
            return
        if not s._unscaled:
            self.unscale_(optimizer)
        if not s._found_inf:
            optimizer.step()
        else:
            s.skipped_steps += 1

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)
        self._scaler.update()
