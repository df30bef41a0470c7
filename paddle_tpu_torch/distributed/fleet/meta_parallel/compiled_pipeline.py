"""The compiled pipeline: the counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/compiled_pipeline.py``
(``stack_layer_params`` :63, ``unstack_layer_params`` :82,
``pipeline_spmd`` :89, ``CompiledPipeline`` :181 with ``apply_tp`` :209,
``_zero_spec`` :241, ``build_forward`` :269 and ``compile_train_step``
:273, schedules ``"1F1B"`` and ``"ZBH1"``).

The JAX package makes the whole schedule one XLA program: a scan over
ticks inside ``shard_map`` over the pp axis, activations rotating by
``ppermute``. The port keeps the public API and issues the same schedule
tick by tick, stage by stage: at tick t stage s runs micro-batch t - s,
its layers on the device at pp = s of the mesh (the other coordinates at
0), and an activation reaches the next stage by the counted transfer of
``pp_layers.stage_transfer`` (``send`` / ``recv``). The last stage's
outputs come back to position 0, where the loss (and the outer head,
embedding and norm weights) runs replicated, as the JAX program's psum
broadcast leaves them.

``compile_train_step`` cuts the graph at each stage boundary, so the
backward too runs tick by tick in reverse, each stage's incoming
gradient sent back by the counted transfer:

- ``"1F1B"``: each (stage, micro-batch) backward computes the input and
  the weight gradients together (the JAX program's autodiff backward);
- ``"ZBH1"``: the forward records each stage's cut tensors
  (``zero_bubble.record_cuts``), the backward ticks run only the
  activation-gradient chain (``zero_bubble.b_pass``) and the weight
  gradients run as a phase after the drain (``zero_bubble.w_pass``),
  stage by stage in micro-batch order, so each parameter's gradient
  accumulates in the same order as under 1F1B: the two schedules give
  equal gradients and losses, and launch the same kernels.

``apply_tp`` (and ``apply_gpt_tp`` / ``apply_llama_tp``) is placements
only, the port's semi-auto rule: the values stay global and the layers
compute the unsharded product (per-rank tensor-parallel compute is the
mpu layers'). ``zero_axis`` is ZeRO through the port's one implementation
(``distributed._zero``, stage 2): each stacked parameter's optimizer
state is split along its first free dim (``_zero_spec``, the JAX rule)
over the ranks of ``zero_axis`` at its stage.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ...auto_parallel.api import DistAttr
from ...auto_parallel.placement import (PartitionSpec as P,
                                        spec_to_placements)
from ...auto_parallel.process_mesh import DeviceMesh, ProcessMesh
from .pp_layers import stage_transfer
from .zero_bubble import b_pass, record_cuts, w_pass


def stack_layer_params(layers):
    """Stack identical-structure layers' parameters on a leading axis:
    (list of [L, ...] tensors, detached copies on the first layer's
    device; the names)."""
    per_layer, names = [], None
    for layer in layers:
        items = list(layer.named_parameters())
        cur = [n for n, _ in items]
        if names is None:
            names = cur
        elif names != cur:
            raise ValueError("pipeline stages must be homogeneous; param "
                             f"trees differ: {names} vs {cur}")
        per_layer.append([p.detach() for _, p in items])
    dev = per_layer[0][0].device
    stacked = [torch.stack([pl[i].to(dev) for pl in per_layer])
               for i in range(len(names))]
    return stacked, names


@torch.no_grad()
def unstack_layer_params(layers, stacked):
    """Copy stacked values back into the layers' parameters."""
    for li, layer in enumerate(layers):
        for pi, (_, p) in enumerate(layer.named_parameters()):
            p.copy_(stacked[pi][li].to(p.device))


def _device_mesh(mesh, axis):
    if mesh is None:
        from ... import parallel_base as pb
        return DeviceMesh(np.array(pb._default_group().devices,
                                   dtype=object), (axis,))
    if isinstance(mesh, ProcessMesh):
        return mesh.get_device_mesh()
    return mesh


def _send(x, device):
    """A stage boundary's tensor to `device`, counted as one send and
    one recv (outside autograd: the graph is cut at the boundary)."""
    from ... import parallel_base as pb
    pb._count_collective("send", x)
    pb._count_collective("recv", x)
    return x.to(device)


def pipeline_spmd(stacked_params, layer_fn, mesh, axis="pp", x_spec=None):
    """fn(stacked_param_vals, micro_inputs, *extra, key=None) ->
    micro_outputs: the pipelined stack issued tick by tick (see the
    module docstring). layer_fn(param_list_of_one_layer, key, x, *extra)
    -> x; micro_inputs [n_micro, mb, ...]; x_spec, the micro-batches'
    placement over the non-pp axes, is a placement only. Gradients flow
    to the stacked values."""
    dm = _device_mesh(mesh, axis)
    n_stages = dm.shape[axis]
    devs = dm.axis_devices(axis)

    def run(params, xs, *extra, key=None):
        n_micro = xs.shape[0]
        per = params[0].shape[0] // n_stages
        home = xs.device
        stage_extra = [tuple(e.to(d) for e in extra) for d in devs]
        held, outs = {}, [None] * n_micro
        for t in range(n_micro + n_stages - 1):
            for s in range(n_stages):
                k = t - s
                if not 0 <= k < n_micro:
                    continue
                x = xs[k].to(devs[0]) if s == 0 else \
                    stage_transfer(held.pop((s - 1, k)), devs[s])
                for li in range(s * per, (s + 1) * per):
                    x = layer_fn([p[li].to(devs[s]) for p in params], key,
                                 x, *stage_extra[s])
                if s == n_stages - 1:
                    outs[k] = stage_transfer(x, home) \
                        if n_stages > 1 else x
                else:
                    held[(s, k)] = x
        return torch.stack(outs)
    return run


class CompiledPipeline:
    """A homogeneous layer stack pipelined over the mesh's `axis`, with
    the outer (embedding / head / norm) part run replicated; see the
    module docstring."""

    def __init__(self, layers, mesh=None, axis="pp", n_micro=None,
                 x_spec=None):
        self.mesh = _device_mesh(mesh, axis)
        self.axis = axis
        self.x_spec = x_spec
        self.n_stages = self.mesh.shape[axis]
        self.layers = list(layers)
        if len(self.layers) % self.n_stages:
            raise ValueError(
                f"{len(self.layers)} layers not divisible by "
                f"{self.n_stages} stages")
        self.n_micro = n_micro or self.n_stages
        tree = None
        for layer in self.layers:
            cur = [(n, tuple(p.shape)) for n, p in layer.named_parameters()]
            if tree is not None and cur != tree:
                raise ValueError("pipeline stages must be homogeneous; "
                                 f"param trees differ: {tree} vs {cur}")
            tree = cur
        names = [n for n, _ in tree]
        self._names = names
        self._param_specs = [P(axis) for _ in names]
        self._stage_devices = self.mesh.axis_devices(axis)
        per = len(self.layers) // self.n_stages
        self._per_stage = per
        with torch.no_grad():
            for li, layer in enumerate(self.layers):
                s = li // per
                dev = self._stage_devices[s]
                for t in list(layer.parameters()) + list(layer.buffers()):
                    if t.device != dev:
                        t.data = t.data.to(dev)
                for p in layer.parameters():
                    p._pp_stage = s

    @property
    def _stacked(self):
        """The layers' parameters stacked (copies: the layers' own
        parameters are the training state)."""
        return stack_layer_params(self.layers)[0]

    def stage_layers(self, s):
        return self.layers[s * self._per_stage:(s + 1) * self._per_stage]

    def apply_tp(self, rules, mp_axis="mp"):
        """Megatron placements over `mp_axis`: rules {name substring:
        weight dim} (column-parallel: dim 1 of an [in, out] weight,
        row-parallel: dim 0); in the stacked layout dim d is d + 1.
        Placements only: the values stay global and the layers compute
        the unsharded product."""
        if mp_axis not in self.mesh.axis_names or \
                self.mesh.shape[mp_axis] <= 1:
            return self
        n = self.mesh.shape[mp_axis]
        shapes = [tuple(p.shape) for _, p in
                  self.layers[0].named_parameters()]
        specs = []
        for name, shape in zip(self._names, shapes):
            dim = None
            for sub, d in rules.items():
                if sub in name:
                    dim = d
                    break
            if dim is None or shape[dim] % n:
                specs.append(P(self.axis))
                continue
            spec = [self.axis] + [None] * len(shape)
            spec[dim + 1] = mp_axis
            specs.append(P(*spec))
        self._param_specs = specs
        pm = ProcessMesh(np.arange(self.mesh.size).reshape(
            tuple(self.mesh.shape.values())), list(self.mesh.axis_names),
            devices=self.mesh.flat)
        for layer in self.layers:
            for (_, p), spec in zip(layer.named_parameters(), specs):
                per_layer = P(*spec[1:])
                p._dist_attr = DistAttr(pm, spec_to_placements(
                    pm, per_layer, p.dim()))
        return self

    def _zero_spec(self, spec, shape, zero_axis):
        """Insert zero_axis into the first unsharded dim (after the
        stacked layer dim) whose size divides (the JAX rule)."""
        if zero_axis is None or zero_axis not in self.mesh.axis_names:
            return spec
        n = self.mesh.shape[zero_axis]
        parts = list(spec) + [None] * (len(shape) - len(spec))
        for d in range(1, len(shape)):
            if parts[d] is None and shape[d] % n == 0:
                parts[d] = zero_axis
                return P(*parts)
        return spec

    def _layer_fn(self):
        layer0 = self.layers[0]
        names = self._names

        def fn(param_list, key, x, *extra):
            return torch.func.functional_call(
                layer0, dict(zip(names, param_list)), (x, *extra))
        return fn

    def build_forward(self):
        return pipeline_spmd(None, self._layer_fn(), self.mesh, self.axis,
                             x_spec=self.x_spec)

    def _zero_owners(self, zero_axis):
        """shard_of(p) for the ZeRO engine: a layer parameter's owners
        (the ranks of zero_axis at its stage) and its shard dim."""
        index = {}
        for layer in self.layers:
            for i, (_, p) in enumerate(layer.named_parameters()):
                index[id(p)] = i
        L = len(self.layers)

        def shard_of(p):
            i = index.get(id(p))
            if i is None:
                return None
            spec = self._param_specs[i]
            shape = (L,) + tuple(p.shape)
            z = self._zero_spec(spec, shape, zero_axis)
            parts = list(z) + [None] * (len(shape) - len(z))
            if zero_axis not in parts:
                return None
            devs = self.mesh.axis_devices(
                zero_axis, **{self.axis: p._pp_stage})
            return devs, parts.index(zero_axis) - 1
        return shard_of

    def compile_train_step(self, optimizer, loss_fn, outer_params=None,
                           zero_axis=None, embed_fn=None, schedule="1F1B"):
        """The hybrid train step over the pipelined stack: step(micro_x,
        micro_y, *extra) -> the loss (0-dim, detached), the optimizer's
        update included.

        loss_fn(outs_flat, ys_flat), or with outer_params
        loss_fn(outer_params, outs_flat, ys_flat) so the head / norm /
        embedding weights train with the stack; embed_fn(outer_params,
        micro_x) maps the raw micro-batches (token ids) to the pipeline's
        input activations inside the step. zero_axis: ZeRO stage 2 of
        the stacked parameters' state over that mesh axis. schedule:
        "1F1B" or "ZBH1" (see the module docstring). ``step.timing``
        holds the last step's forward, B (backward ticks), W (ZBH1's
        weight phase) and update milliseconds."""
        if schedule not in ("1F1B", "ZBH1"):
            raise ValueError(f"unknown pipeline schedule {schedule!r}; "
                             "compiled schedules: 1F1B, ZBH1")
        outer = list(outer_params or [])
        zero = None
        if zero_axis is not None:
            from ..._zero import ZeroEngine
            zero = ZeroEngine(optimizer, 2, self._zero_owners(zero_axis))
        S = self.n_stages
        devs = self._stage_devices
        home = devs[0]
        zb = schedule == "ZBH1"
        timing = {}

        def run_stage(s, x, extra):
            for layer in self.stage_layers(s):
                x = layer(x, *extra)
            return x

        def step(micro_x, micro_y, *extra):
            clock = _Clock(home)
            M = micro_x.shape[0]
            stage_extra = [tuple(e.to(d) for e in extra) for d in devs]
            hs = embed_fn(outer, micro_x) if embed_fn is not None \
                else micro_x
            xin, yout, cuts = {}, {}, {}
            for t in range(M + S - 1):
                for s in range(S):
                    k = t - s
                    if not 0 <= k < M:
                        continue
                    src = hs[k].detach() if s == 0 else yout[(s - 1, k)]
                    x = (_send(src.detach(), devs[s]) if s > 0
                         else src.to(devs[s])).requires_grad_(True)
                    xin[(s, k)] = x
                    if zb:
                        with record_cuts(self.stage_layers(s)) as c:
                            yout[(s, k)] = run_stage(s, x, stage_extra[s])
                        cuts[(s, k)] = c
                    else:
                        yout[(s, k)] = run_stage(s, x, stage_extra[s])
            outs = [(_send(yout[(S - 1, k)].detach(), home) if S > 1
                     else yout[(S - 1, k)].detach()).requires_grad_(True)
                    for k in range(M)]
            stacked = torch.stack(outs)
            flat = stacked.reshape((-1,) + tuple(stacked.shape[2:]))
            ys = micro_y.reshape((-1,) + tuple(micro_y.shape[2:]))
            loss = loss_fn(outer, flat, ys) if outer else loss_fn(flat, ys)
            t_fwd = clock.lap()
            loss.backward()
            dx, stash = {}, []
            for u in range(M + S - 1):
                for s in reversed(range(S)):
                    k = u - (S - 1 - s)
                    if not 0 <= k < M:
                        continue
                    g = (_send(outs[k].grad, devs[s]) if S > 1
                         else outs[k].grad) if s == S - 1 else \
                        _send(dx.pop((s + 1, k)), devs[s])
                    y, x = yout[(s, k)], xin[(s, k)]
                    if zb:
                        dx[(s, k)], gcuts = b_pass(y, x, g, cuts[(s, k)])
                        stash.append((s, k, gcuts))
                    else:
                        torch.autograd.backward(y, g)
                        dx[(s, k)] = x.grad
            t_b = clock.lap()
            for s, k, gcuts in sorted(stash, key=lambda e: (e[0], e[1])):
                w_pass(cuts.pop((s, k)), gcuts)
            t_w = clock.lap()
            if embed_fn is not None:
                dh = torch.stack([dx[(0, k)].to(hs.device)
                                  for k in range(M)])
                torch.autograd.backward(hs, dh)
            optimizer.step()
            optimizer.clear_grad()
            t_u = clock.lap()
            timing.update(clock.ms(fwd=t_fwd, b=t_b, w=t_w, update=t_u))
            return loss.detach()

        step.timing = timing
        step.zero = zero
        step.sync_layers = lambda: None     # the layers are the state
        return step


class _Clock:
    """Phase marks of one step: CUDA events on a card (read after the
    step), the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = [self._mark()]

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def lap(self):
        self.marks.append(self._mark())
        return len(self.marks) - 1

    def ms(self, **laps):
        if self.cuda:
            self.marks[-1].synchronize()
            return {k: self.marks[i - 1].elapsed_time(self.marks[i])
                    for k, i in laps.items()}
        return {k: (self.marks[i] - self.marks[i - 1]) * 1e3
                for k, i in laps.items()}
