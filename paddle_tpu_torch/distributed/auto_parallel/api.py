"""Semi-auto parallel API: the counterpart of
``paddle_tpu/distributed/auto_parallel/api.py:32-148`` (``shard_tensor``,
``dtensor_from_fn``, ``reshard``, ``dtensor_to_local``,
``unshard_dtensor``, ``shard_layer``).

A sharded tensor ("dist tensor") is a torch tensor that holds the GLOBAL
values, as a GSPMD array does in the JAX package, and carries a
``_dist_attr`` (``DistAttr``: its ``process_mesh`` and ``placements``).
Computing with it computes the global result, and autograd flows as for
any tensor. Its per-position pieces are real, separate tensors on the
positions' devices: ``local_shards(t)`` makes them (in the mesh's flat
position order, each a contiguous copy of its slice), and
``dtensor_to_local`` returns the first, as the JAX package returns the
first addressable shard. The global tensor lives on the mesh's first
device.

``Partial`` follows the JAX package: not a valid input placement of
``shard_tensor`` nor a target of ``reshard``; a tensor marked Partial
holds its already reduced value, so resharding it moves no values.

``shard_optimizer`` with ``ShardingStage1-3`` (``api.py:149-250``) is ZeRO
through the port's one implementation (``distributed._zero``): the
owners are the ranks along the stage's mesh dim (the other dims at 0),
each holding its dim-0 slice of every master and moment on its device.
The semi-auto path's gradients are global (the values are), so stage 2
moves them to their owners with a counted scatter. ``DistModel`` /
``to_static`` (``api.py:284-357``) run ``jit.compile_train_step``, which
honours the optimizer's ZeRO engine; ``DistModel.state_dict("all")``
gathers the owners' slices into the JAX layout.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .placement import (Partial, Replicate, Shard,  # noqa: F401
                        placements_to_spec, spec_to_placements)
from .process_mesh import ProcessMesh  # noqa: F401

_GLOBAL_MESH = [None]


class DistAttr:
    def __init__(self, mesh, placements):
        self.process_mesh = mesh
        self.placements = list(placements)

    def __repr__(self):
        return f"DistAttr(mesh={self.process_mesh}, {self.placements})"


def shard_index(shape, axis_sizes, spec, coord):
    """The index (a tuple of slices) of the piece that mesh position
    `coord` ({axis: index}) holds of a tensor of `shape` laid out by
    `spec` over axes of `axis_sizes` ({axis: size}). A dim split k ways
    takes pieces of ceil(n / k) (the last one shorter), several axes on
    one dim split it major-first."""
    index = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        names = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        k, pos = 1, 0
        for name in names:
            k *= axis_sizes[name]
            pos = pos * axis_sizes[name] + coord[name]
        if k == 1:
            index.append(slice(None))
            continue
        chunk = math.ceil(n / k)
        start = min(pos * chunk, n)
        index.append(slice(start, min(start + chunk, n)))
    return tuple(index)


def _spec_of(t):
    attr = t._dist_attr
    mesh = attr.process_mesh
    return mesh, placements_to_spec(mesh, attr.placements, t.dim())


def local_shards(t):
    """The per-position pieces of dist tensor `t`, in flat mesh order:
    each a contiguous copy of its slice on its position's device (not
    linked to `t`'s autograd graph). A tensor without placements is its
    own one piece."""
    if getattr(t, "_dist_attr", None) is None:
        return [t]
    mesh, spec = _spec_of(t)
    dm = mesh.get_device_mesh()
    sizes = dict(zip(mesh.dim_names, mesh.shape))
    out = []
    with torch.no_grad():
        for pos in np.ndindex(*mesh.shape):
            coord = dict(zip(mesh.dim_names, pos))
            piece = t[shard_index(tuple(t.shape), sizes, spec, coord)]
            out.append(piece.to(dm.devices[pos], copy=True)
                       .contiguous())
    return out


def _home(mesh):
    return mesh.get_device_mesh().flat[0]


def shard_tensor(data, mesh, placements, dtype=None, place=None,
                 stop_gradient=None):
    """Lay `data` out on `mesh` by `placements` (``api.py:32``). A
    parameter is annotated in place (moved to the mesh's first device if
    it is elsewhere); other data gives a new leaf tensor holding the same
    values. Partial is refused, as in the JAX package."""
    if any(p.is_partial() for p in placements):
        raise ValueError("shard_tensor does not accept Partial placements")
    home = _home(mesh)
    if isinstance(data, torch.nn.Parameter):
        out = data
        if out.device != home:
            with torch.no_grad():
                out.data = out.data.to(home)
    else:
        if isinstance(data, torch.Tensor):
            src = data
            grad = data.requires_grad
        else:
            src = torch.as_tensor(np.asarray(data))
            grad = False
        if dtype is not None:
            src = src.to(getattr(torch, dtype) if isinstance(dtype, str)
                         else dtype)
        out = src.detach().to(home, copy=True)
        if stop_gradient is not None:
            grad = not stop_gradient
        if grad:
            out.requires_grad_(True)
    out._dist_attr = DistAttr(mesh, placements)
    return out


def dtensor_from_fn(fn, mesh, placements, *args, **kwargs):
    """``fn(*args, **kwargs)`` laid out by ``shard_tensor``."""
    return shard_tensor(fn(*args, **kwargs), mesh, placements)


def reshard(dist_tensor, mesh, placements):
    """The same global values under new placements (``api.py:94``): a
    tensor still in the source's autograd graph. A Partial source holds its
    reduced value already; a Partial target is refused."""
    if any(p.is_partial() for p in placements):
        raise ValueError("reshard target cannot be Partial")
    out = dist_tensor.to(_home(mesh)).clone()
    out._dist_attr = DistAttr(mesh, placements)
    return out


def dtensor_to_local(dist_tensor, mesh=None, placements=None):
    """The first position's piece (a new tensor)."""
    return local_shards(dist_tensor)[0]


def unshard_dtensor(dist_tensor):
    """The global values as a plain tensor (``api.py:126``): a new leaf
    with the source's requires_grad; a tensor without placements is
    returned as it is."""
    t = dist_tensor
    if getattr(t, "_dist_attr", None) is None:
        return t
    return t.detach().clone().requires_grad_(t.requires_grad)


def shard_layer(layer, process_mesh, shard_fn=None, input_fn=None,
                output_fn=None):
    """Apply ``shard_fn(name, sublayer, mesh)`` to every sublayer
    (``api.py:132``; default: replicate each parameter that has no
    placements yet), and register `input_fn(inputs, mesh)` /
    `output_fn(outputs, mesh)` as forward hooks."""
    if shard_fn is None:
        def shard_fn(name, sublayer, mesh):
            for p in sublayer.parameters(recurse=False):
                if getattr(p, "_dist_attr", None) is None:
                    shard_tensor(p, mesh,
                                 [Replicate() for _ in mesh.dim_names])
    for name, sub in layer.named_modules():
        shard_fn(name, sub, process_mesh)
    if input_fn is not None:
        layer.register_forward_pre_hook(
            lambda m, inputs: input_fn(inputs, process_mesh))
    if output_fn is not None:
        layer.register_forward_hook(
            lambda m, inputs, outputs: output_fn(outputs, process_mesh))
    return layer


def shard_optimizer(optimizer, shard_fn=None):
    """``api.py:149``: shard the optimizer's state. A ``ShardingStage1-3``
    makes the ZeRO engine (``optimizer._zero``; stage 3 also keeps only
    the owners' slices of each parameter between steps, gathered on use);
    any other callable ``shard_fn(name, param, value)`` is applied to each
    existing accumulator and master, as in the JAX package. Returns the
    optimizer."""
    from .._zero import ZeroEngine
    optimizer._shard_fn = shard_fn or (lambda name, p, state: state)
    optimizer._state_sharded = True
    if isinstance(shard_fn, ShardingStage1):
        ZeroEngine(optimizer, shard_fn.stage, shard_fn._owners)
        if shard_fn.stage >= 3:
            shard_fn._annotate(optimizer._parameter_list)
        return optimizer
    if callable(shard_fn):
        names = optimizer._acc_names()
        for p in optimizer._parameter_list:
            accs = optimizer._accumulators.get(id(p))
            if accs:
                for n in names:
                    accs[n] = shard_fn(n, p, accs[n])
        for p in optimizer._parameter_list:
            if id(p) in optimizer._master_weights:
                optimizer._master_weights[id(p)] = shard_fn(
                    "master_weight", p, optimizer._master_weights[id(p)])
    return optimizer


class ShardingStage1:
    """Optimizer-state sharding over mesh dim `mesh_dim` (``api.py:202``):
    the state of a parameter whose dim 0 divides by the dim's size is
    split along dim 0 over its ranks."""

    stage = 1

    def __init__(self, mesh_dim="dp", mesh=None):
        self.mesh_dim = mesh_dim
        self.mesh = mesh

    def _mesh(self):
        return self.mesh or _GLOBAL_MESH[0]

    def _sharding(self, val):
        """The PartitionSpec of a dim-0 split of `val`, or None."""
        from .placement import PartitionSpec
        mesh = self._mesh()
        if mesh is None or val.dim() == 0:
            return None
        n = mesh.get_dim_size(self.mesh_dim)
        if n <= 1 or val.shape[0] % n:
            return None
        return PartitionSpec(self.mesh_dim)

    def _owners(self, p):
        if self._sharding(p) is None:
            return None
        dm = self._mesh().get_device_mesh()
        return dm.axis_devices(self.mesh_dim), 0

    def _annotate(self, params):
        """Stage 3: the sharded parameters' placements over the mesh dim
        (other dims' placements kept)."""
        mesh = self._mesh()
        k = mesh.dim_names.index(self.mesh_dim)
        for p in params:
            if self._sharding(p) is None:
                continue
            attr = getattr(p, "_dist_attr", None)
            place = list(attr.placements) if attr is not None and \
                attr.process_mesh == mesh else \
                [Replicate() for _ in mesh.dim_names]
            place[k] = Shard(0)
            p._dist_attr = DistAttr(mesh, place)

    def __call__(self, key, param, accumulator_val):
        return accumulator_val

    def grad_sharding(self, val):
        return None

    def param_sharding(self, val):
        return None


class ShardingStage2(ShardingStage1):
    """Stage 1 and the gradients moved to their owners (``api.py:227``)."""

    stage = 2

    def grad_sharding(self, val):
        return self._sharding(val)


class ShardingStage3(ShardingStage2):
    """Stage 2 and the parameters kept as their owners' slices between
    steps, gathered on use (``api.py:239``)."""

    stage = 3

    def param_sharding(self, val):
        return self._sharding(val)


class Strategy:
    """``auto_parallel/strategy.py``: a config bag."""

    class _Cfg:
        def __init__(self):
            self.enable = False

    def __init__(self, config=None):
        self.sharding = Strategy._Cfg()
        self.gradient_merge = Strategy._Cfg()
        self.pipeline = Strategy._Cfg()
        self.amp = Strategy._Cfg()
        self.recompute = Strategy._Cfg()
        self.fused_passes = Strategy._Cfg()
        if config:
            for k, v in config.items():
                setattr(self, k, v)


def _as_tensor(b, device):
    if torch.is_tensor(b):
        return b
    return torch.as_tensor(np.asarray(b)).to(device)


class DistModel:
    """``api.py:284``: the distributed train / eval / predict object that
    ``to_static`` makes. Training runs ``jit.compile_train_step`` over
    ``loss(layer(*xs), y)`` (the optimizer's ZeRO engine, when sharded,
    does its update); eval gives the loss without gradients, predict the
    outputs."""

    def __init__(self, layer, loader=None, loss=None, optimizer=None,
                 strategy=None, metrics=None):
        self.network = layer
        self._loader = loader
        self._loss = loss
        self._optimizer = optimizer
        self._strategy = strategy or Strategy()
        self._mode = "train"
        self._step = None

    def train(self):
        self._mode = "train"
        self.network.train()

    def eval(self):
        self._mode = "eval"
        self.network.eval()

    def predict(self):
        self._mode = "predict"
        self.network.eval()

    def _build_step(self):
        from ...jit import compile_train_step

        def loss_fn(model, *batch):
            *xs, y = batch
            return self._loss(model(*xs), y)

        self._step = compile_train_step(self.network, loss_fn,
                                        self._optimizer)

    def _gathered(self):
        zero = getattr(self._optimizer, "_zero", None)
        if zero is not None:
            zero.gather_params()

    def __call__(self, *batch):
        dev = next(self.network.parameters()).device
        batch = [_as_tensor(b, dev) for b in batch]
        if self._mode == "train":
            if self._step is None:
                self._build_step()
            return self._step(*batch)
        self._gathered()
        with torch.no_grad():
            if self._mode == "eval":
                *xs, y = batch
                return self._loss(self.network(*xs), y)
            return self.network(*batch)

    def state_dict(self, mode="all"):
        """The network's state (gathered parameters) and, for "all" or
        "opt", the optimizer's under its keys, the owners' slices
        gathered (the JAX layout)."""
        self._gathered()
        sd = dict(self.network.state_dict())
        if mode in ("all", "opt") and self._optimizer is not None:
            sd.update(self._optimizer.state_dict())
        return sd

    def set_state_dict(self, state_dict):
        self._gathered()
        own = self.network.state_dict()
        with torch.no_grad():
            for k, v in state_dict.items():
                if k in own:
                    own[k].copy_(torch.as_tensor(v).to(own[k].device))
        if self._optimizer is not None:
            self._optimizer.set_state_dict(state_dict)

    def dist_main_program(self, mode=None):
        raise NotImplementedError(
            "no static Program in the port: the captured programs of the "
            "train step are jit.compile_train_step(..., fuse=True)'s "
            "step.programs")


def to_static(layer, loader=None, loss=None, optimizer=None, strategy=None,
              metrics=None):
    """``api.py:357``: the ``DistModel`` of `layer`."""
    return DistModel(layer, loader, loss, optimizer, strategy, metrics)


def moe_global_mesh_tensor(local_tensor_list, mesh, placements,
                           local_mesh_dim=-1):
    """``api.py:366``: the local tensors (one per sub-mesh) concatenated
    along dim 0 into one dist tensor on `mesh`."""
    home = _home(mesh)
    flat = torch.cat([torch.as_tensor(t).to(home)
                      for t in local_tensor_list], dim=0)
    return shard_tensor(flat, mesh, placements)


def moe_sub_mesh_tensors(dist_tensor, global_mesh=None, local_mesh_dim=-1,
                         global_placements=None):
    """``api.py:375``: the dist tensor's n equal dim-0 pieces (n the size
    of mesh dim `local_mesh_dim`), piece i on the device of position i
    along that dim."""
    t = dist_tensor
    mesh = global_mesh or t._dist_attr.process_mesh
    dim = local_mesh_dim if local_mesh_dim >= 0 else \
        mesh.ndim + local_mesh_dim
    n = mesh.shape[dim]
    devs = mesh.get_device_mesh().axis_devices(mesh.dim_names[dim])
    per = t.shape[0] // n
    return [t[i * per:(i + 1) * per].to(d) for i, d in
            zip(range(n), devs)]
