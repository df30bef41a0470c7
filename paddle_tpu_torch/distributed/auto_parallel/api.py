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

``shard_optimizer``, ``to_static``, ``DistModel``, ``Strategy``,
``ShardingStage1-3`` and the ``moe_*`` helpers (``api.py:149-383``) belong
to a later slice of the port (ROADMAP §A.13) and raise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .placement import (Partial, Replicate, Shard,  # noqa: F401
                        placements_to_spec, spec_to_placements)
from .process_mesh import ProcessMesh  # noqa: F401

_GLOBAL_MESH = [None]

_LATER = ("belongs to a later slice of paddle_tpu_torch (ROADMAP §A.13: "
          "sharded optimizers, DistModel and the static path)")


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


def _later(name):
    def raiser(*args, **kwargs):
        raise NotImplementedError(f"{name} {_LATER}")
    raiser.__name__ = name
    return raiser


def _later_class(name):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"{name} {_LATER}")
    return type(name, (), {"__init__": __init__,
                           "__doc__": f"{name}: raises ({_LATER})."})


shard_optimizer = _later("shard_optimizer")
to_static = _later("to_static")
moe_global_mesh_tensor = _later("moe_global_mesh_tensor")
moe_sub_mesh_tensors = _later("moe_sub_mesh_tensors")
DistModel = _later_class("DistModel")
Strategy = _later_class("Strategy")
ShardingStage1 = _later_class("ShardingStage1")
ShardingStage2 = _later_class("ShardingStage2")
ShardingStage3 = _later_class("ShardingStage3")
