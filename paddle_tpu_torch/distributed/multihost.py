"""Multi-process helpers: the counterpart of
``paddle_tpu/distributed/multihost.py:27-88``.

In the JAX package one process per host drives its local chips and these
helpers build global arrays out of each process's data. The port's
processes hold per-process tensors (one rank, one device each, in the
world ``init_parallel_env`` joins over gloo), so:

- ``global_batch`` returns this process's shard of the batch, the rows
  the process fed, on its device (the dp axis of ``global_mesh``
  concatenates the processes' shards in rank order);
- ``replicate`` puts a value every process holds alike on this process's
  device;
- ``all_reduce_value`` reduces one host value over the processes in
  float32 and returns it to every process (``sum``, ``max``, ``min``,
  ``mean``: JAX's values);
- ``fetch`` all-gathers each process's tensor along dim 0 into one numpy
  array on every process.

In a one-process world each is the identity on its value.

    dist.init_parallel_env()
    mesh = multihost.global_mesh("dp")
    xb = multihost.global_batch(local_np, mesh, "dp")
    s = multihost.all_reduce_value(local_scalar)
"""

from __future__ import annotations

import numpy as np
import torch

from . import parallel_base as pb

_OPS = {"sum": pb.ReduceOp.SUM, "max": pb.ReduceOp.MAX,
        "min": pb.ReduceOp.MIN, "mean": pb.ReduceOp.SUM}


def process_count():
    return pb.WORLD.size if pb.multi_process() else 1


def process_index():
    return pb.WORLD.rank if pb.multi_process() else 0


def _device():
    if pb.multi_process():
        return pb.WORLD.device
    from ..device import resolve_device
    return resolve_device(None)


def global_mesh(axis_name="dp", devices=None):
    """A 1-D ``ProcessMesh`` over every process (rank i at position i);
    each process maps the positions to `devices` (default: its own
    device)."""
    from .auto_parallel.process_mesh import ProcessMesh
    return ProcessMesh(np.arange(process_count()), [axis_name],
                       devices=devices if devices is not None
                       else [_device()])


def global_batch(local_np, mesh=None, axis="dp"):
    """This process's shard of the global batch (dim 0 concatenated over
    the processes in rank order): its local rows, on its device."""
    return torch.as_tensor(np.asarray(local_np), device=_device())


def replicate(value, mesh=None, axis="dp"):
    """A value every process holds alike (same-seed initialised
    parameters, as the reference broadcasts from rank 0), on this
    process's device."""
    return torch.as_tensor(np.asarray(value), device=_device())


def all_reduce_value(local_value, op="sum", mesh=None, axis="dp"):
    """One per-process host value reduced over the processes in float32
    (a counted ``all_reduce`` on a host tensor); every process gets the
    result as a float32 numpy value."""
    if op not in _OPS:
        raise ValueError(f"all_reduce_value: op {op!r} (sum, max, min, "
                         "mean)")
    t = torch.tensor(np.asarray(local_value, np.float32))
    if pb.multi_process():
        pb.all_reduce(t, _OPS[op])
        if op == "mean":
            t = t / process_count()
    return t.numpy()


def fetch(global_array):
    """Every process's tensor concatenated along dim 0 (an all-gather),
    as numpy on every process."""
    t = torch.as_tensor(global_array)
    if not pb.multi_process():
        return t.detach().cpu().numpy()
    parts = pb.all_gather(None, t.detach())
    return np.concatenate([p.cpu().numpy() for p in parts], axis=0)
