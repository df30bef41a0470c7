"""The port's ``distributed``, the counterpart of
``paddle_tpu.distributed``'s single-controller tensor parallelism and
training runtime:

- ``parallel_base``: the world and its groups, and the eager collectives
  (``all_reduce``, ``all_gather``, ``broadcast``, ``reduce``,
  ``scatter``, ``reduce_scatter``, ``alltoall``, ``barrier``, ``send`` /
  ``recv`` / ``isend`` / ``irecv``), with ``gather``, ``alltoall_single``
  and the object collectives here and the ``communication.stream``
  variants;
- ``auto_parallel``: ``ProcessMesh`` over torch devices, the placements
  and the semi-auto API (``shard_tensor``, ``reshard``, ...);
- ``auto_parallel``'s ``shard_optimizer`` with ``ShardingStage1-3``,
  ``DistModel`` / ``to_static`` and the moe helpers;
- ``fleet``: the hybrid topology, the mpu layers, the pipeline
  (``meta_parallel``), the sharding optimizers (``meta_optimizers``),
  ``utils`` (``recompute``, ``sequence_parallel_utils``) and
  ``fleet.elastic``;
- ``parallel.DataParallel``;
- ``checkpoint`` (the JAX package's file format, one process),
  ``watchdog`` and ``resilient``.

One process drives every rank (see ``parallel_base``). A multi-process
world, ``launch``, ``spawn``, ``TCPStore`` and the gloo helpers belong to
a later slice (ROADMAP §A.13) and raise.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from . import checkpoint, fleet, passes, resilient, watchdog  # noqa: F401
from . import communication  # noqa: F401
from .auto_parallel import (  # noqa: F401
    DeviceMesh, ProcessMesh, Shard, Replicate, Partial, PartitionSpec,
    shard_tensor, dtensor_from_fn, reshard, shard_layer, shard_optimizer,
    to_static, DistModel, Strategy, unshard_dtensor, dtensor_to_local,
    local_shards, moe_global_mesh_tensor, moe_sub_mesh_tensors,
    ShardingStage1, ShardingStage2, ShardingStage3,
)
from .auto_parallel.placement import Placement  # noqa: F401
from .auto_parallel.process_mesh import get_mesh, set_mesh  # noqa: F401
from .checkpoint import load_state_dict, save_state_dict  # noqa: F401
from .parallel import DataParallel  # noqa: F401
from .parallel_base import (  # noqa: F401
    init_parallel_env, is_initialized, get_rank, get_world_size,
    ParallelEnv, new_group, get_group, destroy_process_group, ReduceOp,
    all_reduce, all_gather, broadcast, reduce, scatter, reduce_scatter,
    alltoall, barrier, wait, Group, send, recv, isend, irecv,
)
from .resilient import (BadStepGuard, PeerFailureError,  # noqa: F401
                        RestartBudgetExceededError, ResilientTrainer)
from .watchdog import CommTimeoutError, watched_wait  # noqa: F401

io = checkpoint

_LATER = "belongs to a later slice of paddle_tpu_torch (ROADMAP §A.13: {})"


def get_backend():
    """Single-process collectives: on the device, or torch.cuda.nccl."""
    return "nccl"


def is_available():
    return True


def split(*args, **kwargs):
    from .fleet.layers.mpu.mp_ops import split as _split
    return _split(*args, **kwargs)


def _later(name, item):
    def raiser(*args, **kwargs):
        raise NotImplementedError(f"{name} " + _LATER.format(item))
    raiser.__name__ = name
    return raiser


spawn = _later("spawn", "a multi-process world")
gloo_init_parallel_env = _later("gloo_init_parallel_env",
                                "a multi-process world over gloo")
gloo_barrier = _later("gloo_barrier", "a multi-process world over gloo")
gloo_release = _later("gloo_release", "a multi-process world over gloo")


class TCPStore:
    """``paddle.distributed.TCPStore``: raises (a later slice)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "TCPStore " + _LATER.format("a multi-process world"))


def launch(*args, **kwargs):
    raise NotImplementedError("launch " + _LATER.format("launch"))


class ReduceType:
    """phi ReduceType (the partial reductions)."""
    kRedSum = 0
    kRedMax = 1
    kRedMin = 2
    kRedProd = 3
    kRedAvg = 4
    kRedAny = 5
    kRedAll = 6


class ParallelMode:
    """``distributed/parallel.py`` ParallelMode."""
    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3


class DistAttr:
    """``DistAttr(mesh, sharding_specs)``: the static-graph spec form of
    the (mesh, placements) pair."""

    def __init__(self, mesh, sharding_specs):
        self.process_mesh = mesh
        self.sharding_specs = sharding_specs


def _pickle_to_tensor(obj):
    return torch.from_numpy(np.frombuffer(pickle.dumps(obj),
                                          dtype=np.uint8).copy())


def _tensor_to_obj(t):
    return pickle.loads(bytes(t.cpu().numpy().tobytes()))


def all_gather_object(object_list, obj, group=None):
    """``all_gather_object``: single controller, every rank's slot holds
    `obj`."""
    from .parallel_base import _default_group
    n = (group or _default_group()).nranks if is_initialized() else 1
    object_list.clear()
    object_list.extend([obj] * max(n, 1))


def broadcast_object_list(object_list, src=0, group=None):
    """Pickled through a tensor broadcast, as in the JAX package."""
    t = _pickle_to_tensor(object_list)
    broadcast(t, src=src, group=group)
    got = _tensor_to_obj(t)
    object_list.clear()
    object_list.extend(got)


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    objs = in_object_list or []
    out_object_list.clear()
    if objs:
        out_object_list.append(objs[get_rank() % len(objs)])


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """``communication/gather.py``: every rank's value into `gather_list`
    (the all-gather's list)."""
    if gather_list is None:
        gather_list = []
    out = []
    all_gather(out, tensor, group=group)
    gather_list.clear()
    gather_list.extend(out)
    return gather_list


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """``all_to_all.py`` alltoall_single: single controller, the identity
    layout (`out_tensor` takes `in_tensor`'s values)."""
    with torch.no_grad():
        out_tensor.copy_(in_tensor)
    return out_tensor


def shard_dataloader(dataloader, meshes, shard_dims=None, is_dataset=False):
    """``auto_parallel/api.py`` shard_dataloader: the loader already yields
    the single controller's batches."""
    return dataloader


def shard_scaler(scaler):
    """``auto_parallel/api.py`` shard_scaler: GradScaler as it is."""
    return scaler
