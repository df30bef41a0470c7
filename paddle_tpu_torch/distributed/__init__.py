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
- ``checkpoint`` (the JAX package's file format, with the multi-host
  commit barrier), ``watchdog`` and ``resilient``;
- the multi-process world: ``init_parallel_env`` over
  ``torch.distributed`` and gloo when the launch environment names
  several processes, ``TCPStore`` (``store``), the ``launch`` CLI
  (``python -m paddle_tpu_torch.distributed.launch``), ``multihost``,
  ``spawn`` and the gloo helpers, and ``auto_tuner``.

One process drives every rank of a one-process world (see
``parallel_base``); in a multi-process world each process is one rank and
the collectives, ``gather``, ``alltoall_single`` and the object
collectives act across the processes.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from . import checkpoint, fleet, passes, resilient, watchdog  # noqa: F401
from . import auto_tuner, communication, launch, multihost  # noqa: F401
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
from .store import TCPStore  # noqa: F401
from .watchdog import CommTimeoutError, watched_wait  # noqa: F401

io = checkpoint


def get_backend(group=None):
    """"gloo" in a multi-process world; "nccl" for the one-process
    collectives (on the device, or torch.cuda.nccl across cards)."""
    from .parallel_base import multi_process
    return "gloo" if multi_process() else "nccl"


def is_available():
    return True


def split(*args, **kwargs):
    from .fleet.layers.mpu.mp_ops import split as _split
    return _split(*args, **kwargs)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """``paddle.distributed.spawn``: calls `func(*args)` once, as the JAX
    package's does (one process drives every local device; several
    processes come from the launch CLI, one per node)."""
    func(*args)


_GLOO_WORLD = [False]


def gloo_init_parallel_env(rank_id, rank_num, server_endpoint):
    """The gloo rendezvous: with one rank, ``init_parallel_env()`` as in
    the JAX package; with `rank_num` ranks, this process joins the gloo
    world as `rank_id`, met at `server_endpoint` ("host:port")."""
    from .parallel_base import _init_multi_process, is_initialized
    if rank_num <= 1:
        init_parallel_env()
        return
    if is_initialized():
        return
    host, _, port = server_endpoint.partition(":")
    _init_multi_process(int(rank_num), int(rank_id), None, "gloo", 300.0,
                        host=host, port=int(port))
    _GLOO_WORLD[0] = True


def gloo_barrier():
    barrier()


def gloo_release():
    """Leave the world ``gloo_init_parallel_env`` joined (nothing
    otherwise, as in the JAX package)."""
    if _GLOO_WORLD[0]:
        destroy_process_group()
        _GLOO_WORLD[0] = False


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


def _world_pg(group):
    """The torch process group of `group` (the world when None) in a
    multi-process world, else None."""
    from .parallel_base import _default_group, multi_process
    if not multi_process():
        return None
    return (group or _default_group()).pg


def all_gather_object(object_list, obj, group=None):
    """``all_gather_object``: every rank's `obj` (pickled over gloo)
    across processes; single controller, every rank's slot holds
    `obj`."""
    import torch.distributed as tdist

    from .parallel_base import _default_group
    pg = _world_pg(group)
    if pg is not None:
        out = [None] * (group or _default_group()).nranks
        tdist.all_gather_object(out, obj, group=pg)
        object_list.clear()
        object_list.extend(out)
        return
    n = (group or _default_group()).nranks if is_initialized() else 1
    object_list.clear()
    object_list.extend([obj] * max(n, 1))


def broadcast_object_list(object_list, src=0, group=None):
    """Rank `src`'s objects into every rank's `object_list` (torch's
    object broadcast across processes; single controller, pickled
    through a tensor broadcast, as in the JAX package)."""
    import torch.distributed as tdist
    pg = _world_pg(group)
    if pg is not None:
        tdist.broadcast_object_list(object_list, src=src, group=pg)
        return
    t = _pickle_to_tensor(object_list)
    broadcast(t, src=src, group=group)
    got = _tensor_to_obj(t)
    object_list.clear()
    object_list.extend(got)


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    """This rank's element of rank `src`'s `in_object_list`."""
    import torch.distributed as tdist
    pg = _world_pg(group)
    if pg is not None:
        got = [None]
        tdist.scatter_object_list(
            got, in_object_list if get_rank() == src else None, src=src,
            group=pg)
        out_object_list.clear()
        out_object_list.append(got[0])
        return
    objs = in_object_list or []
    out_object_list.clear()
    if objs:
        out_object_list.append(objs[get_rank() % len(objs)])


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """``communication/gather.py``: every rank's value into `gather_list`
    (the all-gather's list, across processes on every rank, `dst`
    included)."""
    if gather_list is None:
        gather_list = []
    out = []
    all_gather(out, tensor, group=group)
    gather_list.clear()
    gather_list.extend(out)
    return gather_list


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """``all_to_all.py`` alltoall_single: dim-0 pieces of `in_tensor`
    exchanged across processes; single controller, the identity layout
    (`out_tensor` takes `in_tensor`'s values)."""
    from . import parallel_base as _pb
    if _world_pg(group) is not None:
        _pb._count_collective("alltoall_single", in_tensor)
        return _pb.proc_alltoall_single(out_tensor, in_tensor,
                                        in_split_sizes, out_split_sizes,
                                        group)
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
