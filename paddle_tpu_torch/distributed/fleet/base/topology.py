"""Hybrid topology: the counterpart of
``paddle_tpu/distributed/fleet/base/topology.py`` (``CommunicateTopology``,
``HybridCommunicateGroup``).

The hybrid mesh has the reference's fixed axis order [dp, pp, sharding,
mp, sep] and is ONE ``DeviceMesh``; each axis's group is the devices along
that axis with the other coordinates at 0 (single controller: rank 0's
view). Devices may repeat (a co-located mesh), so the mesh always exists;
the JAX package has no mesh when devices repeat, because a jax Mesh cannot
reuse a device.
"""

from __future__ import annotations

import collections

import numpy as np

from ...auto_parallel.process_mesh import DeviceMesh, _device_list
from ...parallel_base import group_of

_HCG = [None]

_AXES = ("dp", "pp", "sharding", "mp", "sep")


class CommunicateTopology:
    def __init__(self, hybrid_group_names=("data", "pipe", "sharding",
                                           "model", "sep"),
                 dims=(1, 1, 1, 1, 1)):
        self._names = list(hybrid_group_names)
        self._dims = list(dims)
        self._world = int(np.prod(dims))
        self._arr = np.arange(self._world).reshape(dims)

    def get_hybrid_group_names(self):
        return self._names

    def get_dim(self, axis_name):
        return self._dims[self._names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world

    def get_rank(self, **kw):
        idx = tuple(kw[n] for n in self._names)
        return int(self._arr[idx])

    def get_coord(self, rank):
        coord = np.unravel_index(rank, self._arr.shape)
        Coord = collections.namedtuple("Coord", self._names)
        return Coord(*[int(c) for c in coord])

    def get_axis_list(self, axis_name, index):
        axis = self._names.index(axis_name)
        taken = np.take(self._arr, index, axis=axis)
        return sorted(taken.reshape(-1).tolist())

    def get_comm_list(self, axis_name):
        axis = self._names.index(axis_name)
        moved = np.moveaxis(self._arr, axis, -1)
        return moved.reshape(-1, self._arr.shape[axis]).tolist()


class HybridCommunicateGroup:
    """``topology.py:189``: the per-axis degrees and groups over one hybrid
    ``DeviceMesh`` (``mesh``), shared with the mpu layers. `devices` (a
    device or a list; default the card) places the ranks."""

    def __init__(self, topology: CommunicateTopology, devices=None):
        self._topo = topology
        self.nranks = topology.world_size()
        self.global_rank = 0   # single controller

        self._dp_degree = topology.get_dim("data")
        self._pp_degree = topology.get_dim("pipe")
        self._sharding_degree = topology.get_dim("sharding")
        self._mp_degree = topology.get_dim("model")
        self._sep_degree = topology.get_dim("sep")

        shape = (self._dp_degree, self._pp_degree, self._sharding_degree,
                 self._mp_degree, self._sep_degree)
        devs = np.empty(self.nranks, dtype=object)
        for i, d in enumerate(_device_list(devices, self.nranks)):
            devs[i] = d
        self.mesh = DeviceMesh(devs.reshape(shape), _AXES)
        _HCG[0] = self

    # --- parallel info accessors (the reference's names) ---
    def get_parallel_mode(self):
        if self._pp_degree > 1:
            return "pipeline"
        if self._sharding_degree > 1:
            return "sharding_parallel"
        if self._mp_degree > 1:
            return "tensor_parallel"
        return "data_parallel"

    def topology(self):
        return self._topo

    def get_global_rank(self):
        return self.global_rank

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    # ranks (single controller: rank 0's view)
    def get_data_parallel_rank(self):
        return 0

    def get_model_parallel_rank(self):
        return 0

    def get_stage_id(self):
        return 0

    def get_sharding_parallel_rank(self):
        return 0

    def get_sep_parallel_rank(self):
        return 0

    def _axis_group(self, axis):
        g = group_of(self.mesh.axis_devices(axis), axis)
        g.id = hash(axis) % 10000
        return g

    def get_data_parallel_group(self):
        return self._axis_group("dp")

    def get_model_parallel_group(self):
        return self._axis_group("mp")

    def get_pipe_parallel_group(self):
        return self._axis_group("pp")

    def get_sharding_parallel_group(self):
        return self._axis_group("sharding")

    def get_sep_parallel_group(self):
        return self._axis_group("sep")

    def get_check_parallel_group(self, sharding=False):
        return group_of(self.mesh.flat, "world")

    def get_data_parallel_group_src_rank(self):
        return 0

    def get_model_parallel_group_src_rank(self):
        return 0

    def get_p2p_groups(self):
        return None


def get_hcg():
    return _HCG[0]
