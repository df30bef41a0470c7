"""ProcessMesh and the device mesh under it: the counterpart of
``paddle_tpu/distributed/auto_parallel/process_mesh.py``.

A ``ProcessMesh`` is a named nd-array of ranks, as in the JAX package. Its
``get_device_mesh()`` (the JAX package's ``get_jax_mesh()``) places rank i
on ``devices[i % len(devices)]``, a ``DeviceMesh``: an nd-array of
``torch.device`` with axis names, the port's ``jax.sharding.Mesh``.

The port is single-controller, as the JAX package is: one Python process
drives every position of a mesh. Positions may repeat a device (a
co-located mesh: every shard on one card, or every shard on the CPU as
the tests run), and each shard is then a tensor of its own on that device.
``devices=None`` places every position on the card
(``device.resolve_device``); a mesh is on the CPU only when the caller
passes ``devices="cpu"``.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ...device import resolve_device


def _device_list(devices, n):
    """`devices` (None: the card; one device; or a list) as a list of `n`
    torch devices, position i on devices[i % len(devices)]."""
    if devices is None or isinstance(devices, (str, torch.device)):
        return [resolve_device(devices)] * n
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return [devs[i % len(devs)] for i in range(n)]


class DeviceMesh:
    """An nd-array of ``torch.device`` (``devices``) with ``axis_names``;
    ``shape`` maps each axis name to its size, as ``jax.sharding.Mesh``'s
    does."""

    def __init__(self, devices, axis_names):
        arr = np.empty(np.shape(devices), dtype=object)
        flat = [torch.device(d) for d in np.asarray(devices,
                                                    dtype=object).flat]
        for i, d in enumerate(flat):
            arr.flat[i] = d
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d devices for axes {axis_names}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self):
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    @property
    def flat(self):
        """The devices in flat (row-major) position order."""
        return list(self.devices.flat)

    @property
    def co_located(self):
        """True when every position is on one device."""
        return len(set(self.flat)) == 1

    def axis_devices(self, axis, **fixed):
        """The devices along `axis` with the other axes at `fixed` (each
        default 0): the members of one group along that axis."""
        idx = tuple(slice(None) if n == axis else int(fixed.get(n, 0))
                    for n in self.axis_names)
        return list(self.devices[idx].flat)

    def __repr__(self):
        return (f"DeviceMesh(shape={dict(self.shape)}, "
                f"devices={[str(d) for d in self.flat]})")


class ProcessMesh:
    def __init__(self, mesh, dim_names=None, shape=None, process_ids=None,
                 devices=None):
        if mesh is not None:
            arr = np.asarray(mesh)
        else:
            arr = np.asarray(process_ids).reshape(shape)
        self._mesh_arr = arr
        if dim_names is None:
            dim_names = [f"d{i}" for i in range(arr.ndim)]
        self._dim_names = list(dim_names)
        self._devices = devices
        self._device_mesh = None

    @property
    def shape(self):
        return list(self._mesh_arr.shape)

    @property
    def ndim(self):
        return self._mesh_arr.ndim

    @property
    def dim_names(self):
        return self._dim_names

    @property
    def mesh(self):
        return self._mesh_arr

    @property
    def process_ids(self):
        return self._mesh_arr.reshape(-1).tolist()

    @property
    def size(self):
        return int(self._mesh_arr.size)

    def get_dim_size(self, dim_name):
        return self._mesh_arr.shape[self._dim_names.index(dim_name)]

    def get_device_mesh(self):
        """The ``DeviceMesh`` of this mesh: process id i on device
        ``devices[i % len(devices)]`` (made once, on first use)."""
        if self._device_mesh is None:
            flat = self._mesh_arr.reshape(-1)
            devs = _device_list(self._devices, int(flat.max()) + 1
                                if flat.size else 0)
            arr = np.empty(self._mesh_arr.shape, dtype=object)
            for i, pid in enumerate(flat):
                arr.flat[i] = devs[int(pid)]
            self._device_mesh = DeviceMesh(arr, self._dim_names)
        return self._device_mesh

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh)
                and self._dim_names == other._dim_names
                and np.array_equal(self._mesh_arr, other._mesh_arr))

    def __hash__(self):
        return hash((tuple(self._dim_names), self._mesh_arr.tobytes(),
                     self._mesh_arr.shape))

    def __repr__(self):
        return (f"ProcessMesh(shape={self.shape}, "
                f"dim_names={self._dim_names})")

    def __getitem__(self, idx):
        sub = self._mesh_arr[idx]
        if sub.ndim == self._mesh_arr.ndim:
            names = self._dim_names
        else:
            # dropped leading dims
            dropped = self._mesh_arr.ndim - sub.ndim
            names = self._dim_names[dropped:]
        return ProcessMesh(sub, names, devices=self._devices)


def get_mesh():
    from . import api
    return api._GLOBAL_MESH[0]


def set_mesh(mesh):
    from . import api
    api._GLOBAL_MESH[0] = mesh
