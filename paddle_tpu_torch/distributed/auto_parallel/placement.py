"""Placements: the counterpart of
``paddle_tpu/distributed/auto_parallel/placement.py``.

``Shard(d)`` / ``Replicate()`` / ``Partial(op)`` describe how a tensor
maps onto one mesh dimension. A placements list over the mesh dims
converts to a ``PartitionSpec`` (tensor dim -> mesh axis names, the
port's copy of ``jax.sharding.PartitionSpec``) and back.
"""

from __future__ import annotations


class PartitionSpec(tuple):
    """A tuple of per-tensor-dim entries: None (replicated along that
    dim), an axis name, or a tuple of axis names (major first)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


class Placement:
    def is_shard(self, dim=None):
        return False

    def is_replicate(self):
        return False

    def is_partial(self):
        return False


class Shard(Placement):
    def __init__(self, dim):
        self.dim = int(dim)

    def is_shard(self, dim=None):
        return dim is None or dim == self.dim

    def get_dim(self):
        return self.dim

    def __repr__(self):
        return f"Shard(dim={self.dim})"

    def __eq__(self, o):
        return isinstance(o, Shard) and o.dim == self.dim

    def __hash__(self):
        return hash(("shard", self.dim))


class Replicate(Placement):
    def is_replicate(self):
        return True

    def __repr__(self):
        return "Replicate()"

    def __eq__(self, o):
        return isinstance(o, Replicate)

    def __hash__(self):
        return hash("replicate")


class Partial(Placement):
    def __init__(self, reduce_type="sum"):
        self.reduce_type = getattr(reduce_type, "name", reduce_type)

    def is_partial(self):
        return True

    def __repr__(self):
        return f"Partial({self.reduce_type})"

    def __eq__(self, o):
        return isinstance(o, Partial) and o.reduce_type == self.reduce_type

    def __hash__(self):
        return hash(("partial", self.reduce_type))


def placements_to_spec(mesh, placements, ndim):
    """placements[i] describes mesh dim i. Build the PartitionSpec mapping
    tensor dims to mesh dim names (several mesh dims on one tensor dim ->
    a tuple), trailing Nones trimmed."""
    dim_map = [[] for _ in range(ndim)]
    for mesh_dim, p in enumerate(placements):
        if isinstance(p, Shard):
            dim_map[p.dim].append(mesh.dim_names[mesh_dim])
    spec = []
    for names in dim_map:
        if not names:
            spec.append(None)
        elif len(names) == 1:
            spec.append(names[0])
        else:
            spec.append(tuple(names))
    while spec and spec[-1] is None:
        spec.pop()
    return PartitionSpec(*spec)


def spec_to_placements(mesh, spec, ndim):
    placements = [Replicate() for _ in mesh.dim_names]
    for tdim, entry in enumerate(spec):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        for name in names:
            placements[list(mesh.dim_names).index(name)] = Shard(tdim)
    return placements
