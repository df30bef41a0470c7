"""``DataParallel``: the counterpart of
``paddle_tpu/distributed/parallel.py:22`` (the reference's
``paddle.DataParallel``, ``parallel.py:219``, with its EagerReducer's
gradient buckets, ``reducer.h:88``).

The JAX package shards the batch over the mesh's dp axis and lets GSPMD
sum the gradients. The port, single-controller, splits the batch over the
dp ranks (dim 0, equal pieces) and runs each rank's piece through the
model with that rank's replica of the parameters (on the rank's device;
on a shared device the replica shares the parameter's storage), so each
rank's gradient lands on its own replica instead of autograd summing them
into one tensor. The output is the ranks' outputs concatenated, so a loss
over it is the global batch's. The gradients are then reduced with an
explicit ``all_reduce`` over the dp ranks, one per bucket, counted in
``collective_calls_total{op="all_reduce"}``: the sum of the ranks'
gradients, the global-batch gradient that JAX's version computes
(``parallel.py:38-47``), is added into each parameter's ``.grad``.

Buckets: the parameters in reverse registration order (the order their
gradients tend to arrive), packed greedily; a bucket closes once it holds
at least ``last_comm_buffer_size`` MB (the first bucket) or
``comm_buffer_size`` MB (the others), so a parameter larger than that
makes a bucket of its own. A bucket is reduced as soon as every rank's
gradient of every parameter in it has arrived, during the backward; a
bucket left incomplete at the end of the backward (a parameter the
forward did not use) is reduced then with zeros for the missing ones.
"""

from __future__ import annotations

import torch

from ..nn.layers import Layer
from . import parallel_base as pb

_MB = 1 << 20


def _rank_devices(group, mesh, dp_axis):
    if group is not None:
        return list(group.devices)
    if mesh is not None:
        dm = mesh.get_device_mesh() if hasattr(mesh, "get_device_mesh") \
            else mesh
        return dm.axis_devices(dp_axis)
    return list(pb._default_group().devices)


def _buckets(params, first_mb, rest_mb):
    """Lists of parameters, reverse registration order, packed greedily
    (see the module docstring)."""
    out, cur, size = [], [], 0
    cap = first_mb * _MB
    for p in reversed(params):
        cur.append(p)
        size += p.numel() * p.element_size()
        if size >= cap:
            out.append(cur)
            cur, size, cap = [], 0, rest_mb * _MB
    if cur:
        out.append(cur)
    return out


class _Reduction:
    """One backward's gradient reduction: the ranks' replicas of each
    parameter and the buckets still waiting for gradients."""

    def __init__(self, dp, replicas):
        self.dp = dp
        self.replicas = replicas        # [rank] -> {name: replica}
        self.pending = [set(range(len(b))) for b in dp._bucket_names]
        self.arrived = [dict() for _ in dp._bucket_names]
        self.queued = False

    def arrive(self, b, i, r):
        got = self.arrived[b].setdefault(i, set())
        got.add(r)
        if len(got) == len(self.replicas):
            self.pending[b].discard(i)
            if not self.pending[b]:
                self.reduce(b)
        if not self.queued:
            self.queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self.finish)

    def finish(self):
        for b, left in enumerate(self.pending):
            if left:
                self.reduce(b)
                left.clear()

    @torch.no_grad()
    def reduce(self, b):
        names = self.dp._bucket_names[b]
        flats = []
        for reps in self.replicas:
            parts = []
            for n in names:
                r = reps[n]
                g = r.grad if r.grad is not None else torch.zeros_like(r)
                parts.append(g.reshape(-1))
            flats.append(torch.cat(parts))
        pb.all_reduce(flats, group=self.dp._group)
        total, off = flats[0], 0
        for n in names:
            p = self.dp._params[n]
            g = total[off:off + p.numel()].view(p.shape).to(p.device)
            off += p.numel()
            if p.grad is None:
                p.grad = g.clone()
            else:
                p.grad.add_(g)


class DataParallel(Layer):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None, mesh=None, dp_axis="dp"):
        super().__init__()
        self._layers = layers
        self._devices = _rank_devices(group, mesh, dp_axis)
        self._group = pb.group_of(self._devices, "dp")
        self._params = dict(layers.named_parameters())
        named = {id(p): n for n, p in self._params.items()}
        trainable = [p for p in self._params.values() if p.requires_grad]
        self._bucket_names = [
            [named[id(p)] for p in b]
            for b in _buckets(trainable, last_comm_buffer_size,
                              comm_buffer_size)]

    @property
    def nranks(self):
        return len(self._devices)

    def _split(self, x):
        n = self.nranks
        if not torch.is_tensor(x) or x.dim() == 0:
            return [x] * n
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} does not split over "
                             f"{n} dp ranks")
        return [piece.to(d) for piece, d in zip(x.chunk(n), self._devices)]

    def forward(self, *inputs, **kwargs):
        if self.nranks == 1 or not torch.is_grad_enabled():
            return self._layers(*inputs, **kwargs)
        pieces = [self._split(x) for x in inputs]
        home = self._devices[0]
        buffers = dict(self._layers.named_buffers())
        replicas, outs = [], []
        for r, dev in enumerate(self._devices):
            reps = {n: p.detach().to(dev).requires_grad_(p.requires_grad)
                    for n, p in self._params.items()}
            bufs = {n: b.to(dev) for n, b in buffers.items()}
            replicas.append(reps)
            outs.append(torch.func.functional_call(
                self._layers, {**reps, **bufs},
                tuple(pc[r] for pc in pieces), kwargs))
        red = _Reduction(self, replicas)
        for b, names in enumerate(self._bucket_names):
            for i, n in enumerate(names):
                for r, reps in enumerate(replicas):
                    reps[n].register_post_accumulate_grad_hook(
                        lambda t, b=b, i=i, r=r: red.arrive(b, i, r))
        return _concat(outs, home)

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        """The reduction runs in the backward already."""

    def named_parameters(self, prefix="", recurse=True,
                         remove_duplicate=True):
        return self._layers.named_parameters(prefix, recurse,
                                             remove_duplicate)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        return self._layers.load_state_dict(*args, **kwargs)

    def set_state_dict(self, *args, **kwargs):
        return self._layers.set_state_dict(*args, **kwargs)


def _concat(outs, home):
    first = outs[0]
    if torch.is_tensor(first):
        return torch.cat([o.to(home) for o in outs], dim=0)
    if isinstance(first, (tuple, list)):
        return type(first)(_concat([o[i] for o in outs], home)
                           for i in range(len(first)))
    return first
