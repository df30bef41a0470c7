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

In a multi-process world (``parallel_base.multi_process()``) each process
is one dp rank with its own replica and its own piece of the batch, as
in the reference: the layers run as they are on the process's input, and
each bucket's gradients are averaged over the processes by one counted
``all_reduce`` (AVG; a flat tensor a dtype) as soon as the bucket's
gradients have accumulated, in the same order on every process. The
parameters and buffers are broadcast from rank 0 when the wrapper is
made (``sync_params_buffers``). A parameter that a stage-2 or stage-3
ZeRO engine marks (``_zero_reduce_scatter``) keeps its local gradient:
the engine's step moves it to its owner by a reduce-scatter.
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


class _ProcReduction:
    """The gradient averaging of a multi-process DataParallel: hooks on
    the parameters count each bucket's arrivals in a backward."""

    def __init__(self, dp):
        self.dp = dp
        self.arrived = [set() for _ in dp._bucket_names]
        self.done = [False] * len(dp._bucket_names)
        self.queued = False

    def arrive(self, b, i):
        self.arrived[b].add(i)
        if len(self.arrived[b]) == len(self.dp._bucket_names[b]):
            self.reduce(b)
        if not self.queued:
            self.queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self.finish)

    def finish(self):
        for b in range(len(self.arrived)):
            if not self.done[b] and self.arrived[b]:
                self.reduce(b)
        self.dp._pending = None

    @torch.no_grad()
    def reduce(self, b):
        self.done[b] = True
        params = [self.dp._params[n] for n in self.dp._bucket_names[b]]
        params = [p for p in params
                  if not getattr(p, "_zero_reduce_scatter", False)]
        by_dtype = {}
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            by_dtype.setdefault(p.grad.dtype, []).append(p)
        for ps in by_dtype.values():
            flat = torch.cat([p.grad.reshape(-1) for p in ps])
            pb.all_reduce(flat, op=pb.ReduceOp.AVG, group=self.dp._group)
            off = 0
            for p in ps:
                p.grad.copy_(flat[off:off + p.numel()].view(p.grad.shape))
                off += p.numel()


class DataParallel(Layer):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None, mesh=None, dp_axis="dp"):
        super().__init__()
        self._layers = layers
        if pb.multi_process():
            self._init_processes(group, comm_buffer_size,
                                 last_comm_buffer_size)
            return
        self._procs = False
        self._devices = _rank_devices(group, mesh, dp_axis)
        self._group = pb.group_of(self._devices, "dp")
        self._params = dict(layers.named_parameters())
        named = {id(p): n for n, p in self._params.items()}
        trainable = [p for p in self._params.values() if p.requires_grad]
        self._bucket_names = [
            [named[id(p)] for p in b]
            for b in _buckets(trainable, last_comm_buffer_size,
                              comm_buffer_size)]

    def _init_processes(self, group, comm_buffer_size,
                        last_comm_buffer_size):
        self._procs = True
        self._group = group or pb._default_group()
        self._devices = [pb.WORLD.device]
        self._params = dict(self._layers.named_parameters())
        named = {id(p): n for n, p in self._params.items()}
        trainable = [p for p in self._params.values() if p.requires_grad]
        self._bucket_names = [
            [named[id(p)] for p in b]
            for b in _buckets(trainable, last_comm_buffer_size,
                              comm_buffer_size)]
        self._pending = None
        self.sync_params_buffers()
        for b, names in enumerate(self._bucket_names):
            for i, n in enumerate(names):
                self._params[n].register_post_accumulate_grad_hook(
                    lambda t, b=b, i=i: self._arrive(b, i))

    def _arrive(self, b, i):
        if self._pending is None:
            self._pending = _ProcReduction(self)
        self._pending.arrive(b, i)

    @torch.no_grad()
    def sync_params_buffers(self, src_rank=0):
        """Rank `src_rank`'s parameters and buffers into every process's
        (one counted broadcast a tensor)."""
        tensors = list(self._layers.parameters()) + \
            list(self._layers.buffers())
        for t in tensors:
            if t.numel():
                pb.broadcast(t.data, src=src_rank, group=self._group)

    @property
    def nranks(self):
        return self._group.nranks if self._procs else len(self._devices)

    def _split(self, x):
        n = self.nranks
        if not torch.is_tensor(x) or x.dim() == 0:
            return [x] * n
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} does not split over "
                             f"{n} dp ranks")
        return [piece.to(d) for piece, d in zip(x.chunk(n), self._devices)]

    def forward(self, *inputs, **kwargs):
        if self._procs or self.nranks == 1 or not torch.is_grad_enabled():
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
