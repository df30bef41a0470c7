"""Environment, groups and the eager collectives: the counterpart of
``paddle_tpu/distributed/parallel_base.py``.

The port keeps the JAX package's single-controller model: one Python
process drives every rank of a group, and a group is a list of devices,
one per rank, which may repeat (a co-located group: every rank on one
card, or on the CPU as the tests run). A collective takes either

- a tensor that stacks every rank's value on a leading group axis
  (``[nranks, ...]``, the JAX package's layout): the result is written back
  into it, every rank's slot holding it; a tensor without that leading
  axis is the replicated case (SUM gives ``nranks * x``, AVG and the rest
  give ``x``), as ``parallel_base.py:300-310`` does; or
- a list of per-rank tensors, one for each rank, each on its rank's
  device (the layout of the mesh engine's shards and the mpu layers):
  each element is updated in place, as each rank's tensor is under
  NCCL.

Where the ranks' values live decides how a reduction runs: on the device
itself when every rank is on one device (the ranks' values are reduced in
rank order, ``((x0 + x1) + x2) + ...``), and through ``torch.cuda.nccl``
(single-process, several cards) when the ranks sit on distinct CUDA
devices. Any other layout (ranks on a device other than the tensor's, a
mix of CPU and CUDA, two ranks sharing one of several cards) is refused
with a RuntimeError: nothing falls back. The ``torch.cuda.nccl`` path
needs a machine with two or more cards and has not run yet.

Every collective counts itself in ``collective_calls_total{op}`` and its
payload in ``collective_bytes_total{op}`` and, with a flight recorder
installed, leaves a begin/commit entry, as in the JAX package. The
collectives a step program issues (the mesh engine's all-reduces) go
through ``program_all_reduce`` / ``program_all_gather``, which the JAX
package's GSPMD programs have no API call for: they count nothing here and
are recorded instead into an open ``record_collectives()`` scope, which
the sharding observatory reads as a program's collective harvest.

Not in this slice (ROADMAP §A.13): a multi-process world
(``init_parallel_env`` with ``WORLD_SIZE`` > 1, ``launch``, ``TCPStore``,
``spawn``) raises.
"""

from __future__ import annotations

import contextlib
import os
import threading

import torch

from ..device import resolve_device
from ..observability.flight_recorder import RECORDER as _FLIGHT
from ..observability.metrics import REGISTRY as _REG, _ENABLED as _OBS_ON

_MULTI_PROCESS = ("a multi-process world belongs to a later slice of "
                  "paddle_tpu_torch (ROADMAP §A.13: init_parallel_env with "
                  "WORLD_SIZE > 1 over torch.distributed and gloo, launch, "
                  "multihost, TCPStore)")

# per-collective traffic counters, cached per op
_COLL_CALLS = {}
_COLL_BYTES = {}


def _nbytes(t):
    return int(t.numel() * t.element_size()) if torch.is_tensor(t) else 0


def _payload_nbytes(vals):
    n = 0
    for v in vals:
        if isinstance(v, (list, tuple)):
            n += sum(_nbytes(e) for e in v)
        else:
            n += _nbytes(v)
    return int(n)


def _count_collective(op, *vals):
    if not _OBS_ON[0]:
        return
    c = _COLL_CALLS.get(op)
    if c is None:
        c = _COLL_CALLS[op] = _REG.counter(
            "collective_calls_total", "collective invocations",
            labels={"op": op})
        _COLL_BYTES[op] = _REG.counter(
            "collective_bytes_total", "bytes moved through collectives",
            labels={"op": op})
    c.inc()
    _COLL_BYTES[op].inc(_payload_nbytes(vals))


def _flight_recorded(fn):
    """Record the wrapped collective in the flight recorder: begin at
    launch, commit on return (an exception leaves the entry pending, the
    post-mortem evidence of where the call stuck)."""
    op = fn.__name__

    def wrapper(*args, **kwargs):
        rec = _FLIGHT[0]
        if rec is None or not _OBS_ON[0]:
            return fn(*args, **kwargs)
        seq = rec.begin(op, _payload_nbytes(args))
        out = fn(*args, **kwargs)
        rec.commit(seq)
        return out

    wrapper.__name__ = op
    wrapper.__qualname__ = op
    wrapper.__doc__ = fn.__doc__
    wrapper.__wrapped__ = fn
    return wrapper


class ParallelEnv:
    """``paddle.distributed.ParallelEnv``."""

    @property
    def rank(self):
        return get_rank()

    @property
    def local_rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def device_id(self):
        return 0

    @property
    def nranks(self):
        return get_world_size()


class _GlobalState(threading.local):
    def __init__(self):
        self.initialized = False
        self.devices = None         # the world group's devices
        self.groups = {}            # gid -> Group
        self.next_gid = 1


_STATE = _GlobalState()


def is_initialized():
    return _STATE.initialized


def init_parallel_env(devices=None):
    """Make the world group (``parallel.py:978``): one rank per CUDA card
    of this process by default; `devices` (a device or a list, which may
    repeat one device) sets the ranks' devices, ``devices=["cpu"] * 8``
    being the tests' 8-rank world. Idempotent."""
    if _STATE.initialized:
        return ParallelEnv()
    n_procs = int(os.environ.get("PADDLE_TRAINERS_NUM",
                                 os.environ.get("WORLD_SIZE", "1")))
    if n_procs > 1:
        raise NotImplementedError(_MULTI_PROCESS)
    if devices is None:
        n = torch.cuda.device_count()
        devices = [resolve_device(None)] if n == 0 else \
            [torch.device("cuda", i) for i in range(n)]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices]
    devs = [resolve_device(d) for d in devices]
    _STATE.devices = devs
    _STATE.initialized = True
    _STATE.groups[0] = Group(0, list(range(len(devs))), devs, "world")
    return ParallelEnv()


def get_rank(group=None):
    """The single controller is rank 0 of every group."""
    return 0


def get_world_size(group=None):
    if group is not None:
        return group.nranks
    if _STATE.initialized:
        return len(_STATE.devices)
    return max(1, torch.cuda.device_count())


def _default_group():
    if not _STATE.initialized:
        init_parallel_env()
    return _STATE.groups[0]


class Group:
    """A communicator: ranks and the device each runs on
    (``communication/group.py``'s Group)."""

    def __init__(self, gid, ranks, devices, axis_name):
        self.id = gid
        self.ranks = list(ranks)
        self.nranks = len(self.ranks)
        self.devices = [torch.device(d) for d in devices]
        self.axis_name = axis_name

    @property
    def process_group(self):
        return self

    @property
    def world_size(self):
        return self.nranks

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    def __repr__(self):
        return f"Group(id={self.id}, nranks={self.nranks})"


def new_group(ranks=None, backend=None, timeout=None):
    """A group over the world group's ranks `ranks`
    (``collective.py:194``)."""
    g0 = _default_group()
    if ranks is None:
        ranks = list(range(g0.nranks))
    gid = _STATE.next_gid
    _STATE.next_gid += 1
    g = Group(gid, ranks, [g0.devices[r] for r in ranks], "sub")
    _STATE.groups[gid] = g
    return g


def group_of(devices, axis_name="mesh"):
    """A group over `devices` (one rank each) outside the world's
    registry: the communicator of a mesh axis."""
    devices = list(devices)
    return Group(-1, list(range(len(devices))), devices, axis_name)


# ---------------- where a collective runs ----------------

class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_NCCL_OPS = {"sum": 0, "prod": 1, "max": 2, "min": 3}


def _op_name(op):
    return op if isinstance(op, str) else "sum"


def _route(devices, what):
    """"local" when every rank's value is on one device, "nccl" when each
    sits on its own CUDA card; raises otherwise."""
    devs = [torch.device(d) for d in devices]
    if len(set(devs)) == 1:
        return "local"
    if all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs):
        return "nccl"
    raise RuntimeError(f"{what}: cannot serve ranks on devices "
                       f"{[str(d) for d in devs]} (one device for every "
                       "rank, or one CUDA card each)")


def _combine(op, a, b):
    if op == "max":
        return torch.maximum(a, b)
    if op == "min":
        return torch.minimum(a, b)
    if op == "prod":
        return a * b
    return a + b


def _reduce_local(vals, op):
    """The ranks' values (one device) reduced in rank order."""
    op = _op_name(op)
    acc = vals[0]
    for v in vals[1:]:
        acc = _combine(op, acc, v)
    if op == "avg":
        acc = acc / len(vals)
    return acc


def _nccl_all_reduce(parts, op):
    """In-place all-reduce of per-card tensors through torch.cuda.nccl."""
    from torch.cuda import nccl
    op = _op_name(op)
    parts = [p.contiguous() for p in parts]
    nccl.all_reduce(parts, op=_NCCL_OPS["sum" if op == "avg" else op])
    if op == "avg":
        for p in parts:
            p.div_(len(parts))
    return parts


def _nccl_all_gather(parts, dim):
    from torch.cuda import nccl
    n = len(parts)
    src = [p.contiguous() for p in parts]
    outs = [torch.empty((n,) + tuple(p.shape), dtype=p.dtype,
                        device=p.device) for p in src]
    nccl.all_gather(src, outs)
    return [torch.cat(list(o.unbind(0)), dim=dim) for o in outs]


def reduce_parts(parts, op=ReduceOp.SUM, what="all_reduce"):
    """Reduce a list of per-rank tensors; every element is overwritten
    with the result (in place). Returns the list."""
    if _route([p.device for p in parts], what) == "nccl":
        out = _nccl_all_reduce(list(parts), op)
        for p, o in zip(parts, out):
            if o is not p:
                p.copy_(o)
        return parts
    # in rank order, accumulated into rank 0's tensor, then copied out
    op = _op_name(op)
    acc = parts[0]
    for v in parts[1:]:
        if op == "max":
            torch.maximum(acc, v, out=acc)
        elif op == "min":
            torch.minimum(acc, v, out=acc)
        elif op == "prod":
            acc.mul_(v)
        else:
            acc.add_(v)
    if op == "avg":
        acc.div_(len(parts))
    for p in parts[1:]:
        p.copy_(acc)
    return parts


def gather_parts(parts, dim, what="all_gather"):
    """The concatenation along `dim` of per-rank tensors, one for each
    rank on its device (co-located ranks share one tensor)."""
    if _route([p.device for p in parts], what) == "nccl":
        return _nccl_all_gather(list(parts), dim)
    full = torch.cat(list(parts), dim=dim)
    return [full] * len(parts)


# ---------------- collectives inside step programs ----------------

_SCOPE = threading.local()


@contextlib.contextmanager
def record_collectives():
    """Collect the collectives that step programs issue in this thread
    meanwhile: yields {op: {"count", "bytes", "max_group"}} under the HLO
    op names (``all-reduce``, ``all-gather``), ``bytes`` being the
    per-rank payload summed over the calls, as a program's harvest counts
    them."""
    found = {}
    stack = getattr(_SCOPE, "stack", None)
    if stack is None:
        stack = _SCOPE.stack = []
    stack.append(found)
    try:
        yield found
    finally:
        stack.remove(found)


def note_program_collective(op, part_nbytes, n):
    """Record one collective of a step program: `op` (an HLO name), its
    per-rank payload bytes and its group size."""
    for found in getattr(_SCOPE, "stack", ()):
        e = found.setdefault(op, {"count": 0, "bytes": 0, "max_group": 1})
        e["count"] += 1
        e["bytes"] += int(part_nbytes)
        e["max_group"] = max(e["max_group"], int(n))


def program_all_reduce(parts, op=ReduceOp.SUM):
    """A step program's all-reduce over per-rank tensors (in place;
    returns the list), recorded for the harvest and counted nowhere
    else."""
    note_program_collective("all-reduce", _nbytes(parts[0]), len(parts))
    return reduce_parts(parts, op)


def program_all_gather(parts, dim):
    """A step program's all-gather along `dim` (see ``gather_parts``),
    recorded for the harvest (per-rank payload: the gathered result)."""
    out = gather_parts(parts, dim)
    note_program_collective("all-gather", _nbytes(out[0]), len(parts))
    return out


# ---------------- the eager collectives ----------------

def _is_list(x):
    return isinstance(x, (list, tuple))


def _stacked(tensor, n):
    return tensor.dim() > 0 and tensor.shape[0] == n


def _write(tensor, value):
    with torch.no_grad():
        tensor.copy_(value)
    return tensor


def _stacked_reduce(group, val, op, what):
    """[n, ...] rank-stacked values reduced; [n, ...] result."""
    route = _route(group.devices, what)
    if route == "local":
        if group.devices[0] != val.device:
            raise RuntimeError(f"{what}: the group's ranks are on "
                               f"{group.devices[0]}, the tensor on "
                               f"{val.device}")
        red = _reduce_local(list(val.unbind(0)), op)
        return red[None].expand_as(val)
    parts = [val[i].to(d) for i, d in enumerate(group.devices)]
    parts = _nccl_all_reduce(parts, op)
    return torch.stack([p.to(val.device) for p in parts])


@_flight_recorded
def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce across the group (see the module docstring for the two
    layouts). Returns the tensor (or list), updated in place."""
    _count_collective("all_reduce", tensor)
    group = group or _default_group()
    if _is_list(tensor):
        with torch.no_grad():
            return reduce_parts(list(tensor), op)
    n = group.nranks
    if _stacked(tensor, n):
        return _write(tensor, _stacked_reduce(group, tensor.detach(), op,
                                              "all_reduce"))
    # replicated layout: every rank holds the same value
    if _op_name(op) == "sum":
        return _write(tensor, tensor.detach() * n)
    return tensor


@_flight_recorded
def all_gather(tensor_list, tensor, group=None, sync_op=True):
    """Every rank's value: the slices of a rank-stacked tensor, the
    elements of a per-rank list, or `tensor` itself nranks times. Fills
    and returns `tensor_list` (a new list when it is None)."""
    _count_collective("all_gather", tensor)
    group = group or _default_group()
    n = group.nranks
    if _is_list(tensor):
        slices = [t.detach().clone() for t in tensor]
    elif _stacked(tensor, n):
        slices = [tensor[i].detach().clone() for i in range(n)]
    else:
        slices = [tensor.detach().clone() for _ in range(n)]
    if tensor_list is None:
        return slices
    tensor_list.clear()
    tensor_list.extend(slices)
    return tensor_list


@_flight_recorded
def broadcast(tensor, src=0, group=None, sync_op=True):
    """Every rank's slot takes rank `src`'s value."""
    _count_collective("broadcast", tensor)
    group = group or _default_group()
    n = group.nranks
    src_local = group.get_group_rank(src) if src in group.ranks else src
    if _is_list(tensor):
        with torch.no_grad():
            for t in tensor:
                if t is not tensor[src_local]:
                    t.copy_(tensor[src_local])
        return tensor
    if _stacked(tensor, n):
        return _write(tensor,
                      tensor.detach()[src_local][None].expand_as(tensor))
    return tensor


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """As ``all_reduce`` (the JAX package's single-controller reduce)."""
    return all_reduce(tensor, op, group, sync_op)


@_flight_recorded
def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """This rank's (0's) element of `tensor_list` into `tensor`."""
    _count_collective("scatter", tensor_list or tensor)
    if tensor_list:
        return _write(tensor, tensor_list[get_rank()])
    return tensor


@_flight_recorded
def reduce_scatter(tensor, tensor_list, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """`tensor_list`'s per-rank contributions reduced into `tensor`."""
    _count_collective("reduce_scatter", tensor_list)
    return _write(tensor, _reduce_local([t.detach() for t in tensor_list],
                                        op))


@_flight_recorded
def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """Single controller: the (src, dst) chunk matrix is its own
    transpose; `out_tensor_list` takes copies of the inputs."""
    _count_collective("alltoall", in_tensor_list)
    out_tensor_list.clear()
    out_tensor_list.extend(t.detach().clone() for t in in_tensor_list)
    return out_tensor_list


@_flight_recorded
def barrier(group=None):
    _count_collective("barrier")
    group = group or _default_group()
    for d in sorted({d for d in group.devices if d.type == "cuda"},
                    key=str):
        torch.cuda.synchronize(d)


# ---- send/recv: a single-controller mailbox keyed (group, dst, tag) ----

_P2P_MAILBOX = {}


@_flight_recorded
def send(tensor, dst=0, group=None, sync_op=True, tag=0):
    _count_collective("send", tensor)
    group = group or _default_group()
    _P2P_MAILBOX.setdefault((group.id, dst, tag), []).append(
        tensor.detach().clone())


@_flight_recorded
def recv(tensor, src=0, group=None, sync_op=True, tag=0):
    _count_collective("recv", tensor)
    group = group or _default_group()
    box = _P2P_MAILBOX.get((group.id, get_rank(), tag))
    if not box:
        raise RuntimeError(
            f"recv(src={src}): no matching send in flight for rank "
            f"{get_rank()} (single-controller P2P pairs send-before-recv "
            "per (group, dst, tag))")
    return _write(tensor, box.pop(0))


class _P2PTask:
    def __init__(self, result=None):
        self._result = result

    def wait(self):
        return self._result

    def is_completed(self):
        return True


def isend(tensor, dst=0, group=None, tag=0):
    send(tensor, dst, group, sync_op=False, tag=tag)
    return _P2PTask()


def irecv(tensor, src=0, group=None, tag=0):
    return _P2PTask(recv(tensor, src, group, sync_op=False, tag=tag))


def wait(tensor, group=None, use_calc_stream=True):
    from .watchdog import watched_wait
    if torch.is_tensor(tensor):
        watched_wait(tensor, what="distributed.wait")


def get_group(gid=0):
    return _STATE.groups.get(gid)


def destroy_process_group(group=None):
    if group is None:
        _STATE.groups.clear()
        _STATE.initialized = False
        _STATE.devices = None
    else:
        _STATE.groups.pop(group.id, None)
