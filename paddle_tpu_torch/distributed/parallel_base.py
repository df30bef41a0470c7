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

The multi-process world: with ``PADDLE_TRAINERS_NUM`` (or ``WORLD_SIZE``)
above 1, ``init_parallel_env`` joins a ``torch.distributed`` process group
over gloo, met at the port's ``TCPStore`` on ``PADDLE_MASTER`` /
``MASTER_ADDR`` and ``MASTER_PORT`` (the environment ``launch`` sets, as
``parallel_base.py:134-160`` of the JAX package reads it). Each process is
one rank with one device (the card unless the CPU was asked for), and
every collective acts on this process's own tensor across the processes,
as Paddle's per-process ranks do: ``get_rank`` is the process's rank,
``new_group`` a torch subgroup. Gloo moves data through host memory, so
a CUDA tensor goes through an explicit host copy, whose bytes are counted
(``proc_stats()``, and ``collective_staged_bytes_total{op}``).
``proc_stats()`` also keeps the cross-process calls, payload bytes and
host seconds by op. A one-process world keeps the single-controller forms
above.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import threading
import time

import torch

from ..device import resolve_device
from ..observability.flight_recorder import RECORDER as _FLIGHT
from ..observability.metrics import REGISTRY as _REG, _ENABLED as _OBS_ON

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
        dev = WORLD.device
        if dev is None or dev.type != "cuda":
            return 0
        return dev.index or 0

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


class _World:
    """This process's place in a multi-process world (process-wide, not
    per thread: a writer thread reads the same rank)."""

    def __init__(self):
        self.active = False
        self.rank = 0
        self.size = 1
        self.device = None
        self.store = None
        self.group = None           # the world Group


WORLD = _World()


def is_initialized():
    return WORLD.active or _STATE.initialized


def multi_process():
    """True once this process has joined a world of several processes."""
    return WORLD.active


def _env_world():
    """(processes, rank, master host, master port) from the launch
    environment, read as ``parallel_base.py:142-153`` of the JAX package
    reads it."""
    n = int(os.environ.get("PADDLE_TRAINERS_NUM",
                           os.environ.get("WORLD_SIZE", "1")))
    rank = int(os.environ.get("PADDLE_TRAINER_ID",
                              os.environ.get("RANK", "0")))
    master = os.environ.get("PADDLE_MASTER",
                            os.environ.get("MASTER_ADDR", ""))
    port = int(os.environ.get("MASTER_PORT", "8476"))
    return n, rank, master.split(":")[0], port


def _process_device(devices, rank):
    """This process's device: `devices` (a device, or a list indexed by
    rank), else the current device (the card unless the CPU was asked
    for), a card picked by rank when several are visible."""
    if isinstance(devices, (list, tuple)):
        devices = devices[rank]
    dev = resolve_device(devices)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def _init_multi_process(n, rank, devices, backend, timeout, host=None,
                        port=None):
    import torch.distributed as tdist

    from .store import TCPStore
    if backend not in (None, "gloo"):
        raise ValueError(f"init_parallel_env(backend={backend!r}): the "
                         "multi-process world runs over gloo")
    if host is None:
        _, _, host, port = _env_world()
    if not host:
        raise RuntimeError(
            f"init_parallel_env: {n} processes but no master address "
            "(PADDLE_MASTER or MASTER_ADDR, with MASTER_PORT; the launch "
            "CLI sets them)")
    dev = _process_device(devices, rank)
    store = TCPStore(host, port, is_master=(rank == 0), world_size=n,
                     timeout=timeout)
    tdist.init_process_group(
        "gloo", store=store.torch_store, rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=timeout))
    WORLD.active, WORLD.rank, WORLD.size = True, rank, n
    WORLD.device, WORLD.store = dev, store
    WORLD.group = Group(0, list(range(n)), [dev] * n, "world",
                        pg=tdist.group.WORLD)
    return ParallelEnv()


def init_parallel_env(devices=None, backend=None, timeout=300.0):
    """Make the world group (``parallel.py:978``). One process (the
    launch environment's PADDLE_TRAINERS_NUM / WORLD_SIZE of 1): one rank
    per CUDA card of this process by default; `devices` (a device or a
    list, which may repeat one device) sets the ranks' devices,
    ``devices=["cpu"] * 8`` being the tests' 8-rank world. Several
    processes: this process joins the gloo process group as rank
    PADDLE_TRAINER_ID (or RANK), met at the TCPStore on the master
    (`timeout` seconds for the rendezvous and each collective), with
    `devices` choosing this rank's device (see ``_process_device``).
    Idempotent."""
    if is_initialized():
        return ParallelEnv()
    n_procs, rank, _, _ = _env_world()
    if n_procs > 1:
        return _init_multi_process(n_procs, rank, devices, backend,
                                   timeout)
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
    """This process's rank (its rank in `group` when given) in a
    multi-process world; the single controller is rank 0 of every
    group."""
    if WORLD.active:
        return WORLD.rank if group is None else \
            group.get_group_rank(WORLD.rank)
    return 0


def get_world_size(group=None):
    if group is not None:
        return group.nranks
    if WORLD.active:
        return WORLD.size
    if _STATE.initialized:
        return len(_STATE.devices)
    return max(1, torch.cuda.device_count())


def _default_group():
    if WORLD.active:
        return WORLD.group
    if not _STATE.initialized:
        init_parallel_env()
    return _STATE.groups[0]


class Group:
    """A communicator: ranks and the device each runs on
    (``communication/group.py``'s Group); `pg`, the torch process group
    of a multi-process world's group (None in the single controller)."""

    def __init__(self, gid, ranks, devices, axis_name, pg=None):
        self.id = gid
        self.ranks = list(ranks)
        self.nranks = len(self.ranks)
        self.devices = [torch.device(d) for d in devices]
        self.axis_name = axis_name
        self.pg = pg

    @property
    def process_group(self):
        return self

    @property
    def world_size(self):
        return self.nranks

    @property
    def rank(self):
        return get_rank(self)

    def is_member(self):
        return not WORLD.active or WORLD.rank in self.ranks

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    def __repr__(self):
        return f"Group(id={self.id}, nranks={self.nranks})"


def new_group(ranks=None, backend=None, timeout=None):
    """A group over the world group's ranks `ranks`
    (``collective.py:194``). In a multi-process world every process must
    make the same groups in the same order (a torch subgroup over gloo);
    a process outside `ranks` gets a group it is no member of."""
    g0 = _default_group()
    if ranks is None:
        ranks = list(range(g0.nranks))
    ranks = [int(r) for r in ranks]
    if WORLD.active:
        import torch.distributed as tdist
        pg = tdist.new_group(ranks, backend="gloo")
        gid = _STATE.next_gid
        _STATE.next_gid += 1
        g = Group(gid, ranks, [WORLD.device] * len(ranks), "sub", pg=pg)
        _STATE.groups[gid] = g
        return g
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


# ---------------- the collectives across processes ----------------

# Gloo moves data through host memory. Some of its ops take a CUDA
# tensor and copy it through host buffers out of sight; handed one, others
# read the device pointer as host memory and abort the process (gloo's
# "writev ... Bad address" on torch 2.11; tools/gloo_probe.py lists
# which). So every op's CUDA tensors are copied through page-locked host
# buffers here, on one path, and those bytes are counted.
_PROC_STATS = {}        # op -> {"calls", "bytes", "seconds", "staged_bytes"}
_STAGED = {}


def proc_stats():
    """{op: {"calls", "bytes", "seconds", "staged_bytes"}} of this
    process's cross-process collectives: payload bytes as
    ``collective_bytes_total`` counts them, host seconds of the calls
    (each waits for its result), and the bytes copied between the card
    and the host for gloo."""
    return {op: dict(v) for op, v in _PROC_STATS.items()}


def reset_proc_stats():
    _PROC_STATS.clear()


def _stat(op):
    st = _PROC_STATS.get(op)
    if st is None:
        st = _PROC_STATS[op] = {"calls": 0, "bytes": 0, "seconds": 0.0,
                                "staged_bytes": 0}
    return st


def _note_staged(op, nbytes):
    _stat(op)["staged_bytes"] += int(nbytes)
    if not _OBS_ON[0]:
        return
    c = _STAGED.get(op)
    if c is None:
        c = _STAGED[op] = _REG.counter(
            "collective_staged_bytes_total",
            "bytes copied between the card and the host for gloo",
            labels={"op": op})
    c.inc(int(nbytes))


def _pinned(t):
    """An empty page-locked host tensor shaped as t (the caching host
    allocator reuses them; a pageable copy of the card runs ~25x
    slower)."""
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


class _Stage:
    """Host copies of the CUDA tensors of one gloo call: ``host(t)`` for a
    tensor the op reads (or reads and writes), ``out(t)`` for one it only
    writes; ``done()`` copies every written host tensor back into its CUDA
    tensor."""

    def __init__(self, op):
        self.op = op
        self.back = []

    @staticmethod
    def _needs(t):
        return t.device.type != "cpu"

    def host(self, t, written=False):
        if not self._needs(t):
            return t
        h = _pinned(t)
        h.copy_(t.detach())
        _note_staged(self.op, _nbytes(t))
        if written:
            self.back.append((t, h))
        return h

    def out(self, t):
        if not self._needs(t):
            return t
        h = _pinned(t)
        self.back.append((t, h))
        return h

    def done(self):
        with torch.no_grad():
            for t, h in self.back:
                t.copy_(h)
                _note_staged(self.op, _nbytes(t))
        self.back = []


_TORCH_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN", "prod": "PRODUCT",
              "avg": "SUM"}


def _torch_op(op):
    import torch.distributed as tdist
    return getattr(tdist.ReduceOp, _TORCH_OPS[_op_name(op)])


def _local(tensor, what):
    """A multi-process collective takes this process's own tensor."""
    if _is_list(tensor) or not torch.is_tensor(tensor):
        raise TypeError(f"{what} in a multi-process world takes this "
                        "process's tensor, not a list of per-rank "
                        "tensors")
    return tensor


def _proc(op, payload, fn):
    """Run fn() (a gloo call that returns when its result is in place),
    counted in ``proc_stats()`` with `payload` bytes. A call gloo refuses
    raises with the op's name."""
    st = _stat(op)
    t = time.perf_counter()
    try:
        out = fn()
    except (RuntimeError, ValueError) as e:
        raise RuntimeError(f"{op} across processes over gloo: {e}") from e
    st["seconds"] += time.perf_counter() - t
    st["calls"] += 1
    st["bytes"] += int(payload)
    return out


def _proc_all_reduce(tensor, op, group):
    import torch.distributed as tdist
    _local(tensor, "all_reduce")
    stage = _Stage("all_reduce")
    with torch.no_grad():
        h = stage.host(tensor, written=True)
        _proc("all_reduce", _nbytes(tensor),
              lambda: tdist.all_reduce(h, op=_torch_op(op),
                                       group=group.pg))
        if _op_name(op) == "avg":
            h.div_(group.nranks)
        stage.done()
    return tensor


def _proc_all_gather(tensor_list, tensor, group):
    import torch.distributed as tdist
    _local(tensor, "all_gather")
    stage = _Stage("all_gather")
    h = stage.host(tensor)
    outs = [torch.empty(h.shape, dtype=h.dtype, device=h.device)
            for _ in range(group.nranks)]
    _proc("all_gather", _nbytes(tensor),
          lambda: tdist.all_gather(outs, h.contiguous(), group=group.pg))
    if h is not tensor:
        outs = [o.to(tensor.device) for o in outs]
        _note_staged("all_gather", sum(_nbytes(o) for o in outs))
    if tensor_list is None:
        return outs
    tensor_list.clear()
    tensor_list.extend(outs)
    return tensor_list


def _proc_broadcast(tensor, src, group):
    import torch.distributed as tdist
    _local(tensor, "broadcast")
    stage = _Stage("broadcast")
    with torch.no_grad():
        h = stage.host(tensor, written=True)
        _proc("broadcast", _nbytes(tensor),
              lambda: tdist.broadcast(h, src=src, group=group.pg))
        stage.done()
    return tensor


def _proc_reduce(tensor, dst, op, group):
    import torch.distributed as tdist
    _local(tensor, "reduce")
    stage = _Stage("reduce")
    with torch.no_grad():
        h = stage.host(tensor, written=True)
        _proc("reduce", _nbytes(tensor),
              lambda: tdist.reduce(h, dst=dst, op=_torch_op(op),
                                   group=group.pg))
        if _op_name(op) == "avg" and get_rank() == dst:
            h.div_(group.nranks)
        stage.done()
    return tensor


def _proc_scatter(tensor, tensor_list, src, group):
    import torch.distributed as tdist
    _local(tensor, "scatter")
    stage = _Stage("scatter")
    with torch.no_grad():
        h = stage.out(tensor)
        ins = ([stage.host(t).contiguous() for t in tensor_list]
               if get_rank() == src else None)
        _proc("scatter", _nbytes(tensor),
              lambda: tdist.scatter(h, ins, src=src, group=group.pg))
        stage.done()
    return tensor


def _proc_reduce_scatter(tensor, tensor_list, op, group):
    """`tensor_list`: one tensor for each rank (this process's
    contributions), or one tensor of nranks equal pieces along dim 0."""
    import torch.distributed as tdist
    _local(tensor, "reduce_scatter")
    stage = _Stage("reduce_scatter")
    with torch.no_grad():
        h = stage.out(tensor)
        if torch.is_tensor(tensor_list):
            src = stage.host(tensor_list).contiguous()
            call = lambda: tdist.reduce_scatter_tensor(  # noqa: E731
                h, src, op=_torch_op(op), group=group.pg)
            payload = _nbytes(tensor_list)
        else:
            srcs = [stage.host(t).contiguous() for t in tensor_list]
            call = lambda: tdist.reduce_scatter(  # noqa: E731
                h, srcs, op=_torch_op(op), group=group.pg)
            payload = sum(_nbytes(t) for t in tensor_list)
        _proc("reduce_scatter", payload, call)
        if _op_name(op) == "avg":
            h.div_(group.nranks)
        stage.done()
    return tensor


def _proc_alltoall(out_tensor_list, in_tensor_list, group):
    """Gloo has no list all-to-all (torch 2.11: "Backend gloo does not
    support alltoall"): the inputs, one shape for every rank, travel as
    one flat ``all_to_all_single``."""
    shapes = {tuple(t.shape) for t in in_tensor_list}
    if len(shapes) != 1 or len(in_tensor_list) != group.nranks:
        raise ValueError(f"alltoall across processes: {group.nranks} "
                         f"tensors of one shape, got shapes {shapes}")
    flat = torch.cat([t.detach().reshape(-1) for t in in_tensor_list])
    out = torch.empty_like(flat)
    proc_alltoall_single(out, flat, group=group, op="alltoall")
    shape = in_tensor_list[0].shape
    out_tensor_list.clear()
    out_tensor_list.extend(p.view(shape) for p in out.chunk(group.nranks))
    return out_tensor_list


def proc_alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                         out_split_sizes=None, group=None,
                         op="alltoall_single"):
    """``alltoall_single`` across processes: dim-0 pieces of `in_tensor`
    go to each rank; `out_tensor` takes the pieces every rank sent this
    one, in rank order."""
    import torch.distributed as tdist
    group = group or _default_group()
    stage = _Stage(op)
    with torch.no_grad():
        h_out = stage.out(out_tensor)
        h_in = stage.host(in_tensor).contiguous()
        _proc(op, _nbytes(in_tensor),
              lambda: tdist.all_to_all_single(
                  h_out, h_in, out_split_sizes, in_split_sizes,
                  group=group.pg))
        stage.done()
    return out_tensor


def _proc_barrier(group):
    import torch.distributed as tdist
    if WORLD.device is not None and WORLD.device.type == "cuda":
        torch.cuda.synchronize(WORLD.device)
    _proc("barrier", 0, lambda: tdist.barrier(group=group.pg))


class _ProcTask:
    """A cross-process isend / irecv: ``wait()`` waits for the transfer
    (and copies a staged receive into its CUDA tensor)."""

    def __init__(self, work, stage=None, result=None):
        self._work, self._stage, self._result = work, stage, result

    def wait(self):
        if self._work is not None:
            self._work.wait()
            self._work = None
            if self._stage is not None:
                self._stage.done()
        return self._result

    def is_completed(self):
        return self._work is None or self._work.is_completed()


def _proc_p2p(kind, tensor, peer, group, tag, sync):
    import torch.distributed as tdist
    _local(tensor, kind)
    stage = _Stage(kind)
    h = (stage.host(tensor).contiguous() if kind == "send"
         else stage.out(tensor))
    fn = {"send": tdist.isend, "recv": tdist.irecv}[kind]
    work = _proc(kind, _nbytes(tensor),
                 lambda: fn(h, peer, group=group.pg, tag=tag))
    task = _ProcTask(work, stage if kind == "recv" else None,
                     tensor if kind == "recv" else None)
    if sync:
        st = _stat(kind)
        t = time.perf_counter()
        task.wait()
        st["seconds"] += time.perf_counter() - t
    return task


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
    if group.pg is not None:
        return _proc_all_reduce(tensor, op, group)
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
    if group.pg is not None:
        return _proc_all_gather(tensor_list, tensor, group)
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
    if group.pg is not None:
        return _proc_broadcast(tensor, src, group)
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
    """Across processes, the reduction lands in rank `dst`'s tensor;
    single-controller, as ``all_reduce`` (the JAX package's reduce)."""
    group = group or _default_group()
    if group.pg is not None:
        return _reduce_across(tensor, dst, op, group)
    return all_reduce(tensor, op, group, sync_op)


@_flight_recorded
def _reduce_across(tensor, dst, op, group):
    _count_collective("reduce", tensor)
    return _proc_reduce(tensor, dst, op, group)


@_flight_recorded
def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """This rank's (0's) element of `tensor_list` into `tensor`."""
    _count_collective("scatter", tensor_list or tensor)
    group = group or _default_group()
    if group.pg is not None:
        return _proc_scatter(tensor, tensor_list, src, group)
    if tensor_list:
        return _write(tensor, tensor_list[get_rank()])
    return tensor


@_flight_recorded
def reduce_scatter(tensor, tensor_list, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """`tensor_list`'s per-rank contributions reduced into `tensor`
    (across processes: this rank's piece of the contributions every
    process made, `tensor_list` a list or one tensor of nranks pieces
    along dim 0)."""
    _count_collective("reduce_scatter", tensor_list)
    group = group or _default_group()
    if group.pg is not None:
        return _proc_reduce_scatter(tensor, tensor_list, op, group)
    return _write(tensor, _reduce_local([t.detach() for t in tensor_list],
                                        op))


@_flight_recorded
def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """Single controller: the (src, dst) chunk matrix is its own
    transpose; `out_tensor_list` takes copies of the inputs."""
    _count_collective("alltoall", in_tensor_list)
    group = group or _default_group()
    if group.pg is not None:
        return _proc_alltoall(out_tensor_list, in_tensor_list, group)
    out_tensor_list.clear()
    out_tensor_list.extend(t.detach().clone() for t in in_tensor_list)
    return out_tensor_list


@_flight_recorded
def barrier(group=None):
    _count_collective("barrier")
    group = group or _default_group()
    if group.pg is not None:
        return _proc_barrier(group)
    for d in sorted({d for d in group.devices if d.type == "cuda"},
                    key=str):
        torch.cuda.synchronize(d)


# ---- send/recv: a single-controller mailbox keyed (group, dst, tag) ----

_P2P_MAILBOX = {}


@_flight_recorded
def send(tensor, dst=0, group=None, sync_op=True, tag=0):
    """Across processes: to global rank `dst` (with sync_op False the
    transfer's task is returned; ``isend``)."""
    _count_collective("send", tensor)
    group = group or _default_group()
    if group.pg is not None:
        task = _proc_p2p("send", tensor, dst, group, tag, sync_op)
        return None if sync_op else task
    _P2P_MAILBOX.setdefault((group.id, dst, tag), []).append(
        tensor.detach().clone())


@_flight_recorded
def recv(tensor, src=0, group=None, sync_op=True, tag=0):
    """Across processes: from global rank `src` into `tensor` (with
    sync_op False the transfer's task; ``irecv``)."""
    _count_collective("recv", tensor)
    group = group or _default_group()
    if group.pg is not None:
        task = _proc_p2p("recv", tensor, src, group, tag, sync_op)
        return tensor if sync_op else task
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
    task = send(tensor, dst, group, sync_op=False, tag=tag)
    return task if task is not None else _P2PTask()


def irecv(tensor, src=0, group=None, tag=0):
    out = recv(tensor, src, group, sync_op=False, tag=tag)
    return out if isinstance(out, _ProcTask) else _P2PTask(out)


def wait(tensor, group=None, use_calc_stream=True):
    from .watchdog import watched_wait
    if torch.is_tensor(tensor):
        watched_wait(tensor, what="distributed.wait")


def get_group(gid=0):
    if gid == 0 and WORLD.active:
        return WORLD.group
    return _STATE.groups.get(gid)


def destroy_process_group(group=None):
    """Forget `group`, or every group; with no group in a multi-process
    world, leave the torch process group and close the store."""
    if group is None:
        _STATE.groups.clear()
        _STATE.initialized = False
        _STATE.devices = None
        if WORLD.active:
            import torch.distributed as tdist
            tdist.destroy_process_group()
            WORLD.store.close()
            WORLD.__init__()
    else:
        _STATE.groups.pop(group.id, None)
