"""The port's collectives (``paddle_tpu_torch.distributed``), held to the
JAX package's on the same inputs.

The JAX side runs on its 8 virtual CPU devices (tests/conftest.py); the
port's world is 8 ranks that all run on the CPU (``init_parallel_env(
devices=["cpu"] * 8)``). Both packages take each rank's value stacked on a
leading axis of 8, made from one numpy seed. Covered: the cases of
``test_distributed_semi_auto.py``'s ``test_collectives_eager``,
``test_new_group`` and ``test_stream_collectives_namespace``; every
reduce op in float32 and int32; the replicated (no leading axis) case;
``reduce``, ``scatter``, ``reduce_scatter``, ``alltoall``, ``send`` /
``recv`` / ``isend`` / ``irecv``, ``barrier``, ``gather``,
``alltoall_single`` and the object collectives; the per-rank list layout;
the counters and the flight recorder; the refusals.

Tolerance: integers exact; float32 within 1e-6 relative (the product's
JAX form is exp(sum(log)): 1e-5).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed.communication import stream as jstream

import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed import parallel_base as PB
from paddle_tpu_torch.distributed.communication import stream
from paddle_tpu_torch.observability import flight_recorder as fr
from paddle_tpu_torch.observability.metrics import REGISTRY

N = 8


@pytest.fixture(autouse=True)
def world():
    """An 8-rank port world on the CPU and the JAX world, fresh each
    test."""
    dist.destroy_process_group()
    dist.init_parallel_env(devices=["cpu"] * N)
    jdist.init_parallel_env()
    assert jdist.get_world_size() == N
    yield
    dist.destroy_process_group()


def _both(arr):
    return paddle.to_tensor(arr.copy()), torch.from_numpy(arr.copy())


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_collectives_eager():
    """``test_collectives_eager``: stacked all_reduce, all_gather,
    broadcast."""
    assert dist.get_world_size() == N
    j, t = _both(np.arange(N * 3, dtype="float32").reshape(N, 3))
    jdist.all_reduce(j)
    dist.all_reduce(t)
    np.testing.assert_array_equal(t.numpy(), j.numpy())
    for r in range(N):
        np.testing.assert_array_equal(t.numpy()[r],
                                      np.arange(N * 3).reshape(N, 3).sum(0))

    arr = np.arange(N * 2, dtype="float32").reshape(N, 2)
    jg, tg = [], []
    jdist.all_gather(jg, paddle.to_tensor(arr))
    dist.all_gather(tg, torch.from_numpy(arr))
    assert len(tg) == len(jg) == N
    for a, b in zip(tg, jg):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(tg[1].numpy(), [2, 3])

    j, t = _both(arr)
    jdist.broadcast(j, src=1)
    dist.broadcast(t, src=1)
    np.testing.assert_array_equal(t.numpy(), j.numpy())
    for r in range(N):
        np.testing.assert_array_equal(t.numpy()[r], [2, 3])


@pytest.mark.parametrize("op", ["sum", "max", "min", "avg", "prod"])
def test_all_reduce_ops_float32(op):
    x = _rng(1).uniform(0.5, 1.5, (N, 4, 5)).astype("float32")
    j, t = _both(x)
    jdist.all_reduce(j, op=getattr(jdist.ReduceOp, op.upper()))
    dist.all_reduce(t, op=getattr(dist.ReduceOp, op.upper()))
    rtol = 1e-5 if op == "prod" else 1e-6
    np.testing.assert_allclose(t.numpy(), j.numpy(), rtol=rtol)


@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_all_reduce_ops_int32_exact(op):
    x = _rng(2).integers(-1000, 1000, (N, 6)).astype("int32")
    j, t = _both(x)
    jdist.all_reduce(j, op=getattr(jdist.ReduceOp, op.upper()))
    dist.all_reduce(t, op=getattr(dist.ReduceOp, op.upper()))
    np.testing.assert_array_equal(t.numpy(), j.numpy())


@pytest.mark.parametrize("op", ["sum", "avg", "max"])
def test_replicated_layout(op):
    """Without the leading rank axis a value is replicated: SUM gives
    n * x, the others x (``parallel_base.py:300-310``)."""
    x = _rng(3).standard_normal((3, 5)).astype("float32")
    j, t = _both(x)
    jdist.all_reduce(j, op=getattr(jdist.ReduceOp, op.upper()))
    dist.all_reduce(t, op=getattr(dist.ReduceOp, op.upper()))
    np.testing.assert_allclose(t.numpy(), j.numpy(), rtol=1e-6)


def test_new_group():
    jg = jdist.new_group([0, 1, 2, 3])
    g = dist.new_group([0, 1, 2, 3])
    assert g.nranks == jg.nranks == 4
    assert g.get_group_rank(2) == jg.get_group_rank(2) == 2
    assert g.get_group_rank(7) == jg.get_group_rank(7) == -1
    # a 4-rank group reduces a 4-stacked tensor
    j, t = _both(np.arange(12, dtype="float32").reshape(4, 3))
    jdist.all_reduce(j, group=jg)
    dist.all_reduce(t, group=g)
    np.testing.assert_array_equal(t.numpy(), j.numpy())


def test_stream_collectives_namespace():
    j, t = _both(np.ones((N, 2), "float32"))
    jstream.all_reduce(j)
    stream.all_reduce(t)
    np.testing.assert_array_equal(t.numpy(), j.numpy())
    np.testing.assert_array_equal(t.numpy()[0], [N, N])
    arr = np.arange(N * 2, dtype="float32").reshape(N, 2)
    jb, tb = _both(arr)
    jstream.broadcast(jb, src=3)
    stream.broadcast(tb, src=3)
    np.testing.assert_array_equal(tb.numpy(), jb.numpy())
    jl, tl = [], []
    jstream.all_gather(jl, paddle.to_tensor(arr))
    stream.all_gather(tl, torch.from_numpy(arr))
    assert [a.numpy().tolist() for a in tl] == \
        [b.numpy().tolist() for b in jl]


def test_reduce_scatter_alltoall_scatter():
    x = _rng(4).standard_normal((N, 3)).astype("float32")
    j, t = _both(x)
    jdist.reduce(j, dst=0)
    dist.reduce(t, dst=0)
    np.testing.assert_allclose(t.numpy(), j.numpy(), rtol=1e-6)

    parts = [_rng(5 + i).standard_normal(4).astype("float32")
             for i in range(N)]
    jo, to = _both(np.zeros(4, "float32"))
    jdist.reduce_scatter(jo, [paddle.to_tensor(p) for p in parts])
    dist.reduce_scatter(to, [torch.from_numpy(p) for p in parts])
    np.testing.assert_allclose(to.numpy(), jo.numpy(), rtol=1e-6)

    js, ts = _both(np.zeros(4, "float32"))
    jdist.scatter(js, [paddle.to_tensor(p) for p in parts])
    dist.scatter(ts, [torch.from_numpy(p) for p in parts])
    np.testing.assert_array_equal(ts.numpy(), js.numpy())

    jout, tout = [], []
    jdist.alltoall(jout, [paddle.to_tensor(p) for p in parts])
    dist.alltoall(tout, [torch.from_numpy(p) for p in parts])
    assert len(tout) == len(jout) == N
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_send_recv_pairs_and_barrier():
    x = _rng(6).standard_normal(5).astype("float32")
    jx, tx = _both(x)
    jdist.send(jx, dst=0, tag=3)
    dist.send(tx, dst=0, tag=3)
    jr, tr = _both(np.zeros(5, "float32"))
    jdist.recv(jr, src=1, tag=3)
    dist.recv(tr, src=1, tag=3)
    np.testing.assert_array_equal(tr.numpy(), jr.numpy())
    np.testing.assert_array_equal(tr.numpy(), x)
    with pytest.raises(RuntimeError):
        dist.recv(torch.zeros(5), src=1, tag=3)     # nothing in flight
    task = dist.isend(torch.from_numpy(x), dst=0, tag=4)
    assert task.is_completed()
    got = torch.zeros(5)
    dist.irecv(got, src=1, tag=4).wait()
    np.testing.assert_array_equal(got.numpy(), x)
    dist.barrier()
    jdist.barrier()


def test_gather_and_alltoall_single():
    arr = _rng(7).standard_normal((N, 3)).astype("float32")
    jl = jdist.gather(paddle.to_tensor(arr), [])
    tl = dist.gather(torch.from_numpy(arr), [])
    assert len(tl) == len(jl) == N
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    jo, to = _both(np.zeros((N, 3), "float32"))
    jdist.alltoall_single(jo, paddle.to_tensor(arr))
    dist.alltoall_single(to, torch.from_numpy(arr))
    np.testing.assert_array_equal(to.numpy(), jo.numpy())


def test_object_collectives():
    obj = {"a": [1, 2, 3], "b": "text"}
    jl, tl = [], []
    jdist.all_gather_object(jl, obj)
    dist.all_gather_object(tl, obj)
    assert tl == jl and len(tl) == N
    jb, tb = [obj, 7], [obj, 7]
    jdist.broadcast_object_list(jb, src=0)
    dist.broadcast_object_list(tb, src=0)
    assert tb == jb == [obj, 7]
    js, ts = [], []
    jdist.scatter_object_list(js, ["x", "y"], src=0)
    dist.scatter_object_list(ts, ["x", "y"], src=0)
    assert ts == js


def test_per_rank_list_layout():
    """A list of per-rank tensors (the mesh engine's layout) reduces to
    the stacked result, every element updated in place."""
    x = _rng(8).standard_normal((N, 2, 3)).astype("float32")
    parts = [torch.from_numpy(x[i].copy()) for i in range(N)]
    dist.all_reduce(parts)
    j = paddle.to_tensor(x)
    jdist.all_reduce(j)
    for p in parts:
        np.testing.assert_allclose(p.numpy(), j.numpy()[0], rtol=1e-6)
    parts = [torch.from_numpy(x[i].copy()) for i in range(N)]
    dist.all_reduce(parts, op=dist.ReduceOp.MAX)
    np.testing.assert_array_equal(parts[3].numpy(), x.max(0))
    full = PB.gather_parts([torch.from_numpy(x[i]) for i in range(N)], -1)
    np.testing.assert_array_equal(full[0].numpy(),
                                  np.concatenate(list(x), -1))


def test_program_collectives_record_not_count():
    """A step program's collectives land in a record_collectives scope
    (op, per-rank payload, group size) and count nothing in the API
    counters."""
    c = REGISTRY.counter("collective_calls_total", labels={"op": "all_reduce"})
    before = c.value
    parts = [torch.ones(4, 8) for _ in range(2)]
    with PB.record_collectives() as found:
        PB.program_all_reduce(parts)
        PB.program_all_gather([torch.ones(4, 2), torch.ones(4, 2)], -1)
    assert found == {"all-reduce": {"count": 1, "bytes": 128,
                                    "max_group": 2},
                     "all-gather": {"count": 1, "bytes": 64,
                                    "max_group": 2}}
    assert c.value == before
    np.testing.assert_array_equal(parts[1].numpy(), np.full((4, 8), 2.0))


def test_counters_and_flight_recorder():
    calls = REGISTRY.counter("collective_calls_total",
                             labels={"op": "all_reduce"})
    nbytes = REGISTRY.counter("collective_bytes_total",
                              labels={"op": "all_reduce"})
    c0, b0 = calls.value, nbytes.value
    rec = fr.enable_flight_recorder(rank=0, world=1)
    try:
        dist.all_reduce(torch.ones(N, 4))
        entries = [e for e in rec.entries() if e["op"] == "all_reduce"]
    finally:
        fr.disable_flight_recorder()
    assert calls.value == c0 + 1
    assert nbytes.value == b0 + N * 4 * 4
    assert entries and entries[-1]["bytes"] == N * 16 \
        and entries[-1]["end_us"] is not None


def test_refusals():
    """A layout no route serves raises; a multi-process world without a
    master to meet at raises (the launch CLI sets one); the
    multi-process names exist (tests/test_torch_launch.py and
    tests/test_torch_multiprocess.py drive them)."""
    with pytest.raises(RuntimeError):
        PB._route([torch.device("cpu"), torch.device("cuda", 0)], "x")
    with pytest.raises(RuntimeError):
        PB._route([torch.device("cuda", 0), torch.device("cuda", 0),
                   torch.device("cuda", 1)], "x")
    g = PB.group_of([torch.device("cuda", 0)] * N)
    with pytest.raises(RuntimeError):
        dist.all_reduce(torch.ones(N, 2), group=g)   # ranks not on the CPU
    dist.destroy_process_group()
    import os
    saved = {k: os.environ.pop(k, None) for k in (
        "WORLD_SIZE", "PADDLE_TRAINERS_NUM", "PADDLE_MASTER",
        "MASTER_ADDR")}
    os.environ["WORLD_SIZE"] = "2"
    try:
        with pytest.raises(RuntimeError, match="master"):
            dist.init_parallel_env(devices="cpu")
    finally:
        del os.environ["WORLD_SIZE"]
        for k, v in saved.items():
            if v is not None:
                os.environ[k] = v
    assert not dist.is_initialized()
    called = []
    dist.spawn(called.append, args=(1,))
    assert called == [1]
    assert callable(dist.launch.launch) and callable(dist.gloo_barrier)
    store = dist.TCPStore(is_master=True)
    store.set("k", "v")
    assert store.get("k") == b"v"
    store.close()
    # DataParallel is ported (held in test_torch_pipeline.py): over the
    # default world it runs a layer rank by rank
    dp = dist.DataParallel(torch.nn.Linear(2, 2),
                           group=PB.group_of(["cpu"] * 2))
    assert dp.nranks == 2 and tuple(dp(torch.ones(4, 2)).shape) == (4, 2)
