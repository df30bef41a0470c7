"""The port's semi-auto parallel API (``paddle_tpu_torch.distributed``:
``ProcessMesh``, the placements, ``shard_tensor``, ``reshard``,
``dtensor_to_local``, ``unshard_dtensor``, ``shard_layer``), held to the
JAX package's: the cases of ``test_distributed_semi_auto.py``'s
``test_process_mesh_basics``, ``test_shard_tensor_layouts``,
``test_reshard_pairs``, ``test_sharded_compute_propagates``,
``test_sharded_grads``, ``test_unshard_and_local`` and
``test_shard_layer_replicates_params``, on the same numpy inputs.

The JAX mesh is its 8 virtual CPU devices; the port's puts all 8
positions on the CPU (``devices="cpu"``). A port dist tensor holds the
global values (as a GSPMD array does); its pieces come from
``local_shards``, the JAX array's from ``addressable_shards``.

Tolerance: layouts, shapes and moved values exact; products within 1e-5.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn as jnn
from paddle_tpu.distributed.auto_parallel import placement as jplace

import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed.auto_parallel import placement as tplace
from paddle_tpu_torch.nn import Linear


def _meshes():
    ids = np.arange(8).reshape(4, 2)
    return (jdist.ProcessMesh(ids, ["dp", "mp"]),
            dist.ProcessMesh(ids, ["dp", "mp"], devices="cpu"))


def _jshapes(t):
    return sorted(tuple(s.data.shape) for s in t._value.addressable_shards)


def _tshapes(t):
    return sorted(tuple(s.shape) for s in dist.local_shards(t))


def _jpieces(t):
    """The JAX array's pieces in device order (= mesh position order)."""
    shards = sorted(t._value.addressable_shards, key=lambda s: s.device.id)
    return [np.asarray(s.data) for s in shards]


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        "float32")


def test_process_mesh_basics():
    jm, tm = _meshes()
    assert tm.shape == jm.shape == [4, 2]
    assert tm.get_dim_size("mp") == jm.get_dim_size("mp") == 2
    assert tm.process_ids == jm.process_ids == list(range(8))
    assert tm.dim_names == jm.dim_names
    dm = tm.get_device_mesh()
    assert dict(dm.shape) == dict(jm.get_jax_mesh().shape) == \
        {"dp": 4, "mp": 2}
    assert dm.flat == [torch.device("cpu")] * 8 and dm.co_located
    sub_j, sub_t = jm[1], tm[1]
    assert sub_t.shape == sub_j.shape and sub_t.dim_names == sub_j.dim_names
    assert tm == dist.ProcessMesh(np.arange(8).reshape(4, 2), ["dp", "mp"])
    dist.set_mesh(tm)
    assert dist.get_mesh() is tm
    dist.set_mesh(None)


@pytest.mark.parametrize("placements", [
    ("S0", "R"), ("R", "R"), ("S0", "S1"), ("R", "S1"), ("S1", "S0"),
    ("S0", "S0"),
])
def test_shard_tensor_layouts(placements):
    """Piece shapes and values per position equal the JAX array's."""
    jm, tm = _meshes()

    def make(mod):
        return [mod.Shard(int(p[1])) if p[0] == "S" else mod.Replicate()
                for p in placements]

    x = _x((8, 4))
    js = jdist.shard_tensor(paddle.to_tensor(x), jm, make(jdist))
    ts = dist.shard_tensor(torch.from_numpy(x), tm, make(dist))
    assert _tshapes(ts) == _jshapes(js)
    for a, b in zip(dist.local_shards(ts), _jpieces(js)):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(ts.detach().numpy(), js.numpy())
    assert ts._dist_attr.process_mesh is tm
    assert tuple(tplace.placements_to_spec(tm, make(dist), 2)) == \
        tuple(jplace.placements_to_spec(jm, make(jdist), 2))


def test_shard_tensor_refuses_partial():
    jm, tm = _meshes()
    x = _x((8, 4))
    with pytest.raises(ValueError):
        jdist.shard_tensor(paddle.to_tensor(x), jm,
                           [jdist.Partial(), jdist.Replicate()])
    with pytest.raises(ValueError):
        dist.shard_tensor(torch.from_numpy(x), tm,
                          [dist.Partial(), dist.Replicate()])


def test_spec_round_trip():
    jm, tm = _meshes()
    for spec in [(), ("dp",), (None, "mp"), (("dp", "mp"),)]:
        jp = jplace.spec_to_placements(jm, jplace.PartitionSpec(*spec), 2)
        tp = tplace.spec_to_placements(tm, tplace.PartitionSpec(*spec), 2)
        assert [repr(p) for p in tp] == [repr(p) for p in jp]
        assert tuple(tplace.placements_to_spec(tm, tp, 2)) == \
            tuple(jplace.placements_to_spec(jm, jp, 2))


def test_reshard_pairs():
    """r -> s, s -> r, s -> s (a dim swap), and a Partial target refused,
    as the JAX package moves them."""
    jm, tm = _meshes()
    x = _x((8, 8), 1)
    jr = jdist.shard_tensor(paddle.to_tensor(x), jm,
                            [jdist.Replicate(), jdist.Replicate()])
    tr = dist.shard_tensor(torch.from_numpy(x), tm,
                           [dist.Replicate(), dist.Replicate()])
    steps = [[("S", 0), ("R",)], [("R",), ("R",)], [("S", 1), ("R",)]]
    jcur, tcur = jr, tr
    for i, step in enumerate(steps):
        def make(mod):
            return [mod.Shard(p[1]) if p[0] == "S" else mod.Replicate()
                    for p in step]
        src_j, src_t = (jcur, tcur) if i != 2 else (js0, ts0)
        jcur = jdist.reshard(src_j, jm, make(jdist))
        tcur = dist.reshard(src_t, tm, make(dist))
        if i == 0:
            js0, ts0 = jcur, tcur
        np.testing.assert_array_equal(tcur.detach().numpy(), x)
        np.testing.assert_array_equal(jcur.numpy(), x)
        assert _tshapes(tcur) == _jshapes(jcur)
    assert _tshapes(tcur) == [(8, 2)] * 8
    with pytest.raises(ValueError):
        jdist.reshard(jcur, jm, [jdist.Partial(), jdist.Replicate()])
    with pytest.raises(ValueError):
        dist.reshard(tcur, tm, [dist.Partial(), dist.Replicate()])


def test_reshard_keeps_the_graph():
    _, tm = _meshes()
    w = torch.from_numpy(_x((4, 4), 2)).requires_grad_(True)
    r = dist.reshard(w, tm, [dist.Shard(0), dist.Replicate()])
    (r * 3).sum().backward()
    np.testing.assert_array_equal(w.grad.numpy(), np.full((4, 4), 3.0))


def test_sharded_compute_propagates():
    jm, tm = _meshes()
    a, b = _x((8, 16), 3), _x((16, 8), 4)
    ja = jdist.shard_tensor(paddle.to_tensor(a), jm,
                            [jdist.Shard(0), jdist.Replicate()])
    jb = jdist.shard_tensor(paddle.to_tensor(b), jm,
                            [jdist.Replicate(), jdist.Shard(1)])
    ta = dist.shard_tensor(torch.from_numpy(a), tm,
                           [dist.Shard(0), dist.Replicate()])
    tb = dist.shard_tensor(torch.from_numpy(b), tm,
                           [dist.Replicate(), dist.Shard(1)])
    jo = paddle.matmul(ja, jb).numpy()
    to = torch.matmul(ta, tb).numpy()
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to, a @ b, rtol=1e-5, atol=1e-5)


def test_sharded_grads():
    jm, tm = _meshes()
    w = np.random.default_rng(5).random((16, 8)).astype("float32")
    x = _x((4, 16), 6)
    jw = paddle.to_tensor(w, stop_gradient=False)
    jwsd = jdist.shard_tensor(jw, jm, [jdist.Replicate(), jdist.Shard(1)])
    jwsd.stop_gradient = False
    paddle.matmul(paddle.to_tensor(x), jwsd).sum().backward()
    tw = torch.from_numpy(w).requires_grad_(True)
    twsd = dist.shard_tensor(tw, tm, [dist.Replicate(), dist.Shard(1)])
    assert twsd.requires_grad and twsd.is_leaf
    torch.matmul(torch.from_numpy(x), twsd).sum().backward()
    np.testing.assert_allclose(twsd.grad.numpy(), jwsd.grad.numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(
        twsd.grad.numpy(), np.tile(x.sum(0)[:, None], (1, 8)), rtol=1e-4)


def test_unshard_and_local():
    jm, tm = _meshes()
    x = _x((8, 4), 7)
    js = jdist.shard_tensor(paddle.to_tensor(x), jm,
                            [jdist.Shard(0), jdist.Replicate()])
    ts = dist.shard_tensor(torch.from_numpy(x), tm,
                           [dist.Shard(0), dist.Replicate()])
    jl, tl = jdist.dtensor_to_local(js), dist.dtensor_to_local(ts)
    assert list(tl.shape) == jl.shape == [2, 4]
    np.testing.assert_array_equal(tl.numpy(), jl.numpy())
    jf, tf = jdist.unshard_dtensor(js), dist.unshard_dtensor(ts)
    np.testing.assert_array_equal(tf.numpy(), jf.numpy())
    assert getattr(tf, "_dist_attr", None) is None
    plain = torch.ones(3)
    assert dist.unshard_dtensor(plain) is plain
    assert dist.dtensor_to_local(plain) is plain


def test_shard_layer_replicates_params():
    jm, tm = _meshes()
    jnet = jnn.Linear(4, 4)
    jdist.shard_layer(jnet, jm)
    tnet = Linear(4, 4, device="cpu")
    seen = []
    dist.shard_layer(tnet, tm, input_fn=lambda inp, m: seen.append(m))
    for name in ("weight", "bias"):
        jp, tp_ = getattr(jnet, name), getattr(tnet, name)
        assert jp._dist_attr is not None and tp_._dist_attr is not None
        assert tp_._dist_attr.process_mesh is tm
        assert [repr(p) for p in tp_._dist_attr.placements] == \
            [repr(p) for p in jp._dist_attr.placements]
    tnet(torch.ones(2, 4))
    assert seen == [tm]


def test_dtensor_from_fn_and_later_slices():
    _, tm = _meshes()
    t = dist.dtensor_from_fn(torch.ones, tm,
                             [dist.Shard(0), dist.Replicate()], 8, 2)
    assert _tshapes(t) == [(2, 2)] * 8
    # the later slice's names work now (held to JAX in
    # test_torch_dist_model.py and test_torch_sharding_stages.py)
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.optimizer import Adam
    net = Linear(8, 2, device="cpu")
    opt = dist.shard_optimizer(Adam(0.1, parameters=net.parameters()),
                               dist.ShardingStage1("dp", tm))
    assert opt._zero.stage == 1 and len(opt._zero.shards) == 1
    assert isinstance(dist.to_static(net, loss=torch.nn.MSELoss(),
                                     optimizer=opt), dist.DistModel)
    pieces = dist.moe_sub_mesh_tensors(
        dist.moe_global_mesh_tensor([torch.ones(2, 2)] * 4, tm,
                                    [dist.Shard(0), dist.Replicate()]),
        local_mesh_dim=0)
    assert [tuple(q.shape) for q in pieces] == [(2, 2)] * 4
    for cls in (dist.ShardingStage1, dist.ShardingStage2,
                dist.ShardingStage3):
        assert cls("dp", tm).stage in (1, 2, 3)
    assert dist.Strategy({"amp": None}).amp is None
