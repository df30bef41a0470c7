"""The port's semi-auto training objects (``distributed.to_static`` ->
``DistModel``, ``Strategy``, ``shard_optimizer`` inside it, the
``moe_*`` helpers) held to the JAX package's: the cases of
``test_distributed_semi_auto.py::test_dist_model_train_loop`` (:117) and
``auto_parallel/api.py``'s ``DistModel.state_dict`` and moe helpers.

The port's values are global (placements annotate them, as since PR 16):
a DistModel step is ``jit.compile_train_step``, and with a sharded
optimizer the ZeRO engine updates; ``state_dict("all")`` gathers the
owners' slices into the whole arrays of the JAX layout.

Tolerances: losses against JAX rtol 1e-5 (atol 1e-6); the sharded model
against the unsharded one bit-equal; moe pieces exactly equal.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt

import paddle_tpu_torch as ptt
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import nn, optimizer as O, weights


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice._CURRENT[0]
    ptt.set_device("cpu")
    yield
    tdevice._CURRENT[0] = prev


def _mesh2d():
    return dist.ProcessMesh(np.arange(8).reshape(4, 2), ["dp", "mp"],
                            devices="cpu")


def _jmesh2d():
    return jdist.ProcessMesh(np.arange(8).reshape(4, 2), ["dp", "mp"])


def _nets(seed=0):
    paddle.seed(seed)
    jnet = jnn.Sequential(jnn.Linear(16, 32), jnn.GELU(), jnn.Linear(32, 4))
    tnet = nn.Sequential(nn.Linear(16, 32, device="cpu"), nn.GELU(),
                         nn.Linear(32, 4, device="cpu"))
    weights.from_paddle_tpu_state(
        {k: np.array(p.numpy()) for k, p in jnet.named_parameters()}, tnet)
    return jnet, tnet


def _batch(seed=0):
    r = np.random.RandomState(seed)
    return r.rand(32, 16).astype("float32"), r.randint(0, 4, 32)


def test_dist_model_train_loop_matches_jax():
    """dp x mp placements, AdamW through dist.to_static: ten training
    losses and the eval loss equal the JAX DistModel's."""
    jnet, tnet = _nets()
    jm, tm = _jmesh2d(), _mesh2d()
    for net, d, m in ((jnet, jdist, jm), (tnet, dist, tm)):
        d.shard_tensor(net[0].weight, m, [d.Replicate(), d.Shard(1)])
        d.shard_tensor(net[2].weight, m, [d.Replicate(), d.Replicate()])
    X, Y = _batch()
    jmodel = jdist.to_static(jnet, loss=jnn.CrossEntropyLoss(),
                             optimizer=jopt.AdamW(5e-3,
                                                  parameters=jnet.parameters()))
    tmodel = dist.to_static(tnet, loss=torch.nn.CrossEntropyLoss(),
                            optimizer=O.AdamW(5e-3,
                                              parameters=tnet.parameters()))
    assert isinstance(tmodel, dist.DistModel)
    jmodel.train()
    tmodel.train()
    xb = dist.shard_tensor(torch.from_numpy(X), tm,
                           [dist.Shard(0), dist.Replicate()])
    yb = torch.from_numpy(Y)
    want = [jmodel(paddle.to_tensor(X), paddle.to_tensor(Y)).item()
            for _ in range(10)]
    got = [float(tmodel(xb, yb)) for _ in range(10)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert got[-1] < got[0]
    assert [repr(p) for p in tnet[0].weight._dist_attr.placements] == \
        ["Replicate()", "Shard(dim=1)"]
    jmodel.eval()
    tmodel.eval()
    np.testing.assert_allclose(
        float(tmodel(X, Y)), jmodel(paddle.to_tensor(X),
                                    paddle.to_tensor(Y)).item(), rtol=1e-5)
    tmodel.predict()
    np.testing.assert_array_equal(tmodel(X).numpy(),
                                  tnet(torch.from_numpy(X)).detach().numpy())
    with pytest.raises(NotImplementedError):
        tmodel.dist_main_program()


@pytest.mark.parametrize("stage", [2, 3])
def test_dist_model_sharded_state_dict_in_the_jax_layout(stage):
    """A DistModel whose optimizer is ZeRO-sharded over dp trains
    bit-equal to the unsharded one; state_dict("all") gathers the
    owners' slices (the unsharded optimizer's keys and values);
    set_state_dict restores both."""
    X, Y = _batch(1)
    runs = {}
    for sharded in (False, True):
        _, tnet = _nets(1)
        o = O.AdamW(5e-3, parameters=tnet.parameters(), multi_precision=True)
        if sharded:
            cls = dist.ShardingStage2 if stage == 2 else dist.ShardingStage3
            o = dist.shard_optimizer(o, cls("dp", _mesh2d()))
            assert o._zero.stage == stage
        model = dist.to_static(tnet, loss=torch.nn.CrossEntropyLoss(),
                               optimizer=o, strategy=dist.Strategy(
                                   {"gradient_merge": None}))
        losses = [float(model(X, Y)) for _ in range(3)]
        runs[sharded] = (losses, model.state_dict("all"), model)
    assert runs[True][0] == runs[False][0]
    want, got = runs[False][1], runs[True][1]
    assert list(want) == list(got)
    for k in want:
        if torch.is_tensor(want[k]):
            assert torch.equal(want[k], got[k]), k
    model = runs[True][2]
    params = model.state_dict("param")
    assert set(params) == {"0.weight", "0.bias", "2.weight", "2.bias"}
    # a reload of the saved state continues exactly where it was
    saved = {k: (v.clone() if torch.is_tensor(v) else v)
             for k, v in got.items()}
    l_next = float(model(X, Y))
    model.set_state_dict(saved)
    assert float(model(X, Y)) == l_next


def test_moe_helpers_match_jax():
    jm, tm = _jmesh2d(), _mesh2d()
    locals_ = [np.full((2, 3), i, "float32") for i in range(4)]
    jt = jdist.moe_global_mesh_tensor([paddle.to_tensor(a) for a in locals_],
                                      jm, [jdist.Shard(0), jdist.Replicate()])
    tt = dist.moe_global_mesh_tensor([torch.from_numpy(a) for a in locals_],
                                      tm, [dist.Shard(0), dist.Replicate()])
    np.testing.assert_array_equal(tt.numpy(), jt.numpy())
    assert [repr(p) for p in tt._dist_attr.placements] == \
        ["Shard(dim=0)", "Replicate()"]
    jp = jdist.moe_sub_mesh_tensors(jt, local_mesh_dim=0)
    tp = dist.moe_sub_mesh_tensors(tt, local_mesh_dim=0)
    assert len(tp) == len(jp) == 4
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    tp2 = dist.moe_sub_mesh_tensors(tt, tm)          # the last mesh dim
    assert [tuple(t.shape) for t in tp2] == [(4, 3), (4, 3)]


def test_shard_optimizer_with_a_callable_and_stage_specs():
    net = nn.Linear(16, 8, device="cpu")
    o = O.Adam(0.1, parameters=net.parameters())
    net(torch.ones(2, 16)).sum().backward()
    o.step()
    seen = []
    dist.shard_optimizer(o, lambda name, p, v: seen.append(name) or v)
    assert sorted(set(seen)) == ["beta1_pow", "beta2_pow", "moment1",
                                 "moment2"]
    st1 = dist.ShardingStage1("dp", _mesh2d())
    st2, st3 = dist.ShardingStage2("dp", _mesh2d()), \
        dist.ShardingStage3("dp", _mesh2d())
    w = torch.zeros(8, 4)
    assert st1.grad_sharding(w) is None and st1.param_sharding(w) is None
    assert tuple(st2.grad_sharding(w)) == ("dp",)
    assert st2.param_sharding(w) is None
    assert tuple(st3.param_sharding(w)) == ("dp",)
    assert st1._sharding(torch.zeros(6, 4)) is None     # 6 % 4
    assert st1("moment1", None, w) is w
