"""ZeRO stages 1/2/3 in the port (``distributed._zero``, reached through
``shard_optimizer`` with ``ShardingStage1-3``, ``fleet.
DygraphShardingOptimizer`` and ``HybridParallelGradScaler``), held to the
JAX package's: the cases of ``test_sharding_stages.py`` and
``test_fleet_hybrid.py::test_sharding_optimizer_shards_states``.

The JAX model's parameters go into the port's by name
(``weights.from_paddle_tpu_state``); the same numpy batch feeds both.
The port's ownership is real: each of the 8 dp ranks (on the CPU here)
holds its dim-0 slice of every master and moment, so the checks read
those slices' shapes where the JAX tests read addressable shards.

Tolerances: losses against JAX rtol 1e-5 (atol 1e-6); the sharded
updates, states and losses against the unsharded optimizer's on the same
gradients bit-equal (the update is elementwise).
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu import jit as jjit

import paddle_tpu_torch as ptt
import paddle_tpu_torch.distributed as dist
import paddle_tpu_torch.distributed.fleet as fleet
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import nn, optimizer as O, weights
from paddle_tpu_torch.distributed.fleet.base import topology
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    LayerDesc, PipelineLayer)
from paddle_tpu_torch.jit import compile_train_step
from paddle_tpu_torch.observability.metrics import REGISTRY

DP = 8
STAGES = {1: dist.ShardingStage1, 2: dist.ShardingStage2,
          3: dist.ShardingStage3}


@pytest.fixture(autouse=True)
def _cpu():
    prev, prev_hcg = tdevice._CURRENT[0], topology._HCG[0]
    ptt.set_device("cpu")
    yield
    tdevice._CURRENT[0] = prev
    topology._HCG[0] = prev_hcg


def _count(op):
    return REGISTRY.counter("collective_calls_total",
                            labels={"op": op}).value


def _mesh():
    return dist.ProcessMesh(np.arange(DP), ["dp"], devices="cpu")


_JAX = {}


def _jax_losses(stage, steps=3):
    """``test_sharding_stages._run``'s losses, and the initial weights."""
    if stage not in _JAX:
        paddle.seed(7)
        np.random.seed(7)
        net = jnn.Sequential(jnn.Linear(16, 32), jnn.Tanh(),
                             jnn.Linear(32, 8))
        init = {n: np.array(p.numpy()) for n, p in net.named_parameters()}
        o = jopt.Adam(learning_rate=0.05, parameters=net.parameters())
        if stage:
            o = jdist.shard_optimizer(o, {
                1: jdist.ShardingStage1, 2: jdist.ShardingStage2,
                3: jdist.ShardingStage3}[stage](
                    "dp", jdist.ProcessMesh(np.arange(DP), ["dp"])))
        lossfn = jnn.CrossEntropyLoss()
        step = jjit.compile_train_step(net, lambda m, a, b: lossfn(m(a), b),
                                       o)
        X = np.random.rand(32, 16).astype("float32")
        Y = np.random.randint(0, 8, 32).astype("int64")
        losses = [step(paddle.to_tensor(X), paddle.to_tensor(Y)).item()
                  for _ in range(steps)]
        _JAX[stage] = (losses, init, X, Y)
    return _JAX[stage]


def _run(stage, steps=3):
    want, init, X, Y = _jax_losses(stage, steps)
    net = nn.Sequential(nn.Linear(16, 32, device="cpu"), nn.Tanh(),
                        nn.Linear(32, 8, device="cpu"))
    weights.from_paddle_tpu_state(init, net)
    o = O.Adam(learning_rate=0.05, parameters=net.parameters())
    if stage:
        o = dist.shard_optimizer(o, STAGES[stage]("dp", _mesh()))
    ce = torch.nn.CrossEntropyLoss()
    step = compile_train_step(net, lambda m, a, b: ce(m(a), b), o)
    counts = []
    losses = []
    for _ in range(steps):
        c0 = {op: _count(op) for op in ("scatter", "all_gather")}
        losses.append(float(step(torch.from_numpy(X), torch.from_numpy(Y))))
        counts.append({op: _count(op) - c0[op] for op in c0})
    return net, o, losses, want, counts


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_stage_loss_parity(stage):
    _, _, got, want, _ = _run(stage)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    _, _, base, _, _ = _run(0)
    assert got == base          # bit-equal to the unsharded run


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_state_actually_sharded(stage):
    net, o, _, _, counts = _run(stage)
    checked = 0
    for p in net.parameters():
        sh = o._zero.shards.get(id(p))
        assert sh is not None          # every dim 0 here divides by 8
        for st in sh.states:
            for v, n in zip(st, o._acc_names()):
                if v.dim():
                    want = (sh.shape[0] // DP,) + sh.shape[1:]
                    assert tuple(v.shape) == want, (n, v.shape)
                    checked += 1
    assert checked == 4 * 2 * DP      # 4 params x 2 moments x 8 ranks
    b = o._zero.state_bytes()
    assert len(set(b["per_rank"])) == 1 and b["replicated"] == 0
    # the gradient placement of the JAX rule (stage >= 2: dim 0 over dp)
    jst = {1: jdist.ShardingStage1, 2: jdist.ShardingStage2,
           3: jdist.ShardingStage3}[stage](
               "dp", jdist.ProcessMesh(np.arange(DP), ["dp"]))
    tst = STAGES[stage]("dp", _mesh())
    for p in net.parameters():
        want = jst.grad_sharding(jax.numpy.zeros(tuple(
            o._zero.shards[id(p)].shape)))
        got = tst.grad_sharding(torch.zeros(o._zero.shards[id(p)].shape))
        assert (want is None) == (got is None)
        if got is not None:      # JAX's spec carries trailing Nones
            jspec = list(want.spec)
            while jspec and jspec[-1] is None:
                jspec.pop()
            assert tuple(got) == tuple(jspec)
    # the collectives of each step: stage 1 gathers, 2 and 3 scatter the
    # gradients too; stage 3 gathers on use (before the forward)
    n = 4
    want = {1: {"scatter": 0, "all_gather": n},
            2: {"scatter": n, "all_gather": n},
            3: {"scatter": n, "all_gather": n}}[stage]
    assert counts[1:] == [want, want]


def test_stage3_params_sharded_stage1_not():
    net1, o1, _, _, _ = _run(1)
    net3, o3, _, _, _ = _run(3)
    for p in net1.parameters():
        assert p.numel() > 0 and o1._zero.shards[id(p)].params is None
    for p in net3.parameters():
        # ZeRO-3: between steps the parameter is its owners' slices
        sh = o3._zero.shards[id(p)]
        assert p.numel() == 0 and sh.released
        assert [tuple(t.shape) for t in sh.params] == \
            [(sh.shape[0] // DP,) + sh.shape[1:]] * DP
    x = torch.randn(4, 16)
    out3 = net3(x)                     # gathered on use
    assert all(p.numel() > 0 for p in net3.parameters())
    np.testing.assert_array_equal(out3.detach().numpy(),
                                  net1(x).detach().numpy())


def _twins(make_opt, stage, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    shapes = [(16, 8), (8,), (24, 4), (3, 5)]     # (3, 5) stays whole
    ps = [[torch.nn.Parameter(torch.randn(s, generator=g).to(dtype))
           for s in shapes]]
    ps.append([torch.nn.Parameter(p.detach().clone()) for p in ps[0]])
    for i, p in enumerate(ps[0]):
        p.param_name = ps[1][i].param_name = f"w{i}"
    plain = make_opt(ps[0])
    sharded = dist.shard_optimizer(make_opt(ps[1]),
                                   STAGES[stage]("dp", _mesh()))
    return ps, plain, sharded, g


OPTS = {
    "adam_bf16_master": (torch.bfloat16, lambda ps: O.Adam(
        0.01, parameters=ps, multi_precision=True)),
    "adamw_decay_ratio": (torch.float32, lambda ps: O.AdamW(
        0.01, parameters=ps, weight_decay=0.1,
        lr_ratio=lambda p: 0.5 if p.param_name == "w0" else 1.0,
        apply_decay_param_fun=lambda n: n != "w1")),
    "sgd_l2": (torch.float32, lambda ps: O.SGD(0.1, parameters=ps,
                                               weight_decay=0.01)),
    "momentum_clip": (torch.float32, lambda ps: O.Momentum(
        0.1, 0.9, parameters=ps,
        grad_clip=O.ClipGradByGlobalNorm(0.5))),
}


@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(OPTS))
def test_updates_bit_equal_unsharded(name, stage):
    """Given the same gradients, the owners' sliced updates give the
    unsharded optimizer's parameters, masters and moments bit for bit
    (the global-norm clip too: it runs on the whole gradients)."""
    dtype, make = OPTS[name]
    (pa, pb), plain, sharded, g = _twins(make, stage, dtype)
    for _ in range(3):
        sharded._zero.gather_params()
        for a, b in zip(pa, pb):
            grad = torch.randn(a.shape, generator=g).to(dtype)
            a.grad, b.grad = grad.clone(), grad.clone()
        plain.step()
        sharded.step()
        # stage >= 2: each gradient went to its owners, the whole freed
        assert all((b.grad is None) == (stage >= 2 and id(b) in
                                        sharded._zero.shards) for b in pb)
    sharded._zero.gather_params()
    for a, b in zip(pa, pb):
        assert torch.equal(a, b)
    want, got = plain.state_dict(), sharded.state_dict()
    assert list(want) == list(got)
    for k in want:
        if torch.is_tensor(want[k]):
            assert torch.equal(want[k], got[k]), k
        else:
            assert want[k] == got[k], k


def test_fleet_sharding_optimizer_shards_states():
    """``test_sharding_optimizer_shards_states``: with dp 2 (sharding 1)
    the moments split over dp: each rank's moment1 [8, 16]."""
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 2, "mp_degree": 2, "pp_degree": 2,
                        "sharding_degree": 1, "sep_degree": 1}
    fleet.init(strategy=s, devices="cpu")
    net = nn.Linear(16, 16, device="cpu")
    inner = O.Adam(1e-3, parameters=net.parameters())
    net(torch.randn(4, 16)).sum().backward()
    sharded = fleet.DygraphShardingOptimizer(inner)
    assert sharded.grad_sharding(net.weight) is None       # stage 1
    sharded.step()
    m1 = [st[0] for st in inner._zero.shards[id(net.weight)].states]
    assert {tuple(t.shape) for t in m1} == {(8, 16)} and len(m1) == 2
    sharded.clear_grad()
    assert net.weight.grad is None
    with pytest.raises(ValueError, match="element by element"):
        fleet.DygraphShardingOptimizer(O.Lamb(parameters=net.parameters()))


def test_state_dict_gathered_in_the_jax_layout():
    """The sharded state gathered into whole arrays equals the JAX
    optimizer's after the same steps (by parameter order), and a fresh
    sharded optimizer loading it continues bit-equal."""
    net, o, _, _, _ = _run(2)
    arrays = weights.optimizer_state_numpy(o)
    _, init, X, Y = _jax_losses(2)
    paddle.seed(7)
    jnet = jnn.Sequential(jnn.Linear(16, 32), jnn.Tanh(), jnn.Linear(32, 8))
    jnet.set_state_dict({k: paddle.to_tensor(v) for k, v in init.items()})
    jo = jopt.Adam(learning_rate=0.05, parameters=jnet.parameters())
    lossfn = jnn.CrossEntropyLoss()
    for _ in range(3):
        loss = lossfn(jnet(paddle.to_tensor(X)), paddle.to_tensor(Y))
        loss.backward()
        jo.step()
        jo.clear_grad()
    jsd = jo.state_dict()
    jkeys = [k for k in jsd if k != "@step"]
    tkeys = [k for k in arrays if k != "@step"]
    assert len(jkeys) == len(tkeys) and arrays["@step"] == jsd["@step"] == 3
    for jk, tk in zip(jkeys, tkeys):
        assert jk.split(".")[-1] == tk.split(".")[-1]
        np.testing.assert_allclose(arrays[tk], np.asarray(jsd[jk].numpy()),
                                   rtol=1e-4, atol=1e-6, err_msg=tk)
    # round trip into a fresh sharded optimizer
    net2 = nn.Sequential(nn.Linear(16, 32, device="cpu"), nn.Tanh(),
                         nn.Linear(32, 8, device="cpu"))
    net2.load_state_dict(net.state_dict())
    o2 = dist.shard_optimizer(O.Adam(0.05, parameters=net2.parameters()),
                              dist.ShardingStage2("dp", _mesh()))
    weights.load_optimizer_state(o2, arrays)
    ce = torch.nn.CrossEntropyLoss()
    for model, opt in ((net, o), (net2, o2)):
        ce(model(torch.from_numpy(X)), torch.from_numpy(Y)).backward()
        opt.step()
        opt.clear_grad()
    for a, b in zip(net.parameters(), net2.parameters()):
        assert torch.equal(a, b)


def test_pipeline_zero2_halves_state_and_scaler_skips_everywhere():
    """fleet pp 2 x dp 2 with stage-2 ZeRO over dp: each stage's owners
    are its dp ranks, each holds half the state; an Inf in one stage's
    gradient makes HybridParallelGradScaler skip the step on every stage
    (no parameter moves), then the next step runs."""
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 2, "mp_degree": 1, "pp_degree": 2,
                        "sharding_degree": 1, "sep_degree": 1}
    s.pipeline_configs = {"accumulate_steps": 2}
    fleet.init(strategy=s, devices="cpu")
    torch.manual_seed(0)
    pl = PipelineLayer([LayerDesc(nn.Linear, 8, 16, device="cpu"),
                        LayerDesc(nn.Tanh),
                        LayerDesc(nn.Linear, 16, 4, device="cpu")],
                       loss_fn=torch.nn.CrossEntropyLoss())
    model = fleet.distributed_model(pl)
    inner = O.AdamW(1e-2, parameters=pl.parameters(), multi_precision=True)
    opt = fleet.distributed_optimizer(
        fleet.DygraphShardingOptimizer(inner, stage=2))
    zero = inner._zero
    assert [sh.p._pp_stage for sh in zero.shards.values()] == [0, 0, 1, 1]
    b = zero.state_bytes()
    whole = sum(3 * p.numel() * 4 for p in pl.parameters())  # master+m1+m2
    assert b["per_rank"][0] == b["per_rank"][1]
    assert b["per_rank"][0] - 2 * 4 * 4 == whole // 2   # + 4 beta pows each
    scaler = fleet.distributed_scaler(ptt.amp.GradScaler(
        init_loss_scaling=1024.0))
    X, Y = torch.rand(8, 8), torch.randint(0, 4, (8,))
    before = [p.detach().clone() for p in pl.parameters()]
    loss = model.forward_backward_pipeline((X, Y), scaler)
    pl.run_function[2][0].bias.grad[0] = float("inf")    # stage 1 only
    scaler.step(opt)
    scaler.update()
    opt.clear_grad()
    assert scaler.last_found_inf and scaler.skipped_steps == 1
    assert scaler.get_init_loss_scaling() == 512.0
    for a, p in zip(before, pl.parameters()):
        assert torch.equal(a, p)
    loss2 = model.train_batch((X, Y), opt, scaler=scaler)
    assert not scaler.last_found_inf and np.isfinite(float(loss2))
    assert any(not torch.equal(a, p) for a, p in zip(before,
                                                      pl.parameters()))
    assert np.isfinite(float(loss))
