"""The port's mixture of experts (``incubate.distributed.moe_layer``)
against the JAX package's, on the CPU.

The same weights (the JAX layer's, bridged by name) and seeded inputs go
through both layers: outputs and the aux loss to 1e-5 of the largest
output (float32; the expert products and the combine sum in other
orders), gradients of the weights, the router and the input to 1e-5 of
each one's largest. Both dispatch forms (``FLAGS_moe_sorted_dispatch``),
with capacity drops; routing with tied router logits takes JAX's
``top_k`` order (the lower expert first) and both forms keep and drop
exactly the pairs JAX keeps; the naive, GShard and Switch gates with
their aux losses; the ep=4 run on a co-located 2 x 4 mesh equals the
dense run exactly (outputs and gradients), and the JAX ep=4 run to
1e-5; ``incubate.nn.functional.fused_moe`` is ``moe_dispatch_combine``.
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.incubate.nn.functional as JIF
from paddle_tpu.incubate.distributed.models import moe as jmoe
from paddle_tpu.incubate.distributed import moe_layer as jml

import paddle_tpu_torch as ptt
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch import weights
from paddle_tpu_torch.incubate.distributed import moe_layer as tml
from paddle_tpu_torch.incubate.distributed.models import moe as tmoe
from paddle_tpu_torch.incubate.nn import functional as TIF
from torch_parity import cpu_device, rng  # noqa: F401

torch.set_num_threads(1)

REL = 1e-5


@pytest.fixture(params=[True, False], ids=["sorted", "onehot"])
def sorted_flag(request):
    old_j = paddle.get_flags("FLAGS_moe_sorted_dispatch")
    old_t = ptt.get_flags("FLAGS_moe_sorted_dispatch")
    flag = {"FLAGS_moe_sorted_dispatch": request.param}
    paddle.set_flags(flag)
    ptt.set_flags(flag)
    yield request.param
    paddle.set_flags(old_j)
    ptt.set_flags(old_t)


def _close(got, want, rel=REL, where=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, where
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (where, err)


def _pair(gate=None, seed=0, **kw):
    """(JAX layer, port layer) with the JAX layer's weights."""
    paddle.seed(seed)
    jgate = tgate = None
    if gate is not None:
        jcls, tcls, gkw = gate
        jgate = jcls(16, kw.get("num_expert", 8), **gkw)
        tgate = tcls(16, kw.get("num_expert", 8), device="cpu", **gkw)
    jm = jmoe.MoELayer(d_model=16, d_hidden=32, gate=jgate, **kw)
    tm = tmoe.MoELayer(d_model=16, d_hidden=32, gate=tgate, device="cpu",
                       **kw)
    weights.from_paddle_tpu_state(
        {n: np.asarray(p._value, np.float32)
         for n, p in jm.named_parameters()}, tm)
    return jm, tm


def _x(seed=1, shape=(2, 12, 16)):
    return rng(seed).standard_normal(shape).astype(np.float32)


def _run(jm, tm, x, w=None):
    """Forward + backward of sum(w * out) + aux in both packages: (port
    out, JAX out, port grads, JAX grads) by name, "x" the input's."""
    w = rng(5).standard_normal(x.shape).astype(np.float32) if w is None \
        else w
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x).requires_grad_(True)
    jo, to = jm(jx), tm(tx)
    ((jo * paddle.to_tensor(w)).sum() + jm._aux_loss).backward()
    ((to * torch.from_numpy(w)).sum() + tm._aux_loss).backward()
    jg = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    tg = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    jg["x"], tg["x"] = np.asarray(jx.grad.numpy()), tx.grad.numpy()
    return to, jo, tg, jg


@pytest.mark.parametrize("cf", [1.5, 0.5], ids=["roomy", "drops"])
def test_layer_matches_jax(sorted_flag, cf):
    jm, tm = _pair(num_expert=8, topk=2, capacity_factor=cf)
    to, jo, tg, jg = _run(jm, tm, _x())
    _close(to.detach().numpy(), jo.numpy(), where="out")
    np.testing.assert_allclose(float(tm._aux_loss), float(jm._aux_loss),
                               rtol=1e-6)
    assert set(tg) == set(jg)
    for n in jg:
        _close(tg[n], jg[n], where=n)


def test_tied_logits_route_as_jax_top_k():
    """Router logits with many ties (bf16-like, a few values): the port's
    top-k equals jax.lax.top_k (lower index first) and both dispatch
    forms keep and drop the pairs the JAX forms do."""
    r = rng(6)
    logits = r.integers(0, 3, (24, 8)).astype(np.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    jv, ji = jax.lax.top_k(probs, 2)
    tv, ti = tml.route(torch.from_numpy(logits), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)
    x = r.standard_normal((24, 16)).astype(np.float32)
    wgu = r.standard_normal((8, 16, 32)).astype(np.float32) * 0.2
    wd = r.standard_normal((8, 32, 16)).astype(np.float32) * 0.2
    stats = tml.dispatch_stats(torch.from_numpy(logits), 2, 0.75)
    assert stats["dropped"] > 0
    kept = stats["kept_mask"].numpy()
    outs = {}
    for flag in (True, False):
        paddle.set_flags({"FLAGS_moe_sorted_dispatch": flag})
        ptt.set_flags({"FLAGS_moe_sorted_dispatch": flag})
        want = np.asarray(jml.moe_dispatch_combine(
            *map(paddle.to_tensor, (x, logits, wgu, wd)), 2, 0.75).numpy())
        got = tml.moe_dispatch_combine(
            *map(torch.from_numpy, (x, logits, wgu, wd)), 2, 0.75).numpy()
        _close(got, want, where=f"sorted={flag}")
        outs[flag] = got
    paddle.set_flags({"FLAGS_moe_sorted_dispatch": True})
    ptt.set_flags({"FLAGS_moe_sorted_dispatch": True})
    _close(outs[True], outs[False])
    # a token with both pairs dropped outputs zero, in both forms
    gone = ~kept.any(axis=1)
    assert gone.any()
    assert (outs[True][gone] == 0).all() and (outs[False][gone] == 0).all()
    assert (np.abs(outs[True][~gone]).sum(-1) > 0).all()


def test_capacity_drops_the_same_tokens_as_jax(sorted_flag):
    jm, tm = _pair(seed=9, num_expert=2, topk=1, capacity_factor=0.25)
    x = _x(9, (1, 32, 8 * 2))
    jo = np.abs(np.asarray(jm(paddle.to_tensor(x)).numpy())).sum(-1)[0]
    to = np.abs(tm(torch.from_numpy(x)).detach().numpy()).sum(-1)[0]
    np.testing.assert_array_equal(to == 0, jo == 0)
    assert (to == 0).sum() > 0


@pytest.mark.parametrize("gate", ["naive", "gshard", "switch"])
def test_gates_and_aux_losses_match_jax(gate):
    spec = {"naive": None,
            "gshard": (jmoe.GShardGate, tmoe.GShardGate,
                       {"topk": 2, "aux_loss_weight": 0.5}),
            "switch": (jmoe.SwitchGate, tmoe.SwitchGate, {})}[gate]
    jm, tm = _pair(gate=spec, seed=3, num_expert=4)
    if gate == "switch":
        jm.eval()
        tm.eval()                       # no jitter: the routing is equal
    to, jo, tg, jg = _run(jm, tm, _x(4, (1, 8, 16)))
    _close(to.detach().numpy(), jo.numpy())
    np.testing.assert_allclose(float(tm._aux_loss), float(jm._aux_loss),
                               rtol=1e-6)
    _close(tg["gate.gate.weight"], jg["gate.gate.weight"])
    if gate == "switch":
        tm.train()
        a = tm(torch.from_numpy(_x(4, (1, 8, 16))))
        assert a.shape == (1, 8, 16) and torch.isfinite(a).all()
        with pytest.raises(ValueError):
            tmoe.SwitchGate(16, 4, topk=2, device="cpu")


def test_expert_parallel_equals_dense_exactly(sorted_flag):
    jm, dense = _pair(seed=42, num_expert=8, topk=2)
    mesh = tdist.ProcessMesh(np.arange(8).reshape(2, 4), ["dp", "ep"],
                             devices="cpu")
    sharded = tmoe.MoELayer(d_model=16, d_hidden=32, num_expert=8, topk=2,
                            mesh=mesh, ep_axis="ep", device="cpu")
    sharded.load_state_dict(dense.state_dict())
    pieces = tdist.local_shards(sharded.w_gate_up)
    assert len(pieces) == 8 and {tuple(p.shape) for p in pieces} == \
        {(2, 16, 32)}
    assert tml._ep_shards(sharded.w_gate_up) == [
        (0, 2, torch.device("cpu")), (2, 4, torch.device("cpu")),
        (4, 6, torch.device("cpu")), (6, 8, torch.device("cpu"))]
    x = _x(42, (1, 24, 16))
    w = rng(43).standard_normal(x.shape).astype(np.float32)
    outs, grads = [], []
    for m in (dense, sharded):
        tx = torch.from_numpy(x).requires_grad_(True)
        o = m(tx)
        ((o * torch.from_numpy(w)).sum() + m._aux_loss).backward()
        outs.append(o.detach().numpy())
        grads.append({"x": tx.grad.numpy(), **{
            n: p.grad.numpy() for n, p in m.named_parameters()}})
    np.testing.assert_array_equal(outs[1], outs[0])
    assert float(sharded._aux_loss) == float(dense._aux_loss)
    for n in grads[0]:
        np.testing.assert_array_equal(grads[1][n], grads[0][n], err_msg=n)
    # and the JAX ep=4 run (GSPMD over 8 CPU devices) to 1e-5
    jmesh = jdist.ProcessMesh(np.arange(8).reshape(2, 4), ["dp", "ep"])
    jsh = jmoe.MoELayer(d_model=16, d_hidden=32, num_expert=8, topk=2,
                        mesh=jmesh, ep_axis="ep")
    jsh.set_state_dict(jm.state_dict())
    jdist.shard_tensor(jsh.w_gate_up, jmesh,
                       [jdist.Replicate(), jdist.Shard(0)])
    jdist.shard_tensor(jsh.w_down, jmesh,
                       [jdist.Replicate(), jdist.Shard(0)])
    _close(outs[1], np.asarray(jsh(paddle.to_tensor(x)).numpy()))


def test_fused_moe_is_moe_dispatch_combine():
    r = rng(11)
    args = (r.standard_normal((10, 16)).astype(np.float32),
            r.standard_normal((10, 4)).astype(np.float32),
            r.standard_normal((4, 16, 24)).astype(np.float32) * 0.2,
            r.standard_normal((4, 24, 16)).astype(np.float32) * 0.2)
    want = np.asarray(JIF.fused_moe(*map(paddle.to_tensor, args), 2,
                                    1.0).numpy())
    got = TIF.fused_moe(*map(torch.from_numpy, args), 2, 1.0).numpy()
    _close(got, want)
    np.testing.assert_array_equal(
        got, tml.moe_dispatch_combine(*map(torch.from_numpy, args), 2,
                                      1.0).numpy())
    lb = np.asarray(jml.load_balance_loss(paddle.to_tensor(args[1]),
                                          2).numpy())
    np.testing.assert_allclose(
        float(tml.load_balance_loss(torch.from_numpy(args[1]), 2)), lb,
        rtol=1e-6)
