"""The port's ``autograd`` (and ``incubate.autograd``) against the JAX
package's, on the CPU, in float64 (1e-10 relative): ``backward`` and
``grad`` (with a second, create_graph derivative), ``PyLayer`` with a
saved tensor and a non-tensor argument, the functional ``Jacobian`` /
``jacobian``, ``Hessian`` / ``hessian``, ``vjp`` and ``jvp`` of the same
function written from each package's op surface, and the prim switch.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import autograd as jag
from paddle_tpu.incubate import autograd as jiag

import paddle_tpu_torch as ptt
from paddle_tpu_torch import autograd as tag
from paddle_tpu_torch.incubate import autograd as tiag
from torch_parity import cpu_device, rng, to_np  # noqa: F401

torch.set_num_threads(1)

R = rng(11)
X = R.standard_normal((3,))
Y = R.standard_normal((3,))
W = R.standard_normal((3, 3))
TOL = dict(rtol=1e-10, atol=1e-12)


def _f(ns, w):
    """f(x, y) = [sum(tanh(x @ w) * y), sum(x^3)] from surface ops."""
    def f(x, y):
        h = ns.tanh(ns.matmul(x, w))
        return ns.stack([ns.sum(ns.multiply(h, y)),
                         ns.sum(ns.pow(x, 3.0))])
    return f


def _scalar(ns, w):
    def f(x):
        return ns.sum(ns.multiply(ns.tanh(ns.matmul(x, w)), x))
    return f


def _pair():
    jf = _f(paddle, paddle.to_tensor(W))
    tf = _f(ptt, torch.from_numpy(W))
    return jf, tf


def _close(got, want):
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)


def test_backward_and_grad_with_a_second_derivative():
    jx = paddle.to_tensor(X, stop_gradient=False)
    tx = torch.from_numpy(X.copy()).requires_grad_(True)
    jl = paddle.sum(paddle.exp(jx) * paddle.sin(jx))
    tl = ptt.sum(ptt.multiply(ptt.exp(tx), ptt.sin(tx)))
    jag.backward(jl)
    tag.backward(tl)
    _close(tx.grad, jx.grad)
    jx2 = paddle.to_tensor(X, stop_gradient=False)
    tx2 = torch.from_numpy(X.copy()).requires_grad_(True)
    (jg,) = paddle.grad(paddle.sum(paddle.pow(jx2, 3.0)), [jx2],
                        create_graph=True)
    (tg,) = ptt.grad(ptt.sum(ptt.pow(tx2, 3.0)), [tx2], create_graph=True)
    _close(tg, jg)
    (jgg,) = paddle.grad(paddle.sum(jg), [jx2])
    (tgg,) = ptt.grad(ptt.sum(tg), [tx2])
    _close(tgg, jgg)
    unused = torch.ones(2, requires_grad=True)
    out = ptt.grad(ptt.sum(tx2 * 2.0), [tx2, unused], allow_unused=True)
    assert out[1] is None
    with pytest.raises(RuntimeError):
        ptt.grad(ptt.sum(tx2 * 2.0), [unused])
    assert ptt.is_grad_enabled()
    with ptt.no_grad():
        assert not ptt.is_grad_enabled()
        with ptt.enable_grad():
            assert ptt.is_grad_enabled()


def _cube_layer(base, ns):
    class Cube(base):
        @staticmethod
        def forward(ctx, x, scale):
            ctx.save_for_backward(x)
            ctx.scale = scale
            return ns.multiply(ns.pow(x, 3.0), scale)

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor()
            return ns.multiply(dy, ns.multiply(ns.pow(x, 2.0),
                                               3.0 * ctx.scale))
    return Cube


def test_pylayer_matches_jax():
    jcube, tcube = _cube_layer(jag.PyLayer, paddle), _cube_layer(
        tag.PyLayer, ptt)
    jx = paddle.to_tensor(X, stop_gradient=False)
    tx = torch.from_numpy(X.copy()).requires_grad_(True)
    jy, ty = jcube.apply(jx, 2.0), tcube.apply(tx, 2.0)
    _close(ty, jy)
    (jg,) = paddle.grad(paddle.sum(jy * paddle.to_tensor(Y)), [jx])
    (tg,) = ptt.grad(ptt.sum(ty * torch.from_numpy(Y)), [tx])
    _close(tg, jg)
    assert ptt.PyLayer is tag.PyLayer
    ctx = tag.PyLayerContext()
    ctx.save_for_backward(1, "a")
    assert ctx.saved_tensor() == [1, "a"]


def test_jacobian_and_hessian_match_jax():
    jf, tf = _pair()
    jxs = [paddle.to_tensor(X), paddle.to_tensor(Y)]
    txs = [torch.from_numpy(X.copy()), torch.from_numpy(Y.copy())]
    jj, tj = jag.Jacobian(jf, jxs), tag.Jacobian(tf, txs)
    for i in range(2):
        _close(tj[i], jj[i])
    jj1 = jag.Jacobian(lambda x: jf(x, jxs[1]), jxs[0])
    tj1 = tag.jacobian(lambda x: tf(x, txs[1]), txs[0])
    _close(tj1.value, jj1.value)
    assert tuple(tj1.shape) == (2, 3)
    jsf, tsf = _scalar(paddle, paddle.to_tensor(W)), _scalar(
        ptt, torch.from_numpy(W))
    _close(tag.hessian(tsf, txs[0]).value, jag.hessian(jsf, jxs[0]).value)
    th, jh = tiag.Hessian(tsf, txs[0]), jiag.Hessian(jsf, jxs[0])
    _close(th[1], jh[1])


def test_tape_jacobian_matches_the_functional_one():
    _, tf = _pair()
    tx = torch.from_numpy(X.copy()).requires_grad_(True)
    ty = torch.from_numpy(Y.copy())
    out = tf(tx, ty)
    np.testing.assert_allclose(
        tag.jacobian(out, tx).numpy(),
        tag.Jacobian(lambda x: tf(x, ty), ty.new_tensor(X)).value.numpy(),
        **TOL)


def test_vjp_jvp_and_incubate_forms_match_jax():
    jf, tf = _pair()
    jxs = [paddle.to_tensor(X), paddle.to_tensor(Y)]
    txs = [torch.from_numpy(X.copy()), torch.from_numpy(Y.copy())]
    v = np.array([0.5, -2.0])
    jout, jg = jag.vjp(jf, jxs, paddle.to_tensor(v))
    tout, tg = tag.vjp(tf, txs, torch.from_numpy(v))
    _close(tout, jout)
    for g, w in zip(tg, jg):
        _close(g, w)
    jout, jg = jiag.grad(jf, jxs)
    tout, tg = tiag.grad(tf, txs)
    for g, w in zip(tg, jg):
        _close(g, w)
    tv = [R.standard_normal((3,)) for _ in range(2)]
    jout, jt = jag.jvp(jf, jxs, [paddle.to_tensor(t) for t in tv])
    tout, tt = tag.jvp(tf, txs, [torch.from_numpy(t) for t in tv])
    _close(tout, jout)
    _close(tt, jt)
    _close(tiag.forward_grad(tf, txs)[1], jiag.forward_grad(jf, jxs)[1])
    for mod in (jiag, tiag):
        mod.enable_prim()
        assert mod.prim_enabled()
        mod.disable_prim()
        assert not mod.prim_enabled()


def test_saved_tensors_hooks_see_every_saved_tensor():
    packed = []

    def pack(t):
        packed.append(t.shape)
        return t.clone()

    x = torch.from_numpy(X.copy()).requires_grad_(True)
    with tag.saved_tensors_hooks(pack, lambda t: t):
        y = ptt.sum(ptt.multiply(ptt.exp(x), x))
    y.backward()
    assert packed
    np.testing.assert_allclose(x.grad.numpy(), np.exp(X) * (X + 1), **TOL)
