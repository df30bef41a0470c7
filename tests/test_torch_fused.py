"""The port's fused FFN epilogue against the JAX package on the CPU.

The bdrln op (``ops.kernels.bias_dropout_residual_ln``: on the CPU its
plain version, the dropout bits from the plain Philox4x32-10 that the CUDA
kernel computes bit for bit) is held against
``bias_dropout_residual_ln_pallas(..., interpret=True)`` at p = 0 with
gradients; at p > 0 by its keep rate and, given the port's mask, by JAX's
``_bdrln_bwd`` fed the same mask. The plain Philox is held against the
Random123 known answers. ``fused_feedforward`` (both norm modes; relu,
gelu and swiglu) and its gradients against the JAX op at p = 0; the layer
loads the JAX layer's parameters through ``weights.from_paddle_tpu_state``.
``F.dropout``, ``F.linear``, ``F.layer_norm`` and ``nn.LayerNorm`` against
their JAX counterparts.

Tolerances: float32 outputs and gradients rtol/atol 1e-5 (the same float32
LayerNorm summed in other orders), or 1e-4 of the largest value through
the two FFN products; bfloat16 within one bf16 ulp; keep rates within 5
sigma of 1 - p.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.nn as jinn
import paddle_tpu.nn.functional as JF
from paddle_tpu.ops.pallas.fused_ffn import (_bdrln_bwd,
                                             bias_dropout_residual_ln_pallas)
from paddle_tpu.ops.registry import OP_TABLE

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import weights
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.incubate import nn as tinn
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels.bias_dropout_residual_ln import (
    dropout_bits, philox4x32)

torch.set_num_threads(1)

TOL = 1e-5


def _f32(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _ulp_close(port, ref):
    ref = np.asarray(ref).astype(np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert np.all(np.abs(port.float().numpy() - ref) <= ulp)


# Random123's known answers for Philox4x32-10 (counter, key, output)
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT, ids=["zeros", "ones", "pi"])
def test_plain_philox_known_answers(ctr, key, want):
    got = philox4x32(ctr, key)
    assert tuple(int(w) for w in got) == want


def test_dropout_bits_layout():
    """Flat index e takes word e % 4 of the block at counter (e // 4, 0),
    key (seed, 0): the layout the CUDA kernel computes."""
    bits = dropout_bits(10, 7, "cpu")
    for e in range(10):
        words = philox4x32((e // 4, 0, 0, 0), (7, 0))
        assert int(bits[e]) == int(words[e % 4])


@pytest.mark.parametrize("h,has_bias", [(128, True), (40, False)],
                         ids=["h128", "h40-nobias"])
def test_bdrln_matches_pallas_at_p0(h, has_bias):
    rng = np.random.default_rng(h)
    x, r, g = _f32(rng, (8, h)), _f32(rng, (8, h)), _f32(rng, (8, h))
    w, b, bias = _f32(rng, (h,)), _f32(rng, (h,)), _f32(rng, (h,))
    jb = jnp.asarray(bias) if has_bias else None

    def f(x_, r_, w_, b_, bias_):
        return bias_dropout_residual_ln_pallas(
            x_, r_, w_, b_, bias=bias_ if has_bias else None, eps=1e-5,
            p=0.0, interpret=True)

    ref, vjp = jax.vjp(f, *map(jnp.asarray, (x, r, w, b, bias)))
    want = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, r, w, b, bias)]
    out = K.BiasDropoutResidualLN.apply(ts[0], ts[4] if has_bias else None,
                                        ts[1], ts[2], ts[3], 1e-5, 0.0, 0)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=TOL, atol=TOL)
    out.backward(torch.from_numpy(g))
    for name, t, ref_g in zip(("x", "residual", "w", "b", "bias"), ts,
                              want):
        if name == "bias" and not has_bias:
            assert t.grad is None and jb is None
            continue
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref_g),
                                   rtol=TOL, atol=TOL, err_msg=name)

    # bfloat16: one bf16 rounding of the same float32 values
    xb, rb, wb, bb, biasb = (jnp.asarray(a, jnp.bfloat16)
                             for a in (x, r, w, b, bias))
    refb = f(xb, rb, wb, bb, biasb)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, r, w, b, bias)]
    outb, yb, keepb = K.bias_dropout_residual_ln(
        tb[0], tb[1], tb[2], tb[3], tb[4] if has_bias else None, 1e-5, 0.0)
    assert keepb is None and outb.dtype == torch.bfloat16
    _ulp_close(outb, refb)


def test_bdrln_dropout_mask_rate_and_backward_match_jax():
    """p = 0.1: the keep rate within 5 sigma of 0.9, y built from exactly
    that mask, the same seed giving the same mask, and the backward on the
    port's y and mask equal to JAX's _bdrln_bwd fed them."""
    rng = np.random.default_rng(5)
    rows, h, p = 64, 96, 0.1
    x, r, g = _f32(rng, (rows, h)), _f32(rng, (rows, h)), _f32(rng, (rows, h))
    w, b, bias = _f32(rng, (h,)), _f32(rng, (h,)), _f32(rng, (h,))
    tx, tr, tw, tb, tbias, tg = map(torch.from_numpy, (x, r, w, b, bias, g))
    out, y, keep = K.bias_dropout_residual_ln(tx, tr, tw, tb, tbias, 1e-5, p,
                                              seed=1234)
    assert keep.dtype == torch.uint8 and keep.shape == (rows, h)
    n = keep.numel()
    rate = float(keep.float().mean())
    assert abs(rate - (1 - p)) <= 5 * np.sqrt(p * (1 - p) / n)
    inv = np.float32(1.0 / (1.0 - p))
    want_y = r + (x + bias) * keep.numpy().astype(np.float32) * inv
    np.testing.assert_array_equal(y.numpy(), want_y)
    _, _, keep2 = K.bias_dropout_residual_ln(tx, tr, tw, tb, tbias, 1e-5, p,
                                             seed=1234)
    _, _, keep3 = K.bias_dropout_residual_ln(tx, tr, tw, tb, tbias, 1e-5, p,
                                             seed=1235)
    assert torch.equal(keep, keep2) and not torch.equal(keep, keep3)

    got = K.bias_dropout_residual_ln_bwd_plain(y, keep, tw, tb, tg, 1e-5, p,
                                               True)
    want = _bdrln_bwd(1e-5, p, True, False,
                      (jnp.asarray(y.numpy()),
                       jnp.asarray(keep.numpy().astype(np.float32)),
                       jnp.asarray(w), jnp.asarray(b)), jnp.asarray(g))
    # JAX returns (dx, dbias, dres, dw, db, dseed); the port (dx, dbias,
    # dres, dw, db)
    for name, a, ref in zip(("dx", "dbias", "dres", "dw", "db"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), rtol=TOL,
                                   atol=TOL, err_msg=name)
    # the autograd function's backward is that plain backward
    ts = [t.clone().requires_grad_() for t in (tx, tbias, tr, tw, tb)]
    o = K.BiasDropoutResidualLN.apply(ts[0], ts[1], ts[2], ts[3], ts[4],
                                      1e-5, p, 1234)
    assert torch.equal(o, out)
    o.backward(tg)
    for t, ref in zip(ts, (got[0], got[1], got[2], got[3], got[4])):
        assert torch.equal(t.grad, ref)


FFN_CASES = [(pre, act) for pre in (False, True)
             for act in ("relu", "gelu", "swiglu")]


@pytest.mark.parametrize("pre,act", FFN_CASES,
                         ids=[f"{'pre' if p else 'post'}-{a}"
                              for p, a in FFN_CASES])
def test_fused_feedforward_matches_jax(pre, act):
    rng = np.random.default_rng(FFN_CASES.index((pre, act)))
    h, f = 24, 40
    f1 = 2 * f if act == "swiglu" else f
    arrs = {"x": _f32(rng, (2, 5, h)), "w1": 0.2 * _f32(rng, (h, f1)),
            "w2": 0.2 * _f32(rng, (f, h)), "b1": _f32(rng, (f1,)),
            "b2": _f32(rng, (h,)), "s1": _f32(rng, (h,)),
            "c1": _f32(rng, (h,)), "s2": _f32(rng, (h,)),
            "c2": _f32(rng, (h,))}
    g = _f32(rng, (2, 5, h))
    names = list(arrs)
    kw = dict(dropout1_rate=0.0, dropout2_rate=0.0, activation=act,
              ln_epsilon=1e-5, pre_layer_norm=pre, training=True)

    def run(ffn, a):
        return ffn(a["x"], a["w1"], a["w2"], linear1_bias=a["b1"],
                   linear2_bias=a["b2"], ln1_scale=a["s1"], ln1_bias=a["c1"],
                   ln2_scale=a["s2"], ln2_bias=a["c2"], **kw)

    jfn = OP_TABLE["fused_feedforward"]["fn"]
    ref, vjp = jax.vjp(lambda *v: run(jfn, dict(zip(names, v))),
                       *(jnp.asarray(arrs[n]) for n in names))
    want = vjp(jnp.asarray(g))
    ts = {n: torch.from_numpy(a).requires_grad_() for n, a in arrs.items()}
    out = run(tinn.functional.fused_feedforward, ts)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=TOL, atol=TOL)
    out.backward(torch.from_numpy(g))
    for n, ref_g in zip(names, want):
        ref_g = np.asarray(ref_g)
        got = ts[n].grad
        if got is None:       # LN1 unused post-norm, LN2 unused pre-norm
            assert not np.abs(ref_g).any(), n
            continue
        np.testing.assert_allclose(got.numpy(), ref_g, err_msg=n,
                                   atol=1e-4 * max(1.0, np.abs(ref_g).max()))


def test_fused_ops_draw_and_route():
    """Training with p > 0 draws a fresh seed per call from the generator
    (the same generator state gives the same output); eval drops nothing;
    an unknown activation is refused; no launch is counted on the CPU."""
    K.reset_launch_counts()
    rng = np.random.default_rng(3)
    x, r = (torch.from_numpy(_f32(rng, (4, 6, 16))) for _ in range(2))
    fb = tinn.functional.fused_bias_dropout_residual_layer_norm
    a = fb(x, r, dropout_rate=0.5, generator=torch.Generator().manual_seed(1))
    b = fb(x, r, dropout_rate=0.5, generator=torch.Generator().manual_seed(1))
    c = fb(x, r, dropout_rate=0.5, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    e = fb(x, r, dropout_rate=0.5, training=False)
    assert torch.equal(e, fb(x, r, dropout_rate=0.0))
    w1, w2 = torch.ones(16, 8), torch.ones(8, 16)
    with pytest.raises(ValueError, match="activation"):
        tinn.functional.fused_feedforward(x, w1, w2, activation="gelu_new")
    assert K.launch_counts() == dict.fromkeys(K.launch_counts(), 0)
    s = trandom.next_seed(torch.Generator().manual_seed(0))
    assert isinstance(s, int) and 0 <= s < 2 ** 31 - 1
    trandom.seed(5)
    d1 = F.dropout(x, 0.5)
    trandom.seed(5)
    assert torch.equal(d1, F.dropout(x, 0.5))


def test_layer_loads_jax_parameters_and_matches_jax():
    paddle.seed(0)
    jl = jinn.FusedBiasDropoutResidualLayerNorm(16, dropout_rate=0.1,
                                                epsilon=1e-12)
    rng = np.random.default_rng(4)
    for _, p in jl.named_parameters():
        p.set_value(_f32(rng, tuple(p.shape)))
    arrays = {n: np.asarray(p._value) for n, p in jl.named_parameters()}
    tl = tinn.FusedBiasDropoutResidualLayerNorm(16, dropout_rate=0.1,
                                                epsilon=1e-12, device="cpu")
    assert sorted(n for n, _ in tl.named_parameters()) == \
        ["linear_bias", "ln_bias", "ln_scale"]
    weights.from_paddle_tpu_state(arrays, tl)
    x, r = _f32(rng, (3, 5, 16)), _f32(rng, (3, 5, 16))
    jl.eval()
    tl.eval()
    want = jl(paddle.to_tensor(x), paddle.to_tensor(r)).numpy()
    got = tl(torch.from_numpy(x), torch.from_numpy(r))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL,
                               atol=TOL)
    tl.train()
    dropped = tl(torch.from_numpy(x), torch.from_numpy(r))
    assert dropped.shape == got.shape and not torch.equal(dropped, got)


def test_dropout_linear_layer_norm_match_jax():
    rng = np.random.default_rng(6)
    x = _f32(rng, (64, 128))
    # dropout: the keep rate and the scaling of the kept values; an axis
    # shares one draw along the others; the two modes
    d = F.dropout(torch.from_numpy(x), 0.3)
    kept = d != 0
    rate = float(kept.float().mean())
    assert abs(rate - 0.7) <= 5 * np.sqrt(0.21 / x.size)
    np.testing.assert_allclose(d[kept].numpy(), (x / 0.7)[kept.numpy()],
                               rtol=1e-6)
    da = F.dropout(torch.from_numpy(x), 0.5, axis=1)
    cols = (da != 0).any(0)
    assert torch.equal((da != 0), cols[None].expand_as(da))
    np.testing.assert_allclose(
        F.dropout(torch.from_numpy(x), 0.3, training=False,
                  mode="downscale_in_infer").numpy(),
        JF.dropout(paddle.to_tensor(x), 0.3, training=False,
                   mode="downscale_in_infer").numpy(), rtol=1e-6)
    assert not F.dropout(torch.from_numpy(x), 1.0).any()
    # linear
    w, b = _f32(rng, (128, 32)), _f32(rng, (32,))
    np.testing.assert_allclose(
        F.linear(*map(torch.from_numpy, (x, w, b))).numpy(),
        JF.linear(*map(paddle.to_tensor, (x, w, b))).numpy(), rtol=TOL,
        atol=1e-4)
    # layer_norm (f32; bf16 casts before the weight multiply) and the layer
    lw, lb = _f32(rng, (128,)), _f32(rng, (128,))
    want = JF.layer_norm(*map(paddle.to_tensor, (x,)), [128],
                         paddle.to_tensor(lw), paddle.to_tensor(lb), 1e-5)
    got = F.layer_norm(torch.from_numpy(x), 128, torch.from_numpy(lw),
                       torch.from_numpy(lb))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)
    jb = JF.layer_norm(paddle.to_tensor(x).astype("bfloat16"), [128],
                       paddle.to_tensor(lw).astype("bfloat16"),
                       paddle.to_tensor(lb).astype("bfloat16"))
    tb = F.layer_norm(torch.from_numpy(x).bfloat16(), [128],
                      torch.from_numpy(lw).bfloat16(),
                      torch.from_numpy(lb).bfloat16())
    assert tb.dtype == torch.bfloat16
    _ulp_close(tb, np.asarray(jb._value).astype(np.float32))
    ln = tnn.LayerNorm(128, device="cpu")
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(lw))
        ln.bias.copy_(torch.from_numpy(lb))
    np.testing.assert_allclose(ln(torch.from_numpy(x)).detach().numpy(),
                               want.numpy(), rtol=TOL, atol=TOL)
    assert tnn.LayerNorm(8, weight_attr=False, device="cpu").weight is None
