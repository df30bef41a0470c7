"""The port's ``nn.functional`` (conv, pooling, norms, common, losses and
the attention names) against the JAX package's, on the CPU.

Every case of ``ops_sweep_torch.NN`` (the sweep's table, numpy-seeded
inputs) goes through ``paddle_tpu.<op>`` and ``paddle_tpu_torch.<op>``:
float64 to 1e-10 relative, float32 to 1e-5 (the convolutions 1e-4),
integers exact; the cases marked "grad" also hold the gradients of a
random weighting of the outputs against JAX's tape (float64 1e-9, float32
2e-5). The table covers both data formats, "SAME"/"VALID" and per-side
paddings, ceil_mode, exclusive average pools, groups, dilation,
transposed output_padding/output_size, the adaptive pools (JAX's uneven
3-D result has its last two dims swapped: compared swapped back), and
``interpolate``'s
``jax.image.resize`` cases: half-pixel nearest at a non-integer ratio,
an antialiased bilinear downscale, bicubic, align_corners, 1-D and 3-D.
Then the cases a table cannot hold: the stateless ``batch_norm``, the
random functionals by their moments, the strided inputs reaching the
kernel entries dense, and the functional package's names against
JAX's.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF

import paddle_tpu_torch as ptt
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import kernels as K
from torch_parity import (SWEEP, assert_same, call_both,  # noqa: F401
                          case_id, check, check_grad, cpu_device, rng,
                          to_np)

torch.set_num_threads(1)

S = SWEEP.NN
CASES = S.CASES


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_functional_matches_jax(case):
    name, args, kwargs, opts = case
    if opts.get("jax_swaps_last_two"):
        # the JAX op's uneven 3-D adaptive pool stacks its output dims as
        # (d0, d2, d1) (``_adaptive_pool``'s build); the port's are in
        # order, so JAX's are swapped back before the comparison
        got, want = call_both(name, args, kwargs)
        assert_same(to_np(got), np.swapaxes(to_np(want), -1, -2),
                    opts.get("tol"), where=name)
        return
    check(name, args, kwargs, tol=opts.get("tol"))


GRAD_CASES = [c for c in CASES if c[3].get("grad")]


@pytest.mark.parametrize("case", GRAD_CASES,
                         ids=[case_id(c) for c in GRAD_CASES])
def test_functional_grad_matches_jax(case):
    name, args, kwargs, opts = case
    tol = opts.get("tol")
    check_grad(name, args, kwargs,
               tol=(2e-5, 2e-6) if tol else (1e-9, 1e-11),
               diff=opts.get("diff"))


# -- the stateless batch_norm and the random functionals ---------------------

def test_batch_norm_functional_matches_jax():
    r = rng(31)
    x = r.standard_normal((4, 3, 5, 5))
    mean, var = r.standard_normal(3), r.uniform(0.5, 2.0, 3)
    w, b = r.standard_normal(3), r.standard_normal(3)
    for training in (False, True):
        got = F.batch_norm(*map(torch.from_numpy, (x, mean, var, w, b)),
                           training=training)
        want = JF.batch_norm(*map(paddle.to_tensor, (x, mean, var, w, b)),
                             training=training)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10,
                                   atol=1e-12)
    got = F.batch_norm(*map(torch.from_numpy, (x, mean, var)),
                       training=True, use_global_stats=True)
    want = JF.batch_norm(*map(paddle.to_tensor, (x, mean, var)),
                         training=True, use_global_stats=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10,
                               atol=1e-12)


def test_channel_dropouts_and_alpha_dropout_draws():
    ptt.seed(3)
    x = torch.ones(64, 32, 3, 3)
    y = F.dropout2d(x, p=0.25)
    per_channel = y.reshape(64, 32, -1)
    # a channel is all dropped or all kept (scaled by 1 / (1 - p))
    assert torch.all((per_channel == 0).all(-1) |
                     (per_channel == 1 / 0.75).all(-1))
    assert abs(float((per_channel[..., 0] == 0).float().mean()) - 0.25) < 0.03
    z = F.dropout3d(torch.ones(16, 32, 2, 2, 2), p=0.5,
                    data_format="NDHWC")
    assert torch.all(z == z[:, :1, :1, :1])
    a = F.alpha_dropout(torch.randn(200000, dtype=torch.float64), p=0.2)
    assert abs(float(a.mean())) < 0.01 and abs(float(a.std()) - 1) < 0.01
    ptt.seed(3)
    again = F.dropout2d(x, p=0.25)
    assert torch.equal(again, y)


def test_fractional_pool_draw_is_seeded_and_unpool_inverts_max_pool():
    x = torch.from_numpy(rng(32).standard_normal((2, 3, 9, 9)))
    ptt.seed(5)
    a = F.fractional_max_pool2d(x, 4)
    ptt.seed(5)
    b = F.fractional_max_pool2d(x, 4)
    assert torch.equal(a, b) and a.shape == (2, 3, 4, 4)
    out, idx = F.max_pool2d(x[:, :, :8, :8], 2, return_mask=True)
    back = F.max_unpool2d(out, idx, 2)
    assert back.shape == (2, 3, 8, 8)
    # each window's maximum goes back to its place, zeros elsewhere
    np.testing.assert_array_equal(
        torch.gather(back.reshape(2, 3, -1), 2,
                     idx.reshape(2, 3, -1)).numpy(),
        out.reshape(2, 3, -1).numpy())
    assert int((back != 0).sum()) == out.numel()


# -- item 0: strided inputs reach the kernel entries dense -------------------

def _spy(monkeypatch, owner, attr, seen):
    real = getattr(owner, attr)

    def spy(*args, **kwargs):
        seen.append([a.is_contiguous() for a in args
                     if isinstance(a, torch.Tensor)])
        return real(*args, **kwargs)
    monkeypatch.setattr(owner, attr, spy)


def _strided(shape, perm, r):
    """A non-contiguous view of `shape` (a permutation of a dense
    tensor)."""
    inv = np.argsort(perm)
    base = torch.from_numpy(r.standard_normal(
        [shape[i] for i in perm]).astype(np.float32))
    t = base.permute(*inv)
    assert tuple(t.shape) == tuple(shape) and not t.is_contiguous()
    return t


def test_strided_inputs_reach_every_kernel_entry_contiguous(monkeypatch):
    """A UNet-style strided q/k/v (and strided inputs of the other kernel
    entry points) reach the kernels' ops dense, and give what dense
    inputs give."""
    r = rng(33)
    qkv = torch.from_numpy(r.standard_normal((2, 3, 4, 8, 16)).astype(
        np.float32)).permute(0, 4, 1, 2, 3)           # b, s, 3, h, d
    q, k, v = (qkv[:, :, i] for i in range(3))
    assert not q.is_contiguous()
    seen = {}
    for owner, attr in ((K.FlashAttention, "apply"),
                        (K.FlashmaskAttention, "apply"),
                        (K.RMSNorm, "apply"), (K.SwiGLU, "apply"),
                        (K.FusedRoPE, "apply"), (K.FusedRoPEQK, "apply"),
                        (K.BiasDropoutResidualLN, "apply"),
                        (K, "paged_decode_attention"),
                        (K, "ragged_paged_attention")):
        seen[f"{getattr(owner, '__name__', 'K')}.{attr}"] = lst = []
        _spy(monkeypatch, owner, attr, lst)
    dense = [t.contiguous() for t in (q, k, v)]
    checks = [
        (lambda a, b, c: F.scaled_dot_product_attention(a, b, c),
         (q, k, v), dense),
        (lambda a, b, c: F.flash_attention(a, b, c, causal=True)[0],
         (q, k, v), dense),
        (lambda a, b, c: F.flashmask_attention(
            a, b, c, torch.full((2, 1, 16, 1), 12, dtype=torch.int32),
            causal=True), (q, k, v), dense),
    ]
    x = _strided((6, 16), (1, 0), r)
    w = torch.from_numpy(r.uniform(0.5, 1.5, 16).astype(np.float32))
    checks.append((lambda a: F.rms_norm(a, w), (x,), (x.contiguous(),)))
    checks.append((lambda a: ptt.fused_rms_norm(a, w, 1e-6), (x,),
                   (x.contiguous(),)))
    g, u = _strided((6, 16), (1, 0), r), _strided((6, 16), (1, 0), r)
    checks.append((lambda a, b: F.swiglu(a, b), (g, u),
                   (g.contiguous(), u.contiguous())))
    ang = torch.from_numpy(r.standard_normal((16, 4)).astype(np.float32))
    cos = torch.cos(torch.cat([ang, ang], -1))
    sin = torch.sin(torch.cat([ang, ang], -1))
    checks.append((lambda a: F.fused_rope(a, cos, sin), (q,), (dense[0],)))
    checks.append((lambda a: ptt.fused_rope(a, cos, sin), (q,),
                   (dense[0],)))
    checks.append((lambda a, b: torch.cat(F.fused_rope_qk(a, b, cos, sin),
                                          2), (q, k), dense[:2]))
    res = _strided((6, 16), (1, 0), r)
    checks.append((lambda a, b: ptt.fused_bias_dropout_residual_layer_norm(
        a, b, dropout_rate=0.0), (x, res), (x.contiguous(),
                                            res.contiguous())))
    pages = torch.from_numpy(r.standard_normal((6, 4, 8, 2)).astype(
        np.float32)).permute(0, 1, 3, 2)                # N, page, H_kv, D
    tables = torch.tensor([[0, 2, 4], [1, 3, 5]], dtype=torch.int32)
    ctx = torch.tensor([9, 5], dtype=torch.int32)
    qd = _strided((2, 4, 8), (2, 1, 0), r)
    checks.append((lambda a, p: F.paged_attention(a, p, p, tables, ctx),
                   (qd, pages), (qd.contiguous(), pages.contiguous())))
    qr = _strided((2, 3, 4, 8), (3, 1, 2, 0), r)
    checks.append((lambda a, p: F.ragged_paged_attention(
        a, p, p, tables, ctx, torch.tensor([3, 1], dtype=torch.int32)),
        (qr, pages), (qr.contiguous(), pages.contiguous())))
    for fn, strided, contiguous in checks:
        got, want = fn(*strided), fn(*contiguous)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    for name, calls in seen.items():
        assert calls, f"{name} was not reached"
        assert all(all(c) for c in calls), (name, calls)


def test_functional_names_equal_jax():
    """Every name the JAX package's nn.functional exports is the port's
    (the tail functionals of ``nn/functional/tail.py`` are the next
    slice's)."""
    from paddle_tpu.nn.functional import tail as jtail
    tail = set(jtail.__dict__.get("__all__", [])) | {
        "gaussian_nll_loss", "poisson_nll_loss", "soft_margin_loss",
        "multi_label_soft_margin_loss", "multi_margin_loss",
        "triplet_margin_with_distance_loss", "dice_loss",
        "pairwise_distance", "adaptive_log_softmax_with_loss",
        "margin_cross_entropy", "class_center_sample",
        "feature_alpha_dropout"}
    names = [n for n in JF._EXPORTS if hasattr(JF, n)] + ["batch_norm"]
    missing = [n for n in names if n not in tail and not hasattr(F, n)
               and n != "sdp_kernel"]
    assert missing == []


# -- signatures -----------------------------------------------------------

EXTRAS = {"generator", "device", "dtype"}


def _same_surface(port, ref):
    """port's parameters are ref's (names, defaults, kinds), then
    keyword-only EXTRAS."""
    import inspect

    def params(fn):
        return [p for p in inspect.signature(inspect.unwrap(fn))
                .parameters.values() if p.name != "self"]
    want = [(p.name, p.default, p.kind) for p in params(ref)]
    got = params(port)
    assert [(p.name, p.default, p.kind) for p in got[:len(want)]] == want
    assert all(p.kind == p.KEYWORD_ONLY and p.name in EXTRAS
               for p in got[len(want):])


def _jax_functionals():
    from paddle_tpu.ops.registry import OP_TABLE as JT
    mods = {f"paddle_tpu.nn.functional.{m}" for m in (
        "common", "conv", "pooling", "norm", "loss", "attention")}
    return sorted(n for n, e in JT.items()
                  if e["fn"].__module__ in mods and n != "sdp_kernel")


@pytest.mark.parametrize("name", _jax_functionals() + ["batch_norm"])
def test_functional_signature_matches_jax(name):
    _same_surface(getattr(F, name), getattr(JF if name == "batch_norm"
                                            else paddle, name))
    if name != "batch_norm":
        assert getattr(ptt, name) is getattr(F, name)
