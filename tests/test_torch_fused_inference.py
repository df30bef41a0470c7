"""The port's fused inference ops (``ops/impl/fused_inference.py``, all 24)
against the JAX package's, on the CPU.

Every case of ``ops_sweep_torch.FUSEDINF`` (numpy-seeded inputs) goes
through ``paddle_tpu.<op>`` and ``paddle_tpu_torch.<op>``: float64 to
1e-10 relative, float32 to 1e-5 (the attention ops, whose port side is the
flash kernel's plain version), bfloat16 (the fp8 GEMM's output) to 1e-2,
integers exact; the "grad" cases hold the gradients of a random weighting
of the outputs against JAX's tape (float64 1e-9). Then what a table
cannot hold: the 24 names on both top levels, the attention ops' route
through ``scaled_dot_product_attention`` (the flash path when unmasked),
the ``finfo.min`` row with no valid key, the float8 conversion of
out-of-range and NaN values against ``ml_dtypes``, and
``fused_dropout_add``'s draws (the port's generators: not JAX's draws,
so by their rule and repeatability).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.ops.registry import OP_TABLE as JOP_TABLE

import paddle_tpu_torch as ptt
from paddle_tpu_torch.ops.impl import fused_inference as FI
from torch_parity import (SWEEP, case_id, check, check_grad,  # noqa: F401
                          cpu_device, rng)

torch.set_num_threads(1)

CASES = SWEEP.FUSEDINF.CASES
OPS = sorted(n for n, e in JOP_TABLE.items()
             if e["fn"].__module__ == "paddle_tpu.ops.impl.fused_inference")


def test_the_24_ops_are_on_both_top_levels():
    assert len(OPS) == 24 and sorted(FI.__all__) == OPS
    assert {c[0] for c in CASES} == set(OPS)
    for name in OPS:
        assert callable(getattr(ptt, name)) and callable(getattr(paddle,
                                                                 name))


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_op_matches_jax(case):
    name, args, kwargs, opts = case
    check(name, args, kwargs, tol=opts.get("tol"))


GRAD_CASES = [c for c in CASES if c[3].get("grad")]


@pytest.mark.parametrize("case", GRAD_CASES,
                         ids=[case_id(c) for c in GRAD_CASES])
def test_op_grad_matches_jax(case):
    name, args, kwargs, opts = case
    check_grad(name, args, kwargs, diff=opts.get("diff"))


@pytest.mark.parametrize("name", ["fused_dot_product_attention",
                                  "qkv_unpack_mha"])
def test_attention_ops_take_the_flash_path_unmasked(name, monkeypatch):
    from paddle_tpu_torch.ops import kernels as K
    seen = []
    orig = K.FlashAttention.apply

    def spy(*a):
        seen.append(a[3])
        return orig(*a)
    monkeypatch.setattr(K.FlashAttention, "apply", spy)
    r = rng(3)
    q, k, v = (torch.from_numpy(r.standard_normal((2, 8, 2, 16)).astype(
        np.float32)) for _ in range(3))
    getattr(ptt, name)(q, k, v)
    assert len(seen) == 1
    # masked: the dense path, no flash call
    mask = torch.zeros(2, 2, 8, 8)
    if name == "qkv_unpack_mha":
        ptt.qkv_unpack_mha(q, k, v, src_mask=mask)
    else:
        ptt.fused_dot_product_attention(q, k, v, mask=mask)
    assert len(seen) == 1


def test_row_without_valid_keys_averages_every_value():
    """kv_seq_lens 0: every score is finfo.min, the softmax is uniform,
    and the row is the mean of all values (JAX's result)."""
    r = rng(5)
    q, k, v = (r.standard_normal((1, 2, 3, 4)) for _ in range(3))
    args = (q, k, v, np.array([3], np.int32), np.array([0], np.int32))
    got, _ = check("variable_length_memory_efficient_attention", args)
    want = np.broadcast_to(v.mean(axis=2, keepdims=True), v.shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


def test_float8_conversion_against_ml_dtypes():
    """torch.float8_e4m3fn and ml_dtypes (the JAX package's float8) cast
    in-range values and NaN alike, but differ past the largest finite
    value (448): ml_dtypes rounds to 448 up to 464 and gives NaN beyond
    (and for an infinity, e4m3fn having none), torch saturates to +-448.
    The port's fp8 op casts through ``to_e4m3fn``, which keeps
    ml_dtypes' rule, so its operands equal the JAX op's."""
    vals = np.array([0.0, -0.0, 1.0, -3.14159, 0.0019, 240.0, 447.0, 448.0,
                     463.0, 464.0, 465.0, 480.0, 1e4, -1e4, np.inf, -np.inf,
                     np.nan, 1e-9], np.float32)
    want = vals.astype(ml_dtypes.float8_e4m3fn).astype(np.float32)
    torch_cast = torch.from_numpy(vals).to(torch.float8_e4m3fn).float()
    over = np.abs(vals) > 464
    np.testing.assert_array_equal(torch_cast.numpy()[~over], want[~over])
    assert np.isnan(want[over]).all()
    np.testing.assert_array_equal(torch_cast.numpy()[over],
                                  np.sign(vals[over]) * 448.0)
    got = FI.to_e4m3fn(torch.from_numpy(vals)).float().numpy()
    np.testing.assert_array_equal(got, want)
    x = np.full((2, 4), 1000.0, np.float32)
    check("fp8_fp8_half_gemm_fused", (x, np.ones((4, 3), np.float32)),
          {"output_dtype": "float32"})


def test_fused_dropout_add_draws():
    r = rng(9)
    x = torch.from_numpy(r.uniform(1.0, 2.0, (256, 16)).astype(np.float32))
    y = torch.from_numpy(r.standard_normal((256, 16)).astype(np.float32))
    p = 0.25
    ptt.seed(4)
    a = ptt.fused_dropout_add(x, y, p=p)
    ptt.seed(4)
    b = ptt.fused_dropout_add(x, y, p=p)
    assert torch.equal(a, b)
    kept = (a - y) != 0
    np.testing.assert_allclose((a - y)[kept], (x / (1 - p))[kept],
                               rtol=1e-6)
    assert abs(float(kept.float().mean()) - (1 - p)) < 0.03
    c = ptt.fused_dropout_add(x, y, p=p, seed=11, fix_seed=True)
    d = ptt.fused_dropout_add(x, y, p=p, seed=11, fix_seed=True)
    assert torch.equal(c, d)
    down = ptt.fused_dropout_add(x, y, p=p, mode="downscale_in_infer")
    kept = (down - y) != 0
    np.testing.assert_allclose((down - y)[kept], x[kept], rtol=1e-6)
    assert torch.equal(ptt.fused_dropout_add(x, y, p=0.0), x + y)
