"""The port's ``fft``, ``signal`` and ``strings`` namespaces against the
JAX package's, on the CPU: values, dtypes and shapes (float64 and
complex128 1e-10 relative, float32/complex64 1e-5), and the gradients of
the transforms against JAX's tape in float64 (real inputs).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.fft  # noqa: F401
import paddle_tpu.signal  # noqa: F401
from paddle_tpu import strings as jstrings

import paddle_tpu_torch as ptt
from paddle_tpu_torch import strings as tstrings
from torch_parity import (SWEEP, case_id, check, check_grad, cpu_device,  # noqa: F401
                          rng, to_np)

torch.set_num_threads(1)

S = SWEEP.FFT
CASES = S.CASES
FFT = S.FFT
R = rng(21)
SIG = S.SIG
SIGNAL = S.SIGNAL
SIGNAL_CASES = S.SIGNAL_CASES



@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_fft_op_matches_jax(case):
    name, args, kwargs, _ = case
    check(name, args, kwargs, ns=FFT)


GRAD_CASES = [c for c in CASES if c[3].get("grad")]


@pytest.mark.parametrize("case", GRAD_CASES,
                         ids=[case_id(c) for c in GRAD_CASES])
def test_fft_grad_matches_jax(case):
    """Gradient of sum(w * |X|^2) through the transform."""
    name, args, kwargs, _ = case
    x = args[0]
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    jo = getattr(paddle.fft, name)(jx, **kwargs)
    to = getattr(ptt.fft, name)(tx, **kwargs)
    w = R.standard_normal(tuple(jo.shape))
    jl = (paddle.real(jo) ** 2 * paddle.to_tensor(w)).sum() + (
        paddle.imag(jo) ** 2 * paddle.to_tensor(w)).sum()
    tl = (to.abs() ** 2 * torch.from_numpy(w)).sum()
    (jg,) = paddle.grad(jl, [jx])
    (tg,) = torch.autograd.grad(tl, [tx])
    np.testing.assert_allclose(to_np(tg), to_np(jg), rtol=1e-9, atol=1e-10)


def test_fftfreq_matches_jax():
    for fn in ("fftfreq", "rfftfreq"):
        for n, d in ((8, 1.0), (7, 0.25)):
            got = getattr(ptt.fft, fn)(n, d)
            want = getattr(paddle.fft, fn)(n, d)
            np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-12)
            assert to_np(got).dtype == to_np(want).dtype




@pytest.mark.parametrize("case", SIGNAL_CASES,
                         ids=[case_id(c) for c in SIGNAL_CASES])
def test_signal_op_matches_jax(case):
    name, args, kwargs, _ = case
    check(name, args, kwargs, ns=SIGNAL)


def test_signal_grads_match_jax():
    check_grad("frame", (SIG, 8, 4), ns=SIGNAL)
    check_grad("overlap_add", (R.standard_normal((2, 8, 9)), 4), ns=SIGNAL)


def test_strings_match_jax():
    data = [["Hello", "WORLD"], ["MiXeD", "ok"]]
    for mod_t, mod_j in ((tstrings, jstrings),):
        t, j = mod_t.to_string_tensor(data), mod_j.to_string_tensor(data)
        assert t.shape == j.shape == [2, 2]
        for fn in ("lower", "upper"):
            np.testing.assert_array_equal(getattr(mod_t, fn)(t).numpy(),
                                          getattr(mod_j, fn)(j).numpy())
        assert mod_t.empty([3]).shape == [3] and mod_t.empty_like(t) == \
            mod_t.StringTensor(np.full((2, 2), ""))
        assert t == mod_t.StringTensor(data) and "StringTensor" in repr(t)
