"""The port's linear algebra (``ops/impl/linalg.py`` and the ``linalg``
namespace) against the JAX package's, on the CPU: values, dtypes and
shapes (float64 1e-10 relative; the decompositions' own outputs 1e-8),
and gradients against JAX's tape in float64.

Factors that are unique only up to sign or phase (``svd``, ``qr``,
``eig``, ``eigh``) are held by what is unique: the reconstruction, the
orthogonality of the factors, and the (sorted) singular and eigen
values against JAX's. ``lu`` and ``cholesky`` are unique (LAPACK's
partial pivoting on both sides) and held directly.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from torch_parity import (SWEEP, call_both, case_id, check,  # noqa: F401
                          check_grad, cpu_device, to_np)

torch.set_num_threads(1)

S = SWEEP.LINALG
A = S.A
B = S.B
CASES = S.CASES
SPD = S.SPD
TALL = S.TALL



@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_linalg_op_matches_jax(case):
    name, args, kwargs, opts = case
    if name == "svd_lowrank":
        # the singular values (the factors' signs are free)
        got, want = call_both(name, args, kwargs)
        np.testing.assert_allclose(to_np(got[1]), to_np(want[1]), 1e-10)
        return
    check(name, args, kwargs, tol=opts.get("tol"))


GRAD_CASES = [c for c in CASES if c[3].get("grad")]


@pytest.mark.parametrize("case", GRAD_CASES,
                         ids=[case_id(c) for c in GRAD_CASES])
def test_linalg_op_grad_matches_jax(case):
    name, args, kwargs, opts = case
    check_grad(name, args, kwargs, tol=(1e-8, 1e-10))


def _orthonormal_cols(m):
    np.testing.assert_allclose(m.T @ m, np.eye(m.shape[1]), atol=1e-10)


@pytest.mark.parametrize("full", [False, True])
def test_svd_reconstructs_with_jax_singular_values(full):
    (u, s, v), (_, ws, _) = (tuple(to_np(o)) for o in call_both(
        "svd", (TALL,), {"full_matrices": full}))
    np.testing.assert_allclose(s, ws, rtol=1e-10)
    k = s.shape[0]
    np.testing.assert_allclose(u[:, :k] * s @ v[:, :k].T, TALL, atol=1e-10)
    _orthonormal_cols(u)
    _orthonormal_cols(v)


@pytest.mark.parametrize("mode", ["reduced", "complete", "r"])
def test_qr_reconstructs_and_matches_jax_r_up_to_sign(mode):
    got, want = call_both("qr", (TALL,), {"mode": mode})
    if mode == "r":
        r, wr = to_np(got), to_np(want)
        np.testing.assert_allclose(np.abs(r), np.abs(wr), atol=1e-10)
        return
    q, r = to_np(got)
    assert q.shape == to_np(want)[0].shape and r.shape == to_np(want)[1].shape
    np.testing.assert_allclose(q @ r, TALL, atol=1e-10)
    _orthonormal_cols(q)
    np.testing.assert_allclose(np.abs(r), np.abs(to_np(want)[1]),
                               atol=1e-10)
    assert np.allclose(np.tril(r, -1), 0)


def test_eig_eigh_eigvals_hold_their_equations():
    (w, v), (ww, _) = (to_np(o) for o in call_both("eig", (A,)))
    assert w.dtype == ww.dtype and v.dtype == np.complex128
    np.testing.assert_allclose(np.sort_complex(w), np.sort_complex(ww),
                               rtol=1e-10)
    np.testing.assert_allclose(A @ v, v * w, atol=1e-10)
    ev, wev = (to_np(o) for o in call_both("eigvals", (A,)))
    np.testing.assert_allclose(np.sort_complex(ev), np.sort_complex(wev),
                               rtol=1e-10)
    # the JAX op cannot wrap jnp's EighResult on this jax; its
    # eigenvalues are numpy's (eigvalsh, above, is held to the JAX op)
    for uplo in ("L", "U"):
        w, v = (to_np(o) for o in ptt.eigh(torch.from_numpy(SPD), uplo))
        np.testing.assert_allclose(w, np.linalg.eigvalsh(SPD), rtol=1e-10)
        np.testing.assert_allclose(SPD @ v, v * w, atol=1e-9)
        _orthonormal_cols(v)


def test_lstsq_lu_unpack_householder_and_pca_match_jax():
    got, want = call_both("lstsq", (TALL, B[:, :2].repeat(2, 0)[:5]))
    for g, w in zip(to_np(got)[:1] + to_np(got)[2:],
                    to_np(want)[:1] + to_np(want)[2:]):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(to_np(got)[1], to_np(want)[1], rtol=1e-9)
    lu_m, piv = ptt.lu(torch.from_numpy(A))
    jlu, jpiv = paddle.lu(paddle.to_tensor(A))
    p, l, u = (to_np(o) for o in ptt.lu_unpack(lu_m, piv))
    jp, jl, ju = (to_np(o) for o in paddle.lu_unpack(jlu, jpiv))
    for g, w in ((p, jp), (l, jl), (u, ju)):
        np.testing.assert_allclose(g, w, atol=1e-10)
    np.testing.assert_allclose(p @ l @ u, A, atol=1e-10)
    tau = np.array([1.2, 0.7, 0.0])
    check("householder_product", (TALL, tau), tol=(1e-10, 1e-12))
    got, want = call_both("pca_lowrank", (TALL,), {"q": 2})
    np.testing.assert_allclose(to_np(got)[1], to_np(want)[1], rtol=1e-10)
    assert ptt.linalg.svd is ptt.svd and ptt.linalg.norm is ptt.norm
