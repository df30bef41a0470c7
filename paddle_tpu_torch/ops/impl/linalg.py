"""Linear algebra: the counterpart of ``paddle_tpu/ops/impl/linalg.py``,
on ``torch.linalg``.

The JAX package's conventions kept: ``svd`` returns (U, S, V), not Vh;
``slogdet`` stacks [sign, logabsdet]; ``lu`` returns LAPACK's 1-based
pivots; ``triangular_solve(x, y)`` solves ``x @ z = y``;
``cholesky_solve(x, y)`` solves ``A z = x`` for A's Cholesky factor y;
``lstsq`` is the minimum-norm solution (``pinv``) with numpy's residuals,
rank and singular values; ``cdist`` and ``dist`` take the differences
directly (no matmul expansion). ``eig``/``eigvals`` compute on the
tensor's device (the JAX package reads them back to the host).
"""

from __future__ import annotations

import torch

from ..registry import register_op
from ._common import axes, inexact


@register_op("matmul")
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    if transpose_x and x.dim() >= 2:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() >= 2:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


@register_op("mm")
def mm(input, mat2, name=None):  # noqa: A002
    return torch.matmul(input, mat2)


@register_op("bmm")
def bmm(x, y, name=None):
    return torch.matmul(x, y)


@register_op("dot")
def dot(x, y, name=None):
    return torch.sum(x * y, dim=-1)


@register_op("mv")
def mv(x, vec, name=None):
    return torch.matmul(x, vec)


@register_op("einsum")
def einsum(equation, *operands, name=None):
    return torch.einsum(equation, *operands)


def _is(p, v):
    return p == v or (isinstance(p, str) and p == str(v))


@register_op("norm")
def norm(x, p=None, axis=None, keepdim=False, name=None):
    if p is None:
        p = "fro" if axis is None or isinstance(axis, (list, tuple)) else 2
    ax = axes(axis)
    if axis is None and p == "fro":
        return torch.sqrt(torch.sum(torch.square(x.abs())))
    if p == "fro":
        return torch.sqrt(torch.sum(torch.square(x.abs()), ax,
                                    keepdim=keepdim))
    if _is(p, "inf") or p == float("inf"):
        return torch.amax(x.abs(), ax if ax is not None else (),
                          keepdim=keepdim)
    if _is(p, "-inf") or p == float("-inf"):
        return torch.amin(x.abs(), ax if ax is not None else (),
                          keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), ax if ax is not None
                         else (), keepdim=keepdim)
    if ax is None:
        x, ax = x.reshape(-1), 0
    return torch.pow(torch.sum(torch.pow(x.abs(), p), ax, keepdim=keepdim),
                     1.0 / p)


@register_op("vector_norm")
def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    return torch.linalg.vector_norm(x, ord=p, dim=axes(axis),
                                    keepdim=keepdim)


@register_op("matrix_norm")
def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    return torch.linalg.matrix_norm(x, ord=p, keepdim=keepdim)


@register_op("dist")
def dist(x, y, p=2, name=None):
    d = x - y
    if p == float("inf"):
        return torch.amax(d.abs())
    if p == float("-inf"):
        return torch.amin(d.abs())
    if p == 0:
        return torch.sum(d != 0).to(x.dtype)
    return torch.pow(torch.sum(torch.pow(d.abs(), p)), 1.0 / p)


@register_op("cdist")
def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    d = x[..., :, None, :] - y[..., None, :, :]
    if p == 2.0:
        return torch.sqrt(torch.sum(torch.square(d), -1))
    return torch.pow(torch.sum(torch.pow(d.abs(), p), -1), 1.0 / p)


@register_op("cross")
def cross(x, y, axis=9, name=None):
    if axis == 9:
        # paddle's default: the first dim of size 3
        axis = next(i for i, s in enumerate(x.shape) if s == 3)
    return torch.linalg.cross(x, y, dim=axis)


@register_op("cholesky")
def cholesky(x, upper=False, name=None):
    return torch.linalg.cholesky(x, upper=upper)


@register_op("cholesky_solve")
def cholesky_solve(x, y, upper=False, name=None):
    return torch.cholesky_solve(x, y, upper=upper)


@register_op("qr")
def qr(x, mode="reduced", name=None):
    if mode == "r":
        return torch.linalg.qr(x, mode="r").R
    q, r = torch.linalg.qr(x, mode=mode)
    return q, r


@register_op("svd")
def svd(x, full_matrices=False, name=None):
    u, s, vh = torch.linalg.svd(x, full_matrices=full_matrices)
    return u, s, vh.mH


@register_op("svdvals")
def svdvals(x, name=None):
    return torch.linalg.svdvals(x)


@register_op("svd_lowrank")
def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    u, s, vh = torch.linalg.svd(x, full_matrices=False)
    return u[..., :q], s[..., :q], vh.mT[..., :q]


@register_op("pca_lowrank")
def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    q = q if q is not None else min(6, *x.shape[-2:])
    if center:
        x = x - x.mean(-2, keepdim=True)
    u, s, vh = torch.linalg.svd(x, full_matrices=False)
    return u[..., :q], s[..., :q], vh.mT[..., :q]


@register_op("inverse")
def inverse(x, name=None):
    return torch.linalg.inv(x)


@register_op("pinv")
def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian)


@register_op("det")
def det(x, name=None):
    return torch.linalg.det(x)


@register_op("slogdet")
def slogdet(x, name=None):
    sign, logdet = torch.linalg.slogdet(x)
    return torch.stack([sign, logdet])


@register_op("solve")
def solve(x, y, name=None):
    return torch.linalg.solve(x, y)


@register_op("triangular_solve")
def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    a = x.mT if transpose else x
    return torch.linalg.solve_triangular(
        a, y, upper=(not upper) if transpose else upper,
        unitriangular=unitriangular)


@register_op("lstsq")
def lstsq(x, y, rcond=None, driver=None, name=None):
    """(solution, residuals, rank, singular values), numpy's: the
    minimum-norm solution; the residuals' squared sums when x has full
    column rank and more rows than columns, else empty."""
    m, n = x.shape[-2], x.shape[-1]
    sv = torch.linalg.svdvals(x)
    eps = torch.finfo(sv.dtype).eps
    rc = eps * max(m, n) if rcond is None else rcond
    sol = torch.linalg.pinv(x, rtol=rc) @ y
    rank = (sv > rc * sv.amax(-1, keepdim=True)).sum(-1).to(torch.int32)
    if m > n and bool((rank == n).all()):
        res = torch.sum(torch.square((x @ sol - y).abs()), -2)
    else:
        res = torch.zeros((0,), dtype=sv.dtype, device=x.device)
    return sol, res, rank, sv


@register_op("lu")
def lu(x, pivot=True, get_infos=False, name=None):
    lu_mat, piv, info = torch.linalg.lu_factor_ex(x)
    if get_infos:
        return lu_mat, piv, info
    return lu_mat, piv


@register_op("lu_unpack")
def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    return tuple(torch.lu_unpack(x, y))


@register_op("eig")
def eig(x, name=None):
    w, v = torch.linalg.eig(x)
    return w, v


@register_op("eigh")
def eigh(x, UPLO="L", name=None):
    w, v = torch.linalg.eigh(x, UPLO=UPLO)
    return w, v


@register_op("eigvals")
def eigvals(x, name=None):
    return torch.linalg.eigvals(x)


@register_op("eigvalsh")
def eigvalsh(x, UPLO="L", name=None):
    return torch.linalg.eigvalsh(x, UPLO=UPLO)


@register_op("matrix_power")
def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(x, int(n))


@register_op("matrix_rank")
def matrix_rank(x, tol=None, hermitian=False, atol=None, rtol=None,
                name=None):
    """Legacy `tol` (an absolute threshold) or atol/rtol (threshold
    max(atol, rtol * sigma_max)); by default eps * max(m, n) *
    sigma_max."""
    if tol is not None and (atol is not None or rtol is not None):
        raise ValueError("matrix_rank: pass either tol or atol/rtol")
    x = inexact(x)
    s = torch.linalg.eigvalsh(x).abs() if hermitian else \
        torch.linalg.svdvals(x)
    smax = s.amax(-1)
    if tol is not None:
        thr = torch.full_like(smax, float(tol))
    elif atol is None and rtol is None:
        thr = torch.finfo(s.dtype).eps * max(x.shape[-2], x.shape[-1]) * smax
    else:
        a = torch.full_like(smax, 0.0 if atol is None else float(atol))
        thr = torch.maximum(a, (0.0 if rtol is None else rtol) * smax)
    return torch.sum(s > thr[..., None], -1).to(torch.int64)


@register_op("multi_dot")
def multi_dot(x, name=None):
    return torch.linalg.multi_dot(list(x))


@register_op("corrcoef")
def corrcoef(x, rowvar=True, name=None):
    return torch.corrcoef(x if rowvar else x.T)


@register_op("cov")
def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return torch.cov(x if rowvar or x.dim() < 2 else x.T,
                     correction=1 if ddof else 0, fweights=fweights,
                     aweights=aweights)


@register_op("householder_product")
def householder_product(x, tau, name=None):
    return torch.linalg.householder_product(x, tau)
