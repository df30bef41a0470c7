"""The op surface's case tables and the sweep that runs every op on a
device against the port on the CPU.

    python3 ops_sweep_torch.py [--device cuda]

The tables (``MATH``, ``CREATION``, ``MANIPULATION``, ``REDUCE``,
``LOGIC``, ``ACTIVATION``, ``LINALG``, ``EXTRA``, ``TAIL``, ``FFT``,
``NN`` (``nn.functional``'s ops), ``LEGACY`` (the detection and legacy
ops), ``NNTAIL`` (``nn.functional``'s tail, the rnn op and
``vision.ops``), ``FUSEDINF`` (the fused inference ops) and ``INCUBATE``
(the quantization, MoE and geometric ops): each a namespace of seeded numpy inputs and ``CASES``, rows of (op name,
args, kwargs, options)) are the inputs of the CPU parity tests
(``tests/test_torch_ops_*.py``, which hold the port against the JAX
package) and of ``sweep``, which runs each case through
``paddle_tpu_torch`` on a device and on the CPU and compares them:

- float64 (and complex128) 1e-9 relative, 1e-7 for the special functions
  and the decompositions' own outputs; float32 (and complex64) 1e-4
  relative, 1e-5 absolute, and so for the ops that compute in float32
  whatever their inputs (``FLOAT32_INSIDE``); integers and bools exact;
- the factors unique only up to sign or phase (``svd``, ``qr``,
  ``eig``, ``eigh``, ``svd_lowrank``, ``pca_lowrank``) by their
  reconstruction and their (sorted) values;
- the random ops (``RANDOM``) by shape, dtype and device, and by the
  same draws twice from the same seed on the device.

It imports neither JAX nor ``paddle_tpu``.
"""

from __future__ import annotations

import json
import sys
from types import SimpleNamespace

import numpy as np
import torch

SPECIAL_TOL = (1e-8, 1e-10)


def _math():
    R = np.random.default_rng(1)
    A = R.standard_normal((3, 4))
    B = R.standard_normal((3, 4))
    POS = R.uniform(0.5, 2.0, (3, 4))
    UNIT = R.uniform(-0.9, 0.9, (3, 4))
    BIG = R.uniform(1.1, 3.0, (3, 4))
    A32, B32, POS32 = (v.astype(np.float32) for v in (A, B, POS))
    I32 = R.integers(-5, 6, (3, 4)).astype(np.int32)
    I64 = R.integers(1, 9, (3, 4)).astype(np.int64)
    J32 = R.integers(1, 6, (3, 4)).astype(np.int32)
    ROW = R.standard_normal((4,))
    M = R.standard_normal((4, 4))
    C = (R.standard_normal((3, 4)) + 1j * R.standard_normal((3, 4)))

    UNARY_ANY = ["exp", "expm1", "sin", "cos", "tan", "atan", "sinh", "cosh",
                 "tanh", "asinh", "erf", "square", "abs", "sign", "neg", "floor",
                 "ceil", "trunc", "frac", "rad2deg", "deg2rad", "round"]
    UNARY_POS = ["log", "log2", "log10", "log1p", "sqrt", "rsqrt",
                 "reciprocal", "lgamma", "digamma", "gammaln", "i0", "i0e",
                 "i1", "i1e"]
    UNARY_UNIT = ["asin", "acos", "atanh", "erfinv"]
    SPECIAL = {"lgamma", "digamma", "gammaln", "i0", "i0e", "i1", "i1e",
               "erfinv", "polygamma"}
    NO_GRAD = {"sign", "floor", "ceil", "trunc", "round"}


    F32_UNARY = {"exp", "tanh", "erf", "log", "rsqrt", "lgamma", "asin"}
    GRAD_UNARY = {"exp", "tanh", "frac", "rsqrt", "lgamma", "i0e",
                  "erfinv"}


    def _unary_cases():
        out = []
        for names, x in ((UNARY_ANY, A), (UNARY_POS, POS), (UNARY_UNIT, UNIT)):
            for n in names:
                tol = SPECIAL_TOL if n in SPECIAL else None
                out.append((n, (x,), {}, {"tol": tol, "grad": n in GRAD_UNARY,
                                          "id": "f64"}))
                if n in F32_UNARY:
                    out.append((n, (x.astype(np.float32),), {}, {"id": "f32"}))
        out.append(("acosh", (BIG,), {}, {}))
        for n in ("sqrt", "sin", "abs", "floor"):
            out.append((n, (J32,), {}, {"id": "i32"}))
            out.append((n, (I64,), {}, {"id": "i64"}))
        return out


    BINARY = ["add", "subtract", "multiply", "divide", "maximum", "minimum",
              "fmax", "fmin", "atan2", "logaddexp"]

    CASES = _unary_cases() + [
        *[(n, (A, B), {}, {"grad": n in ("multiply", "divide", "maximum",
                                         "atan2", "logaddexp")})
          for n in BINARY],
        *[(n, (A32, B32), {}, {"id": "f32"}) for n in ("add", "divide",
                                                         "atan2")],
        *[(n, (I32, J32), {}, {"id": "i32"}) for n in
          ("add", "multiply", "divide", "maximum", "floor_divide", "mod",
           "gcd", "lcm")],
        *[(n, (I64, J32), {}, {"id": "i64-i32"}) for n in
          ("add", "divide", "floor_divide", "mod")],
        ("add", (I32, 2.5), {}, {"id": "i32-pyfloat"}),
        ("add", (I32, 2), {}, {"id": "i32-pyint"}),
        ("multiply", (A32, 2), {}, {"id": "f32-pyint"}),
        ("subtract", (A32, 1.5), {}, {"id": "f32-pyfloat"}),
        ("add", (A, ROW), {}, {"id": "bcast"}),
        ("multiply", (np.array([True, False]), 3), {}, {"id": "bool-pyint"}),
        ("floor_divide", (A, POS), {}, {"id": "f64"}),
        ("mod", (A, POS), {}, {"id": "f64"}),
        ("mod", (A, -POS), {}, {"id": "neg-divisor"}),
        ("remainder", (I32, 2.0), {}, {"id": "i32-pyfloat"}),
        ("pow", (POS, B), {}, {"grad": True}),
        ("pow", (POS, 2.0), {}, {"id": "pyfloat"}),
        ("pow", (J32, 3), {}, {"id": "i32-pyint"}),
        ("pow", (J32, 0.5), {}, {"id": "i32-pyfloat"}),
        ("float_power", (POS, B), {}, {}),
        ("float_power", (J32, 2), {}, {"id": "i32"}),
        ("polygamma", (POS, 1), {}, {"tol": SPECIAL_TOL}),
        ("polygamma", (POS, 2), {}, {"tol": SPECIAL_TOL, "id": "n2"}),
        ("clip", (A, -0.5, 0.5), {}, {}),
        ("clip", (A,), {"min": -0.2}, {"id": "min-only"}),
        ("clip", (I32, 0, 2), {}, {"id": "i32"}),
        ("clip", (I32, 0.5, 2.5), {}, {"id": "i32-pyfloat"}),
        ("lerp", (A, B, 0.3), {}, {}),
        ("lerp", (A, B, POS), {}, {"id": "tensor-weight", "grad": True}),
        ("stanh", (A,), {}, {}),
        ("stanh", (I32,), {}, {"id": "i32"}),
        ("logit", (R.uniform(0.1, 0.9, (3, 4)),), {}, {"grad": True}),
        ("logit", (UNIT,), {"eps": 0.2}, {"id": "eps"}),
        ("heaviside", (A, B), {}, {}),
        ("diff", (A,), {}, {}),
        ("diff", (A,), {"n": 2, "axis": 0}, {"id": "n2-axis0"}),
        ("diff", (A,), {"prepend": B, "append": B}, {"id": "pre-app"}),
        ("angle", (C,), {}, {}),
        ("angle", (A,), {}, {"id": "real"}),
        ("conj", (C,), {}, {}),
        ("real", (C,), {}, {}),
        ("imag", (C,), {}, {}),
        ("sgn", (C,), {}, {"id": "complex"}),
        ("sgn", (A,), {}, {"id": "real"}),
        ("nan_to_num", (np.array([np.nan, np.inf, -np.inf, 1.0]),), {}, {}),
        ("nan_to_num", (np.array([np.nan, np.inf, -np.inf, 1.0],
                                 np.float32),),
         {"nan": 2.0, "posinf": 9.0, "neginf": -9.0}, {"id": "values"}),
        ("scale", (A,), {"scale": 2.0, "bias": 0.5}, {}),
        ("scale", (A,), {"scale": 2.0, "bias": 0.5,
                         "bias_after_scale": False}, {"id": "before"}),
        ("scale", (I32,), {"scale": 2.0}, {"id": "i32"}),
        ("increment", (A,), {"value": 2.0}, {}),
        ("increment", (I32,), {}, {"id": "i32"}),
        ("addmm", (M[:3], A, M), {"beta": 0.5, "alpha": 2.0}, {"grad": True}),
        ("inner", (A, B), {}, {}),
        ("outer", (ROW, ROW), {}, {}),
        ("kron", (A[:2, :2], B[:2, :3]), {}, {"grad": True}),
        ("trace", (M,), {}, {}),
        ("trace", (M,), {"offset": 1}, {"id": "offset"}),
        ("trace", (I32[:3, :3],), {}, {"id": "i32"}),
        ("diagonal", (M,), {"offset": -1}, {}),
        ("diagonal", (R.standard_normal((2, 3, 3)),),
         {"axis1": 1, "axis2": 2}, {"id": "batched"}),
        ("cumsum", (A,), {"axis": 1}, {"grad": True}),
        ("cumsum", (A,), {}, {"id": "flat"}),
        ("cumsum", (I32,), {"axis": 0}, {"id": "i32"}),
        ("cumsum", (np.array([True, False, True]),), {}, {"id": "bool"}),
        ("cumsum", (A32,), {"axis": 0, "dtype": "float64"}, {"id": "dtype"}),
        ("cumprod", (POS,), {"dim": 1}, {"grad": True}),
        ("cumprod", (J32,), {"dim": 0}, {"id": "i32"}),
        ("cummax", (A,), {"axis": 1}, {}),
        ("cummax", (np.array([1, 3, 3, 2, 3]),), {}, {"id": "ties"}),
        ("cummin", (A,), {"axis": 0}, {}),
        ("cummin", (np.array([3.0, 1, 1, 2, 1]),), {}, {"id": "ties"}),
        ("logcumsumexp", (A,), {"axis": 1}, {"grad": True}),
        ("logcumsumexp", (A,), {}, {"id": "flat"}),
        ("add_n", ([A, B, POS],), {}, {}),
        ("multiplex", ([A, B], np.array([[1], [0], [1]], np.int32)), {}, {}),
        ("gcd", (np.array([12, -18, 7]), np.array([8, 12, 0])), {}, {"id": "i64"}),
    ]
    return SimpleNamespace(**locals())


def _creation():
    R = np.random.default_rng(2)
    V = R.standard_normal((4,))
    A = R.standard_normal((3, 4))
    RE, IM = R.standard_normal((2, 3)), R.standard_normal((2, 3))

    CASES = [
        ("zeros", ([2, 3],), {}, {}),
        ("zeros", ([2, 3],), {"dtype": "int32"}, {"id": "int32"}),
        ("ones", ((4,),), {"dtype": "float64"}, {}),
        ("full", ([2, 2], 3), {}, {"id": "int-fill"}),
        ("full", ([2], True), {}, {"id": "bool"}),
        ("full", ([2], 1.5), {"dtype": "float64"}, {"id": "f64"}),
        ("empty", ([3],), {}, {}),
        ("zeros_like", (A,), {}, {}),
        ("ones_like", (A,), {"dtype": "int64"}, {"id": "dtype"}),
        ("full_like", (A, 2.5), {}, {}),
        ("empty_like", (A,), {}, {}),
        ("arange", (5,), {}, {}),
        ("arange", (1, 10, 3), {}, {"id": "step"}),
        ("arange", (0, 1, 0.25), {}, {"id": "float"}),
        ("arange", (0, 5), {"dtype": "float64"}, {"id": "dtype"}),
        ("linspace", (0, 1, 5), {}, {}),
        ("linspace", (-2, 3, 7), {"dtype": "float64"}, {"id": "f64"}),
        ("logspace", (0, 2, 5), {}, {}),
        ("logspace", (0, 3, 4), {"base": 2.0, "dtype": "float64"},
         {"id": "base2"}),
        ("eye", (3,), {}, {}),
        ("eye", (2, 4), {"dtype": "int64"}, {"id": "rect"}),
        ("diag", (V,), {}, {}),
        ("diag", (V,), {"offset": 1, "padding_value": 9}, {"id": "pad"}),
        ("diag", (A,), {"offset": -1}, {"id": "matrix"}),
        ("diagflat", (A,), {"offset": 1}, {}),
        ("diag_embed", (A,), {}, {}),
        ("diag_embed", (A,), {"offset": -1}, {"id": "offset"}),
        ("tril", (A,), {}, {}),
        ("tril", (A,), {"diagonal": 1}, {"id": "diag1"}),
        ("triu", (A,), {"diagonal": -1}, {}),
        ("tril_indices", (4, 3), {}, {}),
        ("tril_indices", (4, 4, -1), {}, {"id": "offset"}),
        ("triu_indices", (3,), {}, {}),
        ("triu_indices", (3, 5, 1), {"dtype": "int32"}, {"id": "rect"}),
        ("meshgrid", (V[:2], V[:3]), {}, {}),
        ("meshgrid", ([V[:2], V[:3]],), {}, {"id": "list"}),
        ("assign", (A,), {}, {}),
        ("clone", (A,), {}, {}),
        ("complex", (RE, IM), {}, {}),
        ("polar", (np.abs(RE), IM), {}, {}),
    ]
    return SimpleNamespace(**locals())


def _manipulation():
    R = np.random.default_rng(3)
    A = R.standard_normal((3, 4))
    B = R.standard_normal((3, 4))
    X3 = R.standard_normal((2, 3, 4))
    X4 = R.standard_normal((1, 2, 3, 4))
    I32 = R.integers(0, 5, (3, 4)).astype(np.int32)
    IDX = np.array([2, 0], np.int64)
    IDX_DUP = np.array([1, 1, 0], np.int64)
    MASK = A > 0
    SORTED = np.sort(R.standard_normal(6))
    Z = np.array([0.0, 1.5, 0.0, -2.0])
    C = R.standard_normal((3, 2))

    CASES = [
        ("reshape", (A, [4, 3]), {}, {"grad": True}),
        ("reshape", (A, [2, -1]), {}, {"id": "infer"}),
        ("view", (A, [6, 2]), {}, {}),
        ("view_as", (A, X3[0].T), {}, {}),
        ("transpose", (X3, [2, 0, 1]), {}, {"grad": True}),
        ("moveaxis", (X3, 0, 2), {}, {}),
        ("moveaxis", (X3, [0, 1], [2, 0]), {}, {"id": "multi"}),
        ("swapaxes", (X3, 0, 2), {}, {}),
        ("t", (A,), {}, {}),
        ("t", (A[0],), {}, {"id": "1d"}),
        ("cast", (A, "float32"), {}, {}),
        ("cast", (A, "int32"), {}, {"id": "int"}),
        ("concat", ([A, B],), {"axis": 1}, {"grad": True}),
        ("concat", ([A, B],), {"axis": -2}, {"id": "neg"}),
        ("stack", ([A, B],), {"axis": 1}, {"grad": True}),
        ("split", (A, 2), {"axis": 1}, {"grad": True}),
        ("split", (A, [1, -1, 1]), {"axis": 1}, {"id": "sections"}),
        ("chunk", (A, 3), {}, {}),
        ("unbind", (X3,), {"axis": 1}, {}),
        ("unstack", (X3,), {}, {}),
        ("squeeze", (X4,), {}, {}),
        ("squeeze", (X4, [0, 1]), {}, {"id": "axes"}),
        ("unsqueeze", (A, [0, 3]), {}, {}),
        ("unsqueeze", (A, -1), {}, {"id": "neg"}),
        ("flatten", (X4,), {"start_axis": 1, "stop_axis": 2}, {"grad": True}),
        ("flatten", (X4,), {}, {"id": "all"}),
        ("tile", (A, [2, 1]), {}, {"grad": True}),
        ("tile", (A[0], [2, 2]), {}, {"id": "rank-up"}),
        ("expand", (A[:1], [3, -1]), {}, {"grad": True}),
        ("expand", (A[0], [2, 3, 4]), {}, {"id": "rank-up"}),
        ("expand_as", (A[:1], B), {}, {}),
        ("broadcast_to", (A[0], [2, 4]), {}, {}),
        ("broadcast_tensors", ([A, A[0]],), {}, {}),
        ("flip", (A, 1), {}, {}),
        ("flip", (X3, [0, 2]), {}, {"id": "multi"}),
        ("rot90", (A,), {}, {}),
        ("rot90", (X3,), {"k": 3, "axes": [1, 2]}, {"id": "k3"}),
        ("roll", (A, 1), {}, {}),
        ("roll", (A, [1, -2], [0, 1]), {}, {"id": "axes"}),
        ("gather", (A, IDX), {}, {"grad": True}),
        ("gather", (A, IDX), {"axis": 1}, {"id": "axis1"}),
        ("gather_nd", (X3, np.array([[0, 1], [1, 2]])), {}, {"grad": True}),
        ("scatter", (A, IDX, B[:2]), {}, {"grad": True}),
        ("scatter", (A, IDX_DUP, B), {"overwrite": False}, {"id": "accumulate"}),
        ("scatter_nd_add", (A, np.array([[0, 1], [0, 1], [2, 3]]),
                            np.array([1.0, 2.0, 3.0])), {}, {"id": "dups"}),
        ("scatter_nd", (np.array([[1], [1], [3]]), np.array([1.0, 2, 3]), [5]),
         {}, {}),
        ("index_select", (A, IDX), {"axis": 1}, {"grad": True}),
        ("index_sample", (A, np.array([[0, 3], [1, 1], [2, 0]])), {}, {}),
        ("index_add", (A, IDX_DUP, 0, B), {}, {"grad": True}),
        ("index_put", (A, (np.array([0, 2]), np.array([1, 3])),
                       np.array([5.0, 6.0])), {}, {}),
        ("index_put", (A, (np.array([0, 0]), np.array([1, 1])),
                       np.array([5.0, 6.0])), {"accumulate": True},
         {"id": "accumulate"}),
        ("index_fill", (A, IDX, 1, 7.0), {}, {}),
        ("masked_select", (A, MASK), {}, {}),
        ("masked_fill", (A, MASK, 0.5), {}, {"grad": True}),
        ("masked_scatter", (A, MASK, B), {}, {}),
        ("where", (MASK, A, B), {}, {"grad": True}),
        ("where", (MASK,), {}, {"id": "indices"}),
        ("nonzero", (Z,), {}, {}),
        ("nonzero", (A > 0.5,), {"as_tuple": True}, {"id": "tuple"}),
        ("take_along_axis", (A, np.array([[0], [2], [1]]), 1), {},
         {"grad": True}),
        ("put_along_axis", (A, np.array([[0], [2], [1]]), 9.0, 1), {}, {}),
        ("put_along_axis", (A, np.array([[0, 0], [2, 2], [1, 3]]),
                            np.ones((3, 2)), 1), {"reduce": "add"},
         {"id": "add-dups"}),
        ("put_along_axis", (A, np.array([[0], [2], [1]]), 2.0, 1),
         {"reduce": "mul"}, {"id": "mul"}),
        ("slice", (X3, [0, 2], [1, 1], [2, 3]), {}, {"grad": True}),
        ("strided_slice", (X3, [2], [0], [4], [2]), {}, {}),
        ("strided_slice", (X3, [1, 2], [2, 3], [0, 0], [-1, -2]), {},
         {"id": "negative"}),
        ("crop", (A,), {"shape": [2, 2], "offsets": [1, 1]}, {}),
        ("pad", (X4, [1, 2, 0, 1]), {}, {"grad": True}),
        ("pad", (X4, [1, 1, 2, 2]), {"mode": "reflect"}, {"id": "reflect"}),
        ("pad", (X4, [1, 0, 0, 2]), {"mode": "replicate"},
         {"id": "replicate"}),
        ("pad", (X4, [1, 1, 1, 1]), {"mode": "circular"}, {"id": "circular"}),
        ("pad", (X3, [0, 0, 1, 1, 2, 0]), {"value": 3.0}, {"id": "full-rank"}),
        ("pad", (X4, [1, 2]), {"data_format": "NHWC"}, {"id": "nhwc"}),
        ("getitem", (X3, (slice(None), 1)), {}, {}),
        ("setitem", (A, (0, slice(1, 3)), np.array([7.0, 8.0])), {}, {}),
        ("numel", (X3,), {}, {}),
        ("shape", (X3,), {}, {}),
        ("repeat_interleave", (A, 2), {"axis": 0}, {"grad": True}),
        ("repeat_interleave", (A, 2), {}, {"id": "flat"}),
        ("unique", (I32,), {}, {}),
        ("unique", (I32,), {"return_index": True, "return_inverse": True,
                            "return_counts": True}, {"id": "all"}),
        ("unique", (np.array([[1, 2], [1, 2], [0, 5]]),),
         {"axis": 0, "return_counts": True}, {"id": "axis"}),
        ("unique_consecutive", (np.array([1, 1, 2, 2, 2, 1, 3]),),
         {"return_inverse": True, "return_counts": True}, {}),
        ("searchsorted", (SORTED, A), {}, {}),
        ("searchsorted", (SORTED, A), {"right": True, "out_int32": True},
         {"id": "right"}),
        ("bucketize", (A, SORTED), {}, {}),
        ("as_complex", (C,), {}, {}),
        ("as_real", (C[:, 0] + 1j * C[:, 1],), {}, {}),
        ("tensordot", (X3, R.standard_normal((3, 4, 5))), {"axes": 2},
         {"grad": True}),
        ("tensordot", (A, B), {"axes": [[1], [1]]}, {"id": "lists"}),
        ("atleast_1d", (np.array(3.0),), {}, {}),
        ("vstack", ([A, B],), {}, {}),
        ("hstack", ([A, B],), {}, {}),
        ("dstack", ([A, B],), {}, {}),
        ("column_stack", ([A[0], B[0]],), {}, {}),
        ("row_stack", ([A, B],), {}, {}),
    ]
    return SimpleNamespace(**locals())


def _reduce():
    R = np.random.default_rng(4)
    A = R.standard_normal((3, 4))
    A32 = A.astype(np.float32)
    X3 = R.standard_normal((2, 3, 4))
    I32 = R.integers(-3, 4, (3, 4)).astype(np.int32)
    TIES = np.array([[3.0, 1.0, 3.0, 2.0, 1.0], [0.0, 0.0, 5.0, 5.0, 1.0]])
    NANS = np.array([[1.0, np.nan, 3.0, 2.0], [np.nan, np.nan, np.nan, 1.0]])
    BOOL = A > 0
    PTS = R.standard_normal((50, 2))

    CASES = [
        ("sum", (A,), {}, {"grad": True}),
        ("sum", (X3,), {"axis": [0, 2], "keepdim": True}, {"id": "axes"}),
        ("sum", (I32,), {"axis": 1}, {"id": "i32"}),
        ("sum", (BOOL,), {}, {"id": "bool"}),
        ("sum", (A32,), {"dtype": "float64"}, {"id": "dtype"}),
        ("mean", (A,), {"axis": 0}, {"grad": True}),
        ("mean", (I32,), {}, {"id": "i32"}),
        ("max", (A,), {"axis": 1}, {"grad": True}),
        ("max", (A,), {}, {"id": "all"}),
        ("min", (X3,), {"axis": [1, 2], "keepdim": True}, {}),
        ("amax", (A,), {"axis": -1}, {}),
        ("amin", (I32,), {}, {}),
        ("prod", (A,), {"axis": 1}, {"grad": True}),
        ("prod", (I32,), {}, {"id": "i32"}),
        ("prod", (X3,), {"axis": [0, 2]}, {"id": "axes"}),
        ("std", (A,), {"axis": 1}, {"grad": True}),
        ("std", (A,), {"unbiased": False}, {"id": "biased"}),
        ("var", (X3,), {"axis": [0, 1], "keepdim": True}, {"grad": True}),
        ("var", (I32,), {}, {"id": "i32"}),
        ("median", (A,), {"axis": 1}, {"grad": True}),
        ("median", (TIES,), {}, {"id": "even"}),
        ("median", (TIES,), {"axis": 1, "mode": "min"}, {"id": "min"}),
        ("median", (A,), {"mode": "min", "keepdim": True}, {"id": "min-all"}),
        ("nanmedian", (NANS,), {"axis": 1}, {}),
        ("nansum", (NANS,), {"axis": 1}, {}),
        ("nanmean", (NANS,), {"axis": 1}, {}),
        ("quantile", (A,), {"q": 0.3, "axis": 1}, {"grad": True}),
        ("quantile", (A,), {"q": [0.1, 0.9]}, {"id": "list"}),
        ("quantile", (X3,), {"q": 0.5, "axis": [0, 2], "keepdim": True},
         {"id": "axes"}),
        ("quantile", (A,), {"q": 0.4, "axis": 0,
                            "interpolation": "nearest"}, {"id": "nearest"}),
        ("nanquantile", (NANS[:1],), {"q": 0.5, "axis": 1}, {}),
        ("all", (BOOL,), {"axis": 0}, {}),
        ("any", (BOOL,), {}, {}),
        ("count_nonzero", (I32,), {"axis": 1}, {}),
        ("logsumexp", (A,), {"axis": 1}, {"grad": True}),
        ("logsumexp", (I32,), {}, {"id": "i32"}),
        ("argmax", (A,), {"axis": 1}, {}),
        ("argmax", (TIES,), {}, {"id": "ties"}),
        ("argmin", (A,), {"axis": 0, "keepdim": True}, {}),
        ("argsort", (TIES,), {}, {}),
        ("argsort", (TIES,), {"descending": True}, {"id": "desc"}),
        ("argsort", (TIES,), {"axis": 0, "stable": True}, {"id": "axis0"}),
        ("sort", (A,), {"axis": 0}, {"grad": True}),
        ("sort", (TIES,), {"descending": True}, {"id": "desc"}),
        ("topk", (TIES, 3), {}, {}),
        ("topk", (A, 2), {"axis": 0, "largest": False}, {"id": "smallest"}),
        ("kthvalue", (TIES, 2), {}, {}),
        ("kthvalue", (A, 2), {"axis": 0, "keepdim": True}, {"id": "keepdim"}),
        ("mode", (TIES,), {}, {}),
        ("mode", (np.array([[1, 2, 2, 3, 3], [4, 4, 1, 1, 0]]),),
         {"keepdim": True}, {"id": "int-ties"}),
        ("histogram", (A,), {"bins": 5}, {}),
        ("histogram", (A,), {"bins": 4, "min": -1, "max": 1}, {"id": "range"}),
        ("histogram", (A,), {"bins": 4, "weight": np.abs(A).reshape(-1), "density": True},
         {"id": "weighted-density"}),
        ("histogramdd", (PTS,), {"bins": [3, 4]}, {}),
        ("histogramdd", (PTS,), {"bins": 2, "ranges": [[-1.0, 1.0], [-2.0, 2.0]],
                                 "density": True}, {"id": "ranges"}),
        ("bincount", (np.array([0, 1, 1, 3, 5]),), {}, {}),
        ("bincount", (np.array([0, 1, 1, 3]),),
         {"weights": np.array([0.5, 1.0, 2.0, 1.5]), "minlength": 6},
         {"id": "weights"}),
    ]
    return SimpleNamespace(**locals())


def _logic():
    R = np.random.default_rng(5)
    A = np.round(R.standard_normal((3, 4)), 1)
    B = np.round(R.standard_normal((3, 4)), 1)
    B[0] = A[0]
    I = R.integers(0, 16, (3, 4)).astype(np.int32)
    J = R.integers(0, 4, (3, 4)).astype(np.int32)
    P = A > 0
    Q = B > 0
    SPECIAL = np.array([1.0, np.nan, np.inf, -np.inf, 0.0])

    CMP = ["equal", "not_equal", "greater_than", "greater_equal", "less_than",
           "less_equal"]

    CASES = [
        *[(n, (A, B), {}, {}) for n in CMP],
        ("equal", (I, 3), {}, {"id": "scalar"}),
        ("less_than", (A, 0.0), {}, {"id": "pyfloat"}),
        ("equal_all", (A, A.copy()), {}, {}),
        ("equal_all", (A, B), {}, {"id": "differ"}),
        ("equal_all", (A, A[:2]), {}, {"id": "shape"}),
        *[(n, (P, Q), {}, {}) for n in ("logical_and", "logical_or",
                                        "logical_xor")],
        ("logical_not", (P,), {}, {}),
        ("logical_and", (I, J), {}, {"id": "int"}),
        *[(n, (I, J), {}, {}) for n in ("bitwise_and", "bitwise_or",
                                        "bitwise_xor", "bitwise_left_shift",
                                        "bitwise_right_shift")],
        ("bitwise_not", (I,), {}, {}),
        ("bitwise_and", (P, Q), {}, {"id": "bool"}),
        *[(n, (SPECIAL,), {}, {}) for n in ("isnan", "isinf", "isfinite",
                                            "isposinf", "isneginf", "isreal")],
        ("isreal", (A + 1j * (A > 0),), {}, {"id": "complex"}),
        ("isclose", (A, A + 1e-9), {}, {}),
        ("isclose", (SPECIAL, SPECIAL), {"equal_nan": True}, {"id": "nan"}),
        ("allclose", (A, A + 1e-3), {"atol": 1e-2}, {}),
        ("allclose", (A, B), {}, {"id": "false"}),
        ("is_empty", (A,), {}, {}),
        ("is_empty", (np.zeros((0, 2)),), {}, {"id": "empty"}),
        ("isin", (I, np.array([1, 3, 5], np.int32)), {}, {}),
        ("isin", (I, np.array([1, 3, 5], np.int32)), {"invert": True},
         {"id": "invert"}),
    ]
    return SimpleNamespace(**locals())


def _activation():
    R = np.random.default_rng(6)
    A = R.standard_normal((3, 4)) * 2
    X4 = R.standard_normal((2, 4, 3, 2))
    W1 = R.uniform(0.1, 0.3, (4,))


    def f32(*shape, scale=1.0):
        return (R.standard_normal(shape) * scale).astype(np.float32)


    ACTS = ["relu", "relu6", "sigmoid", "silu", "swish", "hardswish",
            "hardsigmoid", "hardtanh", "hardshrink", "softshrink", "tanhshrink",
            "leaky_relu", "elu", "selu", "celu", "mish", "softplus", "softsign",
            "log_sigmoid"]

    GRAD_ACTS = {"silu", "selu", "mish", "softplus"}

    B, S, H, D = 2, 5, 4, 8
    HID, FFN, V = 16, 24, 40
    Q, K = f32(B, S, H, D), f32(B, S, 2, D)
    ANG = R.standard_normal((S, D // 2)).astype(np.float32)
    COS = np.cos(np.concatenate([ANG, ANG], -1)).astype(np.float32)
    SIN = np.sin(np.concatenate([ANG, ANG], -1)).astype(np.float32)
    XH = f32(6, HID)
    PAGES_K, PAGES_V = f32(6, 4, 2, D), f32(6, 4, 2, D)
    TABLES = np.array([[0, 2, 4], [1, 3, 5]], np.int32)
    CTX = np.array([9, 5], np.int32)
    CACHE_K, CACHE_V = f32(B, 7, 2, D), f32(B, 7, 2, D)
    FUSED_TOL = (1e-5, 1e-6)

    CASES = [
        *[(n, (A,), {}, {"grad": n in GRAD_ACTS}) for n in ACTS],
        ("gelu", (A,), {}, {"grad": True}),
        ("gelu", (A,), {"approximate": True}, {"id": "tanh", "grad": True}),
        ("hardtanh", (A,), {"min": -0.5, "max": 2.0}, {"id": "bounds"}),
        ("thresholded_relu", (A,), {"threshold": 0.5, "value": -1.0}, {}),
        ("leaky_relu", (A,), {"negative_slope": 0.2}, {"id": "slope"}),
        ("elu", (A,), {"alpha": 0.5}, {"id": "alpha"}),
        ("softplus", (A,), {"beta": 2, "threshold": 3}, {"id": "beta"}),
        ("prelu", (X4, W1[:4]), {}, {"grad": True}),
        ("prelu", (X4, W1[:1]), {}, {"id": "scalar-weight"}),
        ("prelu", (X4, W1[:2]), {"data_format": "NHWC"}, {"id": "nhwc"}),
        ("rrelu", (A,), {}, {"id": "eval"}),
        ("softmax", (A,), {"axis": 0}, {"grad": True}),
        ("softmax", (A.astype(np.float32),), {"dtype": "float64"},
         {"id": "dtype"}),
        ("log_softmax", (A,), {}, {"grad": True}),
        ("maxout", (X4,), {"groups": 2}, {}),
        ("glu", (A,), {}, {"grad": True}),
        ("relu", (A.astype(np.float32),), {}, {"id": "f32"}),
        # the fused names
        ("swiglu", (f32(6, FFN), f32(6, FFN)), {}, {"tol": FUSED_TOL,
                                                     "grad": True}),
        ("swiglu", (f32(6, 2 * FFN),), {}, {"tol": FUSED_TOL, "id": "split"}),
        ("fused_rms_norm", (f32(6, HID), f32(HID) + 1.0), {"epsilon": 1e-5},
         {"tol": FUSED_TOL, "grad": True}),
        ("fused_rope", (Q, COS, SIN), {}, {"tol": FUSED_TOL, "grad": True,
                                           "diff": (0,)}),
        ("fused_rotary_position_embedding", (Q, K),
         {"sin": SIN, "cos": COS}, {"tol": FUSED_TOL}),
        ("fused_rotary_position_embedding", (Q,),
         {"sin": SIN[None, :, None], "cos": COS[None, :, None]},
         {"tol": FUSED_TOL, "id": "q-only-4d"}),
        ("fused_linear", (XH, f32(HID, FFN), f32(FFN)), {},
         {"tol": FUSED_TOL, "grad": True}),
        ("fused_linear", (XH, f32(FFN, HID)), {"transpose_weight": True},
         {"tol": FUSED_TOL, "id": "transposed"}),
        ("fused_bias_act", (f32(6, FFN), f32(FFN)), {}, {"tol": FUSED_TOL}),
        ("fused_bias_act", (f32(6, FFN),), {"act_method": "swiglu"},
         {"tol": FUSED_TOL, "id": "swiglu"}),
        ("fused_linear_param_grad_add", (f32(2, 3, HID), f32(2, 3, FFN),
                                         f32(HID, FFN), f32(FFN)), {},
         {"tol": (1e-5, 1e-5)}),
        ("fused_bias_dropout_residual_layer_norm",
         (XH, f32(6, HID), f32(HID), f32(HID) + 1.0, f32(HID)),
         {"dropout_rate": 0.0}, {"tol": FUSED_TOL, "grad": True}),
        ("fused_bias_dropout_residual_layer_norm", (XH, f32(6, HID)),
         {"training": False}, {"tol": FUSED_TOL, "id": "eval-defaults"}),
        ("fused_feedforward", (f32(2, 3, HID), f32(HID, FFN), f32(FFN, HID),
                               f32(FFN), f32(HID)),
         {"dropout1_rate": 0.0, "dropout2_rate": 0.0, "activation": "gelu"},
         {"tol": (2e-5, 2e-5)}),
        ("fused_feedforward", (f32(2, 3, HID), f32(HID, 2 * FFN),
                               f32(FFN, HID)),
         {"dropout1_rate": 0.0, "dropout2_rate": 0.0, "activation": "swiglu",
          "pre_layer_norm": True}, {"tol": (2e-5, 2e-5), "id": "pre-swiglu"}),
        ("block_multihead_attention", (f32(B, H, D), PAGES_K, PAGES_V, TABLES,
                                       CTX), {}, {"tol": FUSED_TOL}),
        ("masked_multihead_attention", (f32(B, 1, H, D), CACHE_K, CACHE_V, 5),
         {}, {"tol": FUSED_TOL}),
        ("fused_linear_cross_entropy", (XH, f32(HID, V),
                                        np.array([1, 5, -100, 39, 0, 7])), {},
         {"tol": FUSED_TOL, "grad": True}),
    ]
    return SimpleNamespace(**locals())


def _linalg():
    R = np.random.default_rng(7)
    A = R.standard_normal((4, 4))
    B = R.standard_normal((4, 3))
    SPD = A @ A.T + 4 * np.eye(4)
    TALL = R.standard_normal((5, 3))
    X3 = R.standard_normal((2, 4, 4))
    V = R.standard_normal((4,))
    TRI = np.triu(A) + 3 * np.eye(4)
    DEC = (1e-8, 1e-10)

    CASES = [
        ("matmul", (A, B), {}, {"grad": True}),
        ("matmul", (A, B[:, :1].T), {"transpose_y": True}, {"id": "tT"}),
        ("matmul", (B, A), {"transpose_x": True}, {"id": "xT"}),
        ("matmul", (X3, V), {}, {"id": "batched-vec"}),
        ("mm", (A, B), {}, {}),
        ("bmm", (X3, X3), {}, {"grad": True}),
        ("dot", (V, V), {}, {"grad": True}),
        ("dot", (A, A), {}, {"id": "rows"}),
        ("mv", (A, V), {}, {}),
        ("einsum", ("ij,jk->ik", A, B), {}, {"grad": True}),
        ("einsum", ("bij->bji", X3), {}, {"id": "transpose"}),
        ("norm", (A,), {}, {"grad": True}),
        ("norm", (A,), {"p": 1, "axis": 1}, {"id": "p1"}),
        ("norm", (A,), {"p": float("inf"), "axis": 0}, {"id": "inf"}),
        ("norm", (V,), {"p": 3}, {"id": "p3"}),
        ("norm", (A,), {"p": 0, "axis": 1}, {"id": "p0"}),
        ("norm", (X3,), {"p": "fro", "axis": [1, 2], "keepdim": True},
         {"id": "fro-axes"}),
        ("vector_norm", (A,), {"p": 2.0, "axis": 1}, {"grad": True}),
        ("vector_norm", (A,), {"p": float("inf")}, {"id": "inf"}),
        ("matrix_norm", (A,), {}, {"grad": True}),
        ("matrix_norm", (X3,), {"p": 1}, {"id": "p1"}),
        ("matrix_norm", (A,), {"p": "nuc"}, {"id": "nuc", "tol": DEC}),
        ("dist", (A, A.T), {}, {"grad": True}),
        ("dist", (A, A.T), {"p": float("inf")}, {"id": "inf"}),
        ("cdist", (TALL, B), {}, {"grad": True}),
        ("cdist", (TALL, B), {"p": 1.0}, {"id": "p1"}),
        ("cross", (R.standard_normal((3, 4)), R.standard_normal((3, 4))), {},
         {"grad": True}),
        ("cross", (B, B[::-1].copy()), {"axis": 1}, {"id": "axis1"}),
        ("cholesky", (SPD,), {}, {"grad": True, "tol": DEC}),
        ("cholesky", (SPD,), {"upper": True}, {"id": "upper", "tol": DEC}),
        ("cholesky_solve", (B, np.linalg.cholesky(SPD)), {}, {"tol": DEC}),
        ("svdvals", (TALL,), {}, {"tol": DEC}),
        ("inverse", (SPD,), {}, {"grad": True, "tol": DEC}),
        ("pinv", (TALL,), {}, {"tol": DEC}),
        ("det", (A,), {}, {"grad": True, "tol": DEC}),
        ("slogdet", (A,), {}, {"tol": DEC}),
        ("solve", (SPD, B), {}, {"grad": True, "tol": DEC}),
        ("triangular_solve", (TRI, B), {}, {"tol": DEC}),
        ("triangular_solve", (TRI.T.copy(), B), {"upper": False},
         {"id": "lower", "tol": DEC}),
        ("triangular_solve", (TRI, B), {"transpose": True},
         {"id": "transpose", "tol": DEC}),
        ("lu", (A,), {}, {"tol": DEC}),
        ("lu", (A,), {"get_infos": True}, {"id": "infos", "tol": DEC}),
        ("eigvalsh", (SPD,), {}, {"tol": DEC}),
        ("matrix_power", (A, 3), {}, {"tol": DEC}),
        ("matrix_power", (SPD, -1), {}, {"id": "inverse", "tol": DEC}),
        ("matrix_rank", (TALL @ TALL.T,), {}, {}),
        ("matrix_rank", (A,), {"tol": 0.5}, {"id": "tol"}),
        ("matrix_rank", (SPD,), {"hermitian": True, "rtol": 0.2},
         {"id": "hermitian-rtol"}),
        ("multi_dot", ([A, B, B.T],), {}, {"grad": True}),
        ("corrcoef", (B,), {}, {"tol": DEC}),
        ("corrcoef", (B,), {"rowvar": False}, {"id": "cols", "tol": DEC}),
        ("cov", (B,), {}, {}),
        ("cov", (B,), {"rowvar": False, "ddof": False}, {"id": "cols"}),
        ("svd_lowrank", (TALL,), {"q": 2}, {"id": "values"}),
    ]
    return SimpleNamespace(**locals())


def _extra():
    R = np.random.default_rng(8)
    A = R.standard_normal((3, 4))
    B = R.standard_normal((3, 4))
    POS = R.uniform(0.5, 3.0, (3, 4))
    A32 = A.astype(np.float32)
    IDS = R.integers(0, 20, (4, 3)).astype(np.int64)
    T, BEAM = 4, 3
    TREE_IDS = R.integers(0, 9, (T, 2, BEAM)).astype(np.int64)
    TREE_PAR = R.integers(0, BEAM, (T, 2, BEAM)).astype(np.int64)

    CASES = [
        ("copysign", (A, B), {}, {"grad": True}),
        ("nextafter", (A, B), {}, {}),
        ("gammaincc", (POS, POS[::-1].copy()), {}, {"tol": SPECIAL_TOL}),
        ("sinc", (A,), {}, {"grad": True}),
        ("ldexp", (A, np.array([[1, -2, 3, 0]] * 3)), {}, {}),
        ("hypot", (A, B), {}, {"grad": True}),
        ("p_norm", (A,), {}, {}),
        ("p_norm", (A32,), {"porder": 3.0, "axis": 1, "keepdim": True},
         {"id": "p3"}),
        ("p_norm", (A,), {"porder": float("inf"), "axis": 0}, {"id": "inf"}),
        ("p_norm", (A,), {"porder": 0, "axis": 1}, {"id": "p0"}),
        ("frobenius_norm", (A,), {}, {"grad": True}),
        ("frobenius_norm", (A,), {"axis": 1, "keepdim": True}, {"id": "axis"}),
        ("squared_l2_norm", (A,), {}, {"grad": True}),
        ("clip_by_norm", (A32, 1.0), {}, {}),
        ("clip_by_norm", (A32, 100.0), {}, {"id": "unclipped"}),
        ("renorm", (A32, 2.0, 0, 1.0), {}, {}),
        ("fill", (A, 2.5), {}, {}),
        ("fill_diagonal", (A, 9.0), {}, {}),
        ("fill_diagonal", (A, 9.0), {"offset": 1}, {"id": "offset"}),
        ("fill_diagonal", (np.zeros((7, 3)), 1.0), {"wrap": True},
         {"id": "wrap"}),
        ("fill_diagonal", (np.zeros((3, 3, 3)), 2.0), {}, {"id": "3d"}),
        ("fill_diagonal_tensor", (np.zeros((3, 4)), np.array([1.0, 2, 3])), {},
         {}),
        ("fill_diagonal_tensor", (np.zeros((2, 4, 3)),
                                  np.ones((2, 2))), {"offset": 1, "dim1": 1,
                                                     "dim2": 2},
         {"id": "dims"}),
        ("shard_index", (IDS, 20, 2, 1), {}, {}),
        ("shard_index", (IDS, 20, 3, 0), {"ignore_value": -7}, {"id": "ignore"}),
        ("sequence_mask", (np.array([1, 3, 0, 2]),), {}, {}),
        ("sequence_mask", (np.array([1, 3]),), {"maxlen": 5,
                                                 "dtype": "bool"},
         {"id": "maxlen"}),
        ("as_strided", (A, [2, 2], [4, 1], 1), {}, {}),
        ("tensor_unfold", (R.standard_normal((2, 7)), 1, 3, 2), {}, {}),
        ("view_dtype", (A32, "int32"), {}, {}),
        ("reverse", (A, [0, 1]), {}, {}),
        ("mean_all", (A,), {}, {}),
        ("gather_tree", (TREE_IDS, TREE_PAR), {}, {}),
        ("edit_distance", (np.array([[1, 2, 3, 0], [4, 4, 4, 4]]),
                           np.array([[1, 3, 3], [4, 5, 4]])),
         {"hypslength": np.array([3, 4]), "refslength": np.array([3, 2])}, {}),
        ("edit_distance", (np.array([[1, 2], [3, 3]]),
                           np.array([[2, 1], [3, 3]])), {"normalized": False},
         {"id": "raw"}),
        ("l1_norm", (A,), {}, {"grad": True}),
        ("identity_loss", (A,), {"reduction": "mean"}, {}),
        ("identity_loss", (A,), {"reduction": 0}, {"id": "sum"}),
        ("set_value_with_tensor", (A, np.ones((1, 2)), [1, 0], [2, 4], [1, 2],
                                   [0, 1]), {}, {}),
        ("conv2d_transpose_bias", (R.standard_normal((1, 2, 4, 4)),
                                   R.standard_normal((2, 3, 3, 3)),
                                   R.standard_normal(3)),
         {"strides": [2, 2], "paddings": [1, 1]}, {}),
        ("conv2d_transpose_bias", (R.standard_normal((1, 4, 4, 2)),
                                   R.standard_normal((2, 2, 2, 2)),
                                   R.standard_normal(4)),
         {"groups": 2, "data_format": "NHWC"}, {"id": "nhwc-groups"}),
    ]
    return SimpleNamespace(**locals())


def _tail():
    R = np.random.default_rng(9)
    A = R.standard_normal((3, 4))
    X3 = R.standard_normal((2, 3, 4))
    V = R.standard_normal((4,))
    POS = R.uniform(0.5, 3.0, (3, 4))

    CASES = [
        ("block_diag", ([A[:2, :2], A[:1], V[:3]],), {}, {}),
        ("cartesian_prod", ([V[:2], V[:3]],), {}, {}),
        ("cartesian_prod", ([V[:3]],), {}, {"id": "one"}),
        ("combinations", (V,), {}, {}),
        ("combinations", (V[:3],), {"r": 3, "with_replacement": True},
         {"id": "replacement"}),
        ("trapezoid", (A,), {}, {"grad": True}),
        ("trapezoid", (A,), {"dx": 0.5, "axis": 0}, {"id": "dx"}),
        ("trapezoid", (A,), {"x": np.sort(V)}, {"id": "x"}),
        ("cumulative_trapezoid", (A,), {"dx": 2.0}, {}),
        ("cumulative_trapezoid", (A,), {"x": np.sort(V)}, {"id": "x"}),
        ("diagonal_scatter", (A, V[:3]), {}, {"grad": True}),
        ("diagonal_scatter", (A, V[:3]), {"offset": 1}, {"id": "offset"}),
        ("select_scatter", (X3, A, 0, 1), {}, {}),
        ("slice_scatter", (A, np.ones((3, 2)), [1], [0], [4], [2]), {}, {}),
        ("frexp", (A * 100,), {}, {}),
        ("gammainc", (POS, POS[::-1].copy()), {}, {"tol": SPECIAL_TOL}),
        ("multigammaln", (POS + 2, 3), {}, {"tol": SPECIAL_TOL}),
        ("histogram_bin_edges", (A,), {"bins": 5}, {}),
        ("histogram_bin_edges", (A,), {"bins": 4, "min": -1, "max": 2},
         {"id": "range"}),
        ("pdist", (R.standard_normal((4, 3)),), {}, {"grad": True}),
        ("pdist", (R.standard_normal((4, 3)),), {"p": 1.0}, {"id": "p1"}),
        ("signbit", (np.array([-1.0, 0.0, -0.0, 2.0]),), {}, {}),
        ("vander", (V,), {}, {}),
        ("vander", (V,), {"n": 3, "increasing": True}, {"id": "increasing"}),
        ("unflatten", (A, 1, [2, 2]), {}, {}),
        ("take", (A, np.array([0, 5, -1])), {}, {"grad": True}),
        ("take", (A, np.array([0, 15, -14])), {"mode": "wrap"}, {"id": "wrap"}),
        ("take", (A, np.array([0, 15, -14])), {"mode": "clip"}, {"id": "clip"}),
        ("reduce_as", (X3, A[:1]), {}, {"grad": True}),
        ("reduce_as", (X3, V), {}, {"id": "rank"}),
    ]
    return SimpleNamespace(**locals())


def _fft():
    R = np.random.default_rng(10)
    A = R.standard_normal((4, 6))
    X3 = R.standard_normal((2, 4, 6))
    C = R.standard_normal((4, 6)) + 1j * R.standard_normal((4, 6))
    SIG = R.standard_normal((2, 40))
    FFT = ("fft", "fft")
    SIGNAL = ("signal", "signal")

    CASES = [
        ("fft", (A,), {}, {"grad": True}),
        ("fft", (C,), {"n": 8, "axis": 0, "norm": "ortho"}, {"id": "n-axis"}),
        ("ifft", (C,), {}, {}),
        ("fft2", (X3,), {}, {}),
        ("ifft2", (C,), {"norm": "forward"}, {}),
        ("fftn", (X3,), {"axes": [0, 2]}, {}),
        ("ifftn", (C,), {"s": [4, 4]}, {}),
        ("rfft", (A,), {}, {"grad": True}),
        ("rfft", (A.astype(np.float32),), {"n": 10}, {"id": "f32"}),
        ("irfft", (C,), {}, {}),
        ("irfft", (C,), {"n": 9}, {"id": "n"}),
        ("rfft2", (X3,), {}, {}),
        ("irfft2", (C,), {}, {}),
        ("rfftn", (X3,), {}, {}),
        ("irfftn", (C,), {"s": [4, 8]}, {}),
        ("hfft", (C,), {}, {}),
        ("ihfft", (A,), {}, {}),
        ("fftshift", (A,), {}, {}),
        ("fftshift", (A,), {"axes": [1]}, {"id": "axes"}),
        ("ifftshift", (X3,), {"axes": [0, 2]}, {}),
    ]

    SIGNAL_CASES = [
        ("frame", (SIG, 8, 4), {}, {}),
        ("frame", (R.standard_normal((40, 3)), 10, 5), {"axis": 0},
         {"id": "axis0"}),
        ("overlap_add", (R.standard_normal((2, 8, 9)), 4), {}, {}),
        ("stft", (SIG, 16), {}, {}),
        ("stft", (SIG, 16), {"hop_length": 5, "window": np.hanning(12),
                             "center": False, "normalized": True},
         {"id": "window"}),
        ("stft", (SIG, 16), {"onesided": False, "pad_mode": "constant"},
         {"id": "twosided"}),
    ]
    return SimpleNamespace(**locals())

def _nn():
    """nn.functional's ops (conv, pooling, norms, common, losses,
    attention)."""
    R = np.random.default_rng(15)

    def f64(*shape, scale=1.0):
        return R.standard_normal(shape) * scale

    def f32(*shape, scale=1.0):
        return f64(*shape, scale=scale).astype(np.float32)

    CONV_TOL = (1e-4, 1e-5)
    F32_TOL = (1e-5, 1e-6)
    X1, X2, X3 = f64(2, 3, 9), f64(2, 3, 8, 8), f64(1, 2, 5, 5, 5)
    W1, W2, W3 = f64(4, 3, 3), f64(4, 3, 3, 3), f64(3, 2, 3, 3, 3)
    B4 = f64(4)
    IMG = f64(2, 3, 7, 7)
    POS = R.uniform(0.2, 2.0, (2, 3, 6, 6))
    # pooled values and their argmax offsets for the unpools
    UNPOOL_IDX = np.array([[[[0, 3], [9, 14]], [[5, 2], [13, 15]]]],
                          np.int64)
    UNPOOL3_IDX = np.array([[[[[0, 3], [10, 15]], [[16, 19], [60, 63]]]]],
                           np.int64)
    LOGITS = f64(6, 5)
    LABELS = R.integers(0, 5, (6,)).astype(np.int64)
    LABELS_IGN = LABELS.copy()
    LABELS_IGN[2] = -100
    PROB = R.uniform(0.05, 0.95, (6, 5))
    BIN = (R.uniform(size=(6, 5)) > 0.5).astype(np.float64)
    LOGP4 = np.log(np.exp(f64(2, 4, 3, 3)) / np.exp(
        f64(2, 4, 3, 3)).sum(1, keepdims=True))
    LAB4 = R.integers(0, 4, (2, 3, 3)).astype(np.int64)
    SOFT = PROB / PROB.sum(-1, keepdims=True)
    SIGN = np.where(R.uniform(size=(6,)) > 0.5, 1.0, -1.0)
    CTC_LOGP = f64(8, 2, 5)
    CTC_LAB = np.array([[1, 2, 2], [3, 1, 0]], np.int64)
    CTC_IN = np.array([8, 6], np.int64)
    CTC_LL = np.array([3, 2], np.int64)
    RNNT_IN = f32(2, 4, 3, 5)
    RNNT_LAB = np.array([[1, 3], [2, 0]], np.int32)
    RNNT_TL = np.array([4, 3], np.int32)
    RNNT_UL = np.array([2, 1], np.int32)
    B, S, H, D = 2, 6, 4, 8
    Q, K, V = f32(B, S, H, D), f32(B, S, 2, D), f32(B, S, 2, D)
    FLASHMASK = np.array([[[[4], [5], [6], [6], [6], [6]]]] * B, np.int32)
    PAGES_K, PAGES_V = f32(6, 4, 2, D), f32(6, 4, 2, D)
    TABLES = np.array([[0, 2, 4], [1, 3, 5]], np.int32)
    CTX = np.array([9, 5], np.int32)
    MASK = np.where(R.uniform(size=(B, H, S, S)) > 0.3, 0.0,
                    -1e4).astype(np.float32)
    THETA = f64(2, 2, 3, scale=0.5) + np.array([[1, 0, 0], [0, 1, 0]])
    GRID = np.tanh(f64(2, 4, 5, 2)) * 1.2

    CASES = [
        # conv
        ("conv1d", (X1, W1, B4), {"padding": 1}, {"grad": True}),
        ("conv1d", (np.moveaxis(X1, 1, 2).copy(), W1), {
            "stride": 2, "padding": "SAME", "data_format": "NLC"},
         {"id": "nlc-same"}),
        ("conv2d", (X2, W2, B4), {"padding": 1}, {"grad": True}),
        ("conv2d", (X2, W2), {"stride": 2, "padding": "SAME",
                              "dilation": 2}, {"id": "same-dilated"}),
        ("conv2d", (X2, f64(6, 1, 3, 3)), {"padding": "VALID", "groups": 3},
         {"id": "valid-groups"}),
        ("conv2d", (np.moveaxis(X2, 1, 3).copy(), W2, B4), {
            "padding": [1, 0, 2, 1], "data_format": "NHWC"},
         {"id": "nhwc-per-side", "grad": True}),
        ("conv2d", (X2.astype(np.float32), W2.astype(np.float32)),
         {"padding": 1}, {"id": "f32", "tol": CONV_TOL}),
        ("conv3d", (X3, W3), {"padding": 1}, {"grad": True}),
        ("conv1d_transpose", (f64(2, 4, 5), f64(4, 3, 3), f64(3)),
         {"stride": 2, "padding": 1, "output_padding": 1}, {"grad": True}),
        ("conv2d_transpose", (f64(2, 4, 5, 5), f64(4, 3, 3, 3)),
         {"stride": 2, "padding": 1}, {"grad": True}),
        ("conv2d_transpose", (f64(2, 4, 5, 5), f64(4, 2, 3, 3)),
         {"stride": 2, "padding": 1, "groups": 2, "output_size": [10, 11]},
         {"id": "groups-output-size"}),
        ("conv2d_transpose", (f64(2, 4, 5, 5), f64(4, 3, 3, 3)),
         {"stride": 2, "padding": [1, 0, 0, 1]},
         {"id": "per-side", "grad": True}),
        ("conv2d_transpose", (f64(2, 4, 5, 5), f64(4, 3, 3, 3)),
         {"stride": 2, "padding": "SAME"}, {"id": "same"}),
        ("conv2d_transpose", (np.moveaxis(f64(2, 4, 5, 5), 1, 3).copy(),
                              f64(4, 3, 2, 2), f64(3)),
         {"stride": 2, "data_format": "NHWC"}, {"id": "nhwc"}),
        ("conv3d_transpose", (f64(1, 2, 3, 3, 3), f64(2, 3, 2, 2, 2)),
         {"stride": 2}, {}),
        # pooling
        ("avg_pool1d", (X1, 3, 2, 1), {}, {"grad": True}),
        ("avg_pool2d", (X2, 3, 2, 1), {}, {"grad": True}),
        ("avg_pool2d", (X2, 3, 2, 1), {"exclusive": False},
         {"id": "inclusive"}),
        ("avg_pool2d", (IMG, 2, 2), {"ceil_mode": True}, {"id": "ceil"}),
        ("avg_pool2d", (X2, 3, 2, 1), {"divisor_override": 4},
         {"id": "divisor"}),
        ("avg_pool2d", (np.moveaxis(IMG, 1, 3).copy(), 3, 2),
         {"padding": "SAME", "data_format": "NHWC"}, {"id": "nhwc-same"}),
        ("avg_pool3d", (X3, 2, 2), {"padding": 1}, {}),
        ("max_pool1d", (X1, 3, 2, 1), {}, {"grad": True}),
        ("max_pool2d", (X2, 3, 2, 1), {}, {"grad": True}),
        ("max_pool2d", (IMG, 2, 2), {"ceil_mode": True}, {"id": "ceil"}),
        ("max_pool2d", (X2, 3, 2, 1), {"return_mask": True},
         {"id": "mask"}),
        ("max_pool2d", (np.moveaxis(IMG, 1, 3).copy(), 3, 2),
         {"padding": "SAME", "data_format": "NHWC"}, {"id": "nhwc-same"}),
        ("max_pool1d", (X1, 2), {"return_mask": True}, {"id": "mask"}),
        ("max_pool3d", (X3, 2, 2), {"padding": 1, "return_mask": True}, {}),
        ("adaptive_avg_pool1d", (X1, 4), {}, {"grad": True}),
        ("adaptive_avg_pool2d", (X2, 4), {}, {}),
        ("adaptive_avg_pool2d", (IMG, [3, 5]), {}, {"id": "uneven",
                                                    "grad": True}),
        ("adaptive_avg_pool2d", (np.moveaxis(X2, 1, 3).copy(), 2),
         {"data_format": "NHWC"}, {"id": "nhwc"}),
        ("adaptive_avg_pool3d", (X3[:, :, :4, :4, :4].copy(), 2), {}, {}),
        # the JAX op stacks an uneven 3-D result's last two dims swapped
        ("adaptive_avg_pool3d", (X3, 2), {}, {"id": "uneven",
                                              "jax_swaps_last_two": True}),
        ("adaptive_max_pool1d", (X1, 3), {}, {}),
        ("adaptive_max_pool2d", (IMG, [3, 2]), {}, {"grad": True}),
        ("adaptive_max_pool3d", (X3[:, :, :4, :4, :4].copy(), [2, 4, 1]),
         {}, {}),
        ("adaptive_max_pool3d", (X3, [2, 3, 2]), {},
         {"id": "uneven", "jax_swaps_last_two": True}),
        ("lp_pool2d", (POS, 2.0, 2), {}, {"grad": True}),
        ("lp_pool2d", (POS, 3.0, 3, 2), {"padding": 1, "ceil_mode": True},
         {"id": "ceil"}),
        ("max_unpool2d", (f64(1, 2, 2, 2), UNPOOL_IDX, 2), {}, {}),
        ("max_unpool3d", (f64(1, 1, 2, 2, 2), UNPOOL3_IDX, 2), {}, {}),
        ("fractional_max_pool2d", (IMG, 3), {"random_u": 0.3},
         {"grad": True}),
        ("fractional_max_pool2d", (IMG, [4, 3]), {
            "kernel_size": 2, "random_u": 0.7}, {"id": "overlap"}),
        ("fractional_max_pool2d", (IMG, 3), {"random_u": 0.4,
                                             "return_mask": True},
         {"id": "mask"}),
        ("fractional_max_pool3d", (X3, 2), {"random_u": 0.5}, {}),
        # norms
        ("batch_norm_infer", (X2, f64(3), R.uniform(0.5, 2, 3), f64(3),
                              f64(3)), {}, {"grad": True}),
        ("batch_norm_infer", (np.moveaxis(X2, 1, 3).copy(), f64(3),
                              R.uniform(0.5, 2, 3)),
         {"data_format": "NHWC"}, {"id": "nhwc"}),
        ("batch_norm_train", (X2, f64(3), f64(3)), {}, {"grad": True}),
        ("batch_norm_train", (f64(8, 3),), {}, {"id": "2d"}),
        ("layer_norm", (X2, [8, 8], f64(8, 8), f64(8, 8)), {},
         {"grad": True}),
        ("rms_norm", (f32(6, 16), f32(16) + 1.0), {"epsilon": 1e-5},
         {"tol": F32_TOL}),
        ("group_norm", (f64(2, 6, 4, 4), 3), {"weight": f64(6),
                                               "bias": f64(6)},
         {"grad": True}),
        ("group_norm", (f64(2, 4, 4, 6), 2), {"data_format": "NHWC"},
         {"id": "nhwc"}),
        ("instance_norm", (X2,), {"weight": f64(3), "bias": f64(3)},
         {"grad": True}),
        ("local_response_norm", (f64(2, 6, 3, 3), 3), {}, {"grad": True}),
        ("local_response_norm", (f64(2, 3, 3, 6), 4),
         {"data_format": "NHWC"}, {"id": "nhwc"}),
        ("spectral_norm", (f64(4, 6), f64(4), f64(6)),
         {"power_iters": 2}, {"grad": True, "diff": (0,)}),
        # common
        ("linear", (f64(3, 4), f64(4, 5), f64(5)), {}, {"grad": True}),
        ("dropout", (f64(3, 4),), {"training": False,
                                   "mode": "downscale_in_infer"}, {}),
        ("dropout2d", (X2,), {"training": False}, {}),
        ("dropout3d", (X3,), {"training": False}, {}),
        ("alpha_dropout", (f64(3, 4),), {"training": False}, {}),
        ("embedding", (np.array([[0, 2, 5], [2, 2, 1]]), f64(6, 3)),
         {"padding_idx": 2}, {"grad": True, "diff": (1,)}),
        ("one_hot", (np.array([0, 3, 1, 4]), 5), {}, {}),
        ("label_smooth", (BIN,), {"epsilon": 0.2}, {}),
        ("label_smooth", (BIN, SOFT[:1]), {}, {"id": "prior"}),
        ("cosine_similarity", (f64(4, 5), f64(4, 5)), {}, {"grad": True}),
        ("normalize", (f64(4, 5),), {}, {"grad": True}),
        ("normalize", (f64(4, 5),), {"p": 1, "axis": 0}, {"id": "p1"}),
        ("pixel_shuffle", (f64(1, 8, 2, 3), 2), {}, {}),
        ("pixel_shuffle", (f64(1, 2, 3, 8), 2), {"data_format": "NHWC"},
         {"id": "nhwc"}),
        ("pixel_unshuffle", (f64(1, 2, 4, 6), 2), {}, {}),
        ("channel_shuffle", (f64(1, 6, 2, 2), 3), {}, {}),
        ("unfold", (IMG, [2, 3]), {"strides": [1, 2], "paddings": 1},
         {"grad": True}),
        ("unfold", (IMG, 3), {"paddings": [1, 0, 2, 1], "dilations": 2},
         {"id": "per-side"}),
        ("fold", (f64(2, 12, 12), [4, 5], 2), {}, {"grad": True}),
        ("interpolate", (IMG,), {"scale_factor": 2}, {"grad": True}),
        ("interpolate", (IMG,), {"size": [10, 4]}, {"id": "nearest-odd"}),
        ("interpolate", (IMG,), {"size": [11, 9], "mode": "bilinear"},
         {"id": "bilinear-up", "grad": True}),
        ("interpolate", (IMG,), {"size": [4, 3], "mode": "bilinear"},
         {"id": "bilinear-down"}),
        ("interpolate", (IMG,), {"size": [5, 10], "mode": "bicubic"},
         {"id": "bicubic"}),
        # align_corners weights are float32 in JAX (its scale_and_translate
        # takes float32 scales): float32's tolerance
        ("interpolate", (IMG,), {"scale_factor": 1.5, "mode": "bilinear",
                                 "align_corners": True},
         {"id": "align-corners", "tol": F32_TOL}),
        ("interpolate", (X1,), {"size": [5], "mode": "linear",
                                "data_format": "NCW"}, {"id": "linear-1d"}),
        ("interpolate", (X3,), {"size": [3, 7, 4], "mode": "trilinear"},
         {"id": "trilinear"}),
        ("interpolate", (IMG,), {"size": [3, 3], "mode": "area"},
         {"id": "area"}),
        ("interpolate", (np.moveaxis(IMG, 1, 3).copy(),),
         {"size": [9, 5], "mode": "bilinear", "data_format": "NHWC"},
         {"id": "nhwc"}),
        ("upsample", (IMG,), {"scale_factor": 2, "mode": "bilinear"}, {}),
        ("affine_grid", (THETA, [2, 3, 4, 5]), {}, {}),
        ("affine_grid", (THETA, [2, 3, 4, 5]), {"align_corners": False},
         {"id": "half-pixel"}),
        ("grid_sample", (IMG[:, :, :4, :5], GRID), {}, {"grad": True,
                                                        "diff": (0,)}),
        ("grid_sample", (IMG[:, :, :4, :5], GRID),
         {"padding_mode": "border", "align_corners": False},
         {"id": "border"}),
        ("grid_sample", (IMG[:, :, :4, :5], GRID),
         {"padding_mode": "reflection"}, {"id": "reflection"}),
        ("grid_sample", (IMG[:, :, :4, :5], GRID), {"mode": "nearest"},
         {"id": "nearest"}),
        ("bilinear", (f64(3, 4), f64(3, 5), f64(2, 4, 5), f64(2)), {},
         {"grad": True}),
        ("temporal_shift", (f64(4, 8, 2, 2), 2), {}, {}),
        # losses
        ("cross_entropy", (LOGITS, LABELS), {}, {"grad": True,
                                                 "diff": (0,)}),
        ("softmax_with_cross_entropy", (LOGITS, LABELS_IGN[:, None]), {},
         {"grad": True, "diff": (0,)}),
        ("softmax_with_cross_entropy", (LOGITS, SOFT),
         {"soft_label": True, "return_softmax": True}, {"id": "soft"}),
        ("mse_loss", (f64(4, 5), f64(4, 5)), {}, {"grad": True}),
        ("l1_loss", (f64(4, 5), f64(4, 5)), {"reduction": "sum"}, {}),
        ("smooth_l1_loss", (f64(4, 5), f64(4, 5)), {"delta": 0.5},
         {"grad": True}),
        ("huber_loss", (f64(4, 5), f64(4, 5)), {"delta": 0.7,
                                                 "reduction": "none"}, {}),
        ("binary_cross_entropy", (PROB, BIN), {"weight": f64(5) ** 2},
         {"grad": True, "diff": (0,)}),
        ("binary_cross_entropy_with_logits", (LOGITS, BIN), {},
         {"grad": True, "diff": (0,)}),
        ("binary_cross_entropy_with_logits", (LOGITS, BIN),
         {"pos_weight": R.uniform(0.5, 2, 5), "reduction": "sum"},
         {"id": "pos-weight"}),
        ("nll_loss", (np.log(SOFT), LABELS_IGN), {}, {"grad": True,
                                                      "diff": (0,)}),
        ("nll_loss", (LOGP4, LAB4), {"weight": R.uniform(0.5, 2, 4)},
         {"id": "4d-weight"}),
        ("kl_div", (np.log(SOFT), SOFT[::-1].copy()),
         {"reduction": "batchmean"}, {"grad": True, "diff": (0,)}),
        ("kl_div", (np.log(SOFT), np.log(SOFT[::-1])),
         {"log_target": True, "reduction": "sum"}, {"id": "log-target"}),
        ("margin_ranking_loss", (f64(6), f64(6), SIGN), {"margin": 0.3},
         {"grad": True, "diff": (0, 1)}),
        ("hinge_embedding_loss", (f64(6), SIGN), {}, {}),
        ("cosine_embedding_loss", (f64(6, 4), f64(6, 4), SIGN),
         {"margin": 0.1}, {"grad": True, "diff": (0, 1)}),
        ("triplet_margin_loss", (f64(5, 4), f64(5, 4), f64(5, 4)), {},
         {"grad": True}),
        ("triplet_margin_loss", (f64(5, 4), f64(5, 4), f64(5, 4)),
         {"swap": True, "p": 1.0, "reduction": "none"}, {"id": "swap"}),
        ("ctc_loss", (CTC_LOGP, CTC_LAB, CTC_IN, CTC_LL), {},
         {"grad": True, "diff": (0,)}),
        ("ctc_loss", (CTC_LOGP, CTC_LAB, CTC_IN, CTC_LL),
         {"reduction": "none"}, {"id": "none"}),
        ("sigmoid_focal_loss", (LOGITS, BIN), {}, {"grad": True,
                                                   "diff": (0,)}),
        ("square_error_cost", (f64(4, 5), f64(4, 5)), {}, {}),
        ("log_loss", (PROB, BIN), {}, {}),
        ("npair_loss", (f64(4, 6), f64(4, 6), np.array([0, 1, 0, 2])), {},
         {"grad": True, "diff": (0, 1)}),
        ("hsigmoid_loss", (f32(4, 6), np.array([0, 3, 5, 2]), 6,
                           f32(5, 6), f32(5)), {},
         {"tol": F32_TOL, "grad": True, "diff": (0, 3, 4)}),
        ("rnnt_loss", (RNNT_IN, RNNT_LAB, RNNT_TL, RNNT_UL), {},
         {"tol": F32_TOL, "grad": True, "diff": (0,)}),
        # attention
        ("scaled_dot_product_attention", (Q, K, V), {},
         {"tol": F32_TOL, "grad": True}),
        ("scaled_dot_product_attention", (Q, K, V), {"is_causal": True},
         {"tol": F32_TOL, "id": "causal"}),
        ("scaled_dot_product_attention", (Q, Q, Q, MASK), {},
         {"tol": F32_TOL, "id": "mask"}),
        ("flash_attention", (Q, K, V), {"causal": True}, {"tol": F32_TOL}),
        ("flashmask_attention", (Q, K, V, FLASHMASK), {"causal": True},
         {"tol": F32_TOL}),
        ("paged_attention", (f32(B, H, D), PAGES_K, PAGES_V, TABLES, CTX),
         {}, {"tol": F32_TOL}),
        ("ragged_paged_attention", (f32(B, 3, H, D), PAGES_K, PAGES_V,
                                    TABLES, CTX, np.array([3, 1],
                                                          np.int32)),
         {}, {"tol": F32_TOL}),
        ("softmax_mask_fuse", (f32(B, H, S, S), MASK), {},
         {"tol": F32_TOL}),
        ("softmax_mask_fuse_upper_triangle", (f32(B, H, S, S),), {},
         {"tol": F32_TOL}),
    ]
    # random draws (dropout while training): checked in the sweep by
    # shape, type and repeat; by moments in the tests
    RANDOM = {
        "dropout": ((f32(64, 8),), {"p": 0.3}),
        "dropout2d": ((f32(8, 16, 4, 4),), {"p": 0.5}),
        "dropout3d": ((f32(4, 8, 2, 2, 2),), {"p": 0.5}),
        "alpha_dropout": ((f32(64, 8),), {"p": 0.2}),
        "fractional_max_pool2d": ((f32(2, 3, 9, 9), 4), {}),
    }
    return SimpleNamespace(**locals())


def _legacy():
    """The detection and legacy ops: one case each, from the JAX
    package's tests (``tests/test_detection_legacy_ops.py``)."""
    R = np.random.default_rng(16)

    def f32(*shape, scale=1.0):
        return (R.standard_normal(shape) * scale).astype(np.float32)

    def i64(*v):
        return np.asarray(v, np.int64)

    YOLO_X = f32(2, 3 * (5 + 4), 4, 4)
    IMG_HW = np.asarray([[128, 128], [96, 64]], np.int32)
    ANCHORS = [10, 13, 16, 30, 33, 23]
    GT = np.asarray([[[0.5, 0.5, 0.3, 0.4], [0, 0, 0, 0]]] * 2, np.float32)
    GL = np.asarray([[1, 0]] * 2, np.int32)
    NMS_B = np.asarray([[[0, 0, 10, 10], [0.2, 0.2, 10.2, 10.2],
                         [20, 20, 30, 30]]], np.float32)
    NMS_S = np.zeros((1, 2, 3), np.float32)
    NMS_S[0, 1] = [0.9, 0.85, 0.8]
    PS_X = np.zeros((1, 8, 4, 4), np.float32)
    for c in range(8):
        PS_X[0, c] = c
    H = W = 4
    A = 3
    ANC = R.uniform(0, 32, size=(H, W, A, 4)).astype(np.float32)
    ANC[..., 2:] += ANC[..., :2]
    VAR = np.ones((H, W, A, 4), np.float32) * 0.1
    RPN_S = R.normal(size=(1, A, H, W)).astype(np.float32)
    RPN_D = (R.normal(size=(1, 4 * A, H, W)) * 0.1).astype(np.float32)
    FPN_ROIS = np.asarray([[0, 0, 10, 10], [0, 0, 500, 500]], np.float32)
    EM = f32(7, 4)
    TR = f32(6, 4)
    RO = np.asarray([[1, 1, 0, 0, -1], [0, 0, -1, 0, -1]], np.int32)
    DEQ_W = np.zeros((3, 4), np.float32)
    DEQ_W[:, 1] = 1.0
    DEQ_W[1, 2:] = np.frombuffer(np.arange(8, dtype=np.uint8).tobytes(),
                                 np.float32)
    SEQ = np.arange(8, dtype=np.float32).reshape(4, 2)
    LOD = i64(0, 1, 4)
    COLPTR = i64(0, 2, 3, 5, 5)
    ROW = i64(1, 2, 0, 1, 3)
    TREE = np.asarray([[0, 0, 0, 0, 0], [0, 1, 0, 2, 3], [5, 2, 1, 0, 0],
                       [0, 2, 1, 4, 0], [7, 3, 3, 0, 0]], np.int32)

    CASES = [
        ("yolo_box", (YOLO_X, IMG_HW), {"anchors": ANCHORS,
                                        "class_num": 4, "conf_thresh": 0.5},
         {}),
        ("yolo_loss", (YOLO_X, GT, GL), {
            "anchors": ANCHORS, "anchor_mask": [0, 1, 2], "class_num": 4,
            "downsample_ratio": 32}, {"grad": True, "diff": (0,)}),
        ("matrix_nms", (NMS_B, NMS_S), {
            "score_threshold": 0.1, "nms_top_k": 10, "keep_top_k": 10,
            "post_threshold": 0.5, "return_index": True}, {}),
        ("bipartite_match", (np.asarray([[0.9, 0.1], [0.3, 0.8],
                                         [0.2, 0.2]], np.float32),), {}, {}),
        ("box_clip", (np.asarray([[[-1, -1, 9, 9], [2, 3, 4, 12]]],
                                 np.float32),
                      np.asarray([[8, 8, 1.0]], np.float32)), {}, {}),
        ("psroi_pool", (PS_X, np.asarray([[0, 0, 3, 3], [1, 0, 2, 3]],
                                         np.float32),
                        np.asarray([2], np.int32), 2, 2, 2, 1.0), {}, {}),
        ("collect_fpn_proposals", (
            [np.asarray([[0, 0, 1, 1], [0, 0, 2, 2], [0, 0, 3, 3],
                         [0, 0, 4, 4]], np.float32)],
            [np.asarray([0.1, 0.9, 0.8, 0.2], np.float32)]),
         {"multi_level_rois_num": [np.asarray([2, 2], np.int32)],
          "post_nms_top_n": 1}, {}),
        ("distribute_fpn_proposals", (FPN_ROIS, 2, 5, 4, 224), {}, {}),
        ("yolo_box_head", (YOLO_X,), {"anchors": ANCHORS, "class_num": 4},
         {}),
        ("yolo_box_post", (YOLO_X, f32(2, 27, 8, 8), f32(2, 27, 16, 16),
                           np.asarray([[256, 256], [256, 256]], np.float32),
                           np.asarray([[1, 1], [1, 1]], np.float32)),
         {"anchors0": ANCHORS, "anchors1": ANCHORS, "anchors2": ANCHORS,
          "class_num": 4, "conf_thresh": 0.5}, {}),
        ("generate_proposals", (RPN_S, RPN_D,
                                np.asarray([[64, 64]], np.float32), ANC,
                                VAR),
         {"pre_nms_top_n": 20, "post_nms_top_n": 5, "nms_thresh": 0.5,
          "min_size": 1.0}, {}),
        ("crf_decoding", (EM, TR), {"lod": i64(0, 3, 7)}, {}),
        ("dgc", (np.zeros(10, np.float32), np.zeros(10, np.float32),
                 np.arange(1.0, 11.0, dtype=np.float32)),
         {"sparsity": [0.7], "current_step": np.asarray([10.0],
                                                        np.float32)}, {}),
        ("detection_map", (np.asarray([[1, 0.9, 0, 0, 10, 10],
                                       [1, 0.8, 50, 50, 60, 60]],
                                      np.float32),
                           np.asarray([[1, 0, 0, 10, 10, 0]], np.float32)),
         {}, {}),
        ("shuffle_channel", (f32(2, 8, 2, 2),), {"group": 2}, {}),
        ("affine_channel", (f32(1, 3, 2, 2), f32(3), f32(3)), {},
         {"grad": True}),
        ("partial_concat", ([f32(2, 6), f32(2, 6)],),
         {"start_index": 1, "length": 2}, {}),
        ("partial_sum", ([f32(2, 6), f32(2, 6)],),
         {"start_index": 1, "length": 2}, {}),
        ("im2sequence", (f32(2, 3, 8, 8),), {"kernels": [2, 2],
                                             "strides": [2, 2]}, {}),
        ("add_position_encoding", (f32(1, 4, 6),), {"alpha": 0.5,
                                                    "beta": 1.0}, {}),
        ("correlation", (f32(1, 2, 6, 6), f32(1, 2, 6, 6)), {
            "pad_size": 1, "kernel_size": 1, "max_displacement": 1,
            "stride1": 1, "stride2": 1}, {"grad": True}),
        ("cvm", (np.asarray([[1.0, 3.0, 5.0, 6.0]], np.float32), None),
         {"use_cvm": True}, {}),
        ("batch_fc", (np.ones((2, 1, 3), np.float32),
                      np.ones((2, 3, 2), np.float32),
                      np.asarray([[0., -10.], [1., -10.]], np.float32)),
         {}, {}),
        ("rank_attention", (np.asarray([[1., 2.], [3., 4.]], np.float32),
                            RO, np.arange(8, dtype=np.float32).reshape(8, 1)),
         {"max_rank": 2}, {}),
        ("lookup_table_dequant", (DEQ_W, i64(1)[None]), {}, {}),
        ("sequence_pool", (SEQ, LOD, "MAX"), {}, {}),
        ("sequence_conv", (SEQ, LOD, f32(6, 2)), {"context_length": 3},
         {"grad": True, "diff": (0, 2)}),
        ("match_matrix_tensor", (np.asarray([[1., 0.]], np.float32),
                                 np.asarray([[0., 1., 0.]], np.float32),
                                 f32(2, 3), i64(0, 1), i64(0, 1)), {}, {}),
        ("attention_lstm", (f32(5, 3), i64(0, 2, 5),
                            np.zeros((2, 4), np.float32), None, f32(7, 1),
                            None, None, None, f32(7, 16),
                            np.zeros(16, np.float32)), {}, {}),
        ("row_conv", (f32(5, 3), f32(2, 3)), {"lod": i64(0, 2, 5)}, {}),
        ("sequence_expand", (f32(2, 3), i64(0, 2, 5)), {}, {}),
        ("sequence_softmax", (f32(5), i64(0, 2, 5)), {}, {}),
        ("shuffle_batch", (f32(5, 2),), {"seed": i64(7)}, {}),
        ("ctc_align", (np.asarray([[1, 1, 0, 2, 2, 0, 3],
                                   [4, 4, 4, 0, 0, 5, 0]], np.int32),
                       np.asarray([[7], [6]], np.int64)), {"blank": 0}, {}),
        ("chunk_eval", (i64(0, 1, 4, 0, 1, 1), i64(0, 1, 4, 0, 1, 4)),
         {"num_chunk_types": 2, "chunk_scheme": "IOB"}, {}),
        ("graph_sample_neighbors", (ROW, COLPTR, i64(0, 2)),
         {"sample_size": -1}, {}),
        ("weighted_sample_neighbors", (ROW, COLPTR,
                                       np.ones(5, np.float32), i64(0, 2)),
         {"sample_size": -1}, {}),
        ("reindex_graph", (i64(0, 2), i64(1, 2, 1, 3), i64(2, 2)), {}, {}),
        ("graph_khop_sampler", (ROW, COLPTR, i64(0, 2)),
         {"sample_sizes": [-1]}, {}),
        ("tdm_child", (np.asarray([[1], [2]], np.int32), TREE),
         {"child_nums": 2}, {}),
        ("tdm_sampler", (np.asarray([[0], [1]], np.int32),
                         np.asarray([[1, 2], [1, 3]], np.int32),
                         np.asarray([1, 2, 3], np.int32)),
         {"neg_samples_num_list": [0, 1], "layer_offset_lod": [0, 1, 3],
          "seed": 7}, {}),
        ("pyramid_hash", (i64(3, 7, 9, 2), f32(50, 16), i64(0, 4)),
         {"num_emb": 16, "space_len": 49, "pyramid_layer": 3,
          "rand_len": 16}, {}),
    ]
    return SimpleNamespace(**locals())


def _nntail():
    """``nn.functional``'s tail, the rnn layers' op and the detection ops
    of ``vision.ops``: one or two cases each, from the CPU parity tests
    (``tests/test_torch_nn_tail.py``, ``test_torch_rnn.py``,
    ``test_torch_vision.py``)."""
    R = np.random.default_rng(17)
    F32_TOL = (1e-5, 1e-6)
    A, B = R.standard_normal((4, 3)), R.standard_normal((4, 3))
    POS = R.uniform(0.5, 2.0, (4, 3))
    LAB5 = R.integers(0, 5, (4,)).astype(np.int64)
    X5 = R.standard_normal((4, 5))
    PROB5 = np.exp(X5) / np.exp(X5).sum(-1, keepdims=True)

    def f32(*shape):
        return R.standard_normal(shape).astype(np.float32)

    LSTM_W = [f32(24, 5), f32(24, 6), f32(24), f32(24),
              f32(24, 5), f32(24, 6), f32(24), f32(24)]
    BOXES = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [20, 20, 30, 30],
                      [21, 19, 31, 29]], np.float64)
    X_ROI = R.standard_normal((2, 3, 12, 10))
    ROI = np.array([[1.0, 2.0, 7.5, 9.0], [0.0, 0.0, 9.0, 11.0],
                    [3.2, 1.1, 5.0, 4.0]])
    ROI_N = np.array([2, 1], np.int32)
    PRIOR = np.array([[0.1, 0.1, 0.4, 0.5], [0.3, 0.2, 0.9, 0.8]])
    TARGET = np.array([[0.2, 0.1, 0.6, 0.7]])
    CASES = [
        ("gaussian_nll_loss", (A, B, POS), {}, {"grad": True}),
        ("poisson_nll_loss", (A, np.round(POS)), {}, {"grad": True}),
        ("soft_margin_loss", (A, np.sign(B)), {}, {"grad": True}),
        ("multi_label_soft_margin_loss", (A, (B > 0) * 1.0), {},
         {"grad": True}),
        ("multi_margin_loss", (X5, LAB5), {"p": 2}, {"grad": True}),
        ("triplet_margin_with_distance_loss", (A, B, POS), {},
         {"grad": True}),
        ("dice_loss", (PROB5, LAB5[:, None]), {}, {}),
        ("pairwise_distance", (A, B), {}, {"grad": True}),
        ("margin_cross_entropy", (R.uniform(-0.9, 0.9, (4, 5)), LAB5), {},
         {"grad": True}),
        ("adaptive_log_softmax_with_loss",
         (f32(6, 8), np.array([0, 3, 4, 6, 7, 9], np.int64), f32(8, 6),
          [(f32(8, 4), f32(4, 3)), (f32(8, 2), f32(2, 3))], [4, 7]), {},
         {"tol": F32_TOL}),
        ("rnn_sequence", (f32(3, 4, 5), f32(2, 3, 6), f32(2, 3, 6), LSTM_W,
                          "LSTM", 1, True, 0.0, False), {},
         {"tol": F32_TOL}),
        ("nms", (BOXES,), {"scores": np.array([0.9, 0.8, 0.7, 0.95])},
         {}),
        ("roi_align", (X_ROI, ROI, ROI_N, 4), {}, {"tol": F32_TOL}),
        ("roi_pool", (X_ROI, ROI, ROI_N, 3), {}, {}),
        ("box_coder", (PRIOR, np.array([0.1, 0.1, 0.2, 0.2]), TARGET), {},
         {"tol": F32_TOL}),
        ("prior_box", (np.zeros((1, 8, 3, 4)), np.zeros((1, 3, 12, 16)),
                       [4.0]), {"max_sizes": [8.0], "flip": True,
                                "aspect_ratios": (2.0,)},
         {"tol": F32_TOL}),
        ("deform_conv2d", (R.standard_normal((1, 4, 6, 5)),
                           R.standard_normal((1, 18, 6, 5)),
                           R.standard_normal((6, 4, 3, 3)), None, 1, 1),
         {}, {"tol": F32_TOL}),
    ]
    RANDOM = {
        "class_center_sample": ((np.array([3, 7, 3, 11, 0], np.int64), 20,
                                 8), {}),
        "feature_alpha_dropout": ((f32(8, 6, 5),), {"p": 0.3}),
    }
    return SimpleNamespace(**locals())


def _fused_inference():
    """The fused inference ops (``ops.impl.fused_inference``): one or
    two cases each, from the CPU parity tests
    (``tests/test_torch_fused_inference.py``); the attention ops in
    float32 (the flash kernel takes no float64)."""
    R = np.random.default_rng(23)
    F32_TOL = (1e-5, 1e-6)

    def f64(*shape):
        return R.standard_normal(shape)

    def f32(*shape):
        return R.standard_normal(shape).astype(np.float32)

    A, B = f64(4, 6), f64(4, 6)
    POS = R.uniform(0.5, 2.0, (4, 6))
    X3, Y3 = f64(2, 3, 8), f64(2, 3, 8)
    G8, B8 = R.uniform(0.5, 1.5, (8,)), f64(8)
    QA, KA, VA = f32(2, 16, 4, 16), f32(2, 16, 4, 16), f32(2, 16, 4, 16)
    IDS1 = R.integers(0, 10, (2, 5)).astype(np.int64)
    IDS2 = R.integers(0, 7, (2, 5)).astype(np.int64)
    ATTN = R.uniform(0.0, 1.0, (2, 2, 6, 6))
    VQ, VK, VV = f64(2, 2, 5, 4), f64(2, 2, 5, 4), f64(2, 2, 5, 4)
    SEQ = np.array([5, 5], np.int32)
    CASES = [
        ("fc", (f64(4, 3, 5), f64(15, 6), f64(6)),
         {"activation_type": "relu"}, {"grad": True}),
        ("fused_dropout_add", (A, B), {"p": 0.3, "is_test": True,
                                       "mode": "downscale_in_infer"},
         {"id": "infer"}),
        ("fused_dot_product_attention", (QA, KA, VA),
         {"is_causal_masking": True}, {"tol": F32_TOL}),
        ("fused_elementwise_add", (A, B), {"act": "relu"}, {"grad": True}),
        ("fused_elementwise_sub", (A, B), {"fused_output_scale": 0.5}, {}),
        ("fused_elementwise_mul", (A, B), {"act": "gelu"}, {}),
        ("fused_elementwise_div", (A, POS), {"act": "tanh"}, {}),
        ("fused_elemwise_activation", (A, B),
         {"functor_list": ["elementwise_mul", "sigmoid"]}, {}),
        ("fused_elemwise_activation", (A, B),
         {"functor_list": ["elementwise_add", "scale"], "scale": 0.25},
         {"id": "scale"}),
        ("fused_elemwise_add_activation", (A, B),
         {"functor_list": ["elementwise_add", "tanh"]}, {}),
        ("skip_layernorm", (X3, Y3, G8, B8), {}, {"grad": True}),
        ("fused_bias_residual_layernorm", (X3, B8, Y3, G8, B8),
         {"residual_alpha": 0.5}, {}),
        ("add_group_norm_silu", (f64(2, 4, 4, 8), f64(2, 4, 4, 8), G8, B8),
         {"groups": 4}, {"tol": F32_TOL}),
        ("add_group_norm_silu", (f64(2, 8, 3, 3), None, G8, None),
         {"groups": 2, "data_format": "NCHW"},
         {"tol": F32_TOL, "id": "nchw"}),
        ("fused_fc_elementwise_layernorm", (f64(4, 6), f64(6, 8), f64(4, 8),
                                            B8, G8, B8), {}, {}),
        ("fused_embedding_eltwise_layernorm",
         ([IDS1, IDS2], [f64(10, 8), f64(7, 8)], B8, G8), {}, {}),
        ("multihead_matmul", (f64(2, 5, 12), f64(12, 3, 2, 4),
                              f64(3, 2, 4), f64(2, 2, 5, 5)),
         {"alpha": 0.5, "head_number": 2}, {"grad": True}),
        ("qkv_unpack_mha", (f32(2, 8, 2, 16), f32(2, 8, 2, 16),
                            f32(2, 8, 2, 16)), {}, {"tol": F32_TOL}),
        ("fused_scale_bias_add_relu", (f64(2, 4, 3), f64(3), f64(3),
                                       f64(2, 4, 3), f64(3), f64(3)),
         {"fuse_dual": True}, {}),
        ("blha_get_max_len", (np.array([3, 9, 0, 4], np.int32),
                              np.array([1, 0, 7, 2], np.int32)), {}, {}),
        ("fused_token_prune", (ATTN, f64(2, 6, 3), np.ones((2, 2, 6, 6)),
                               np.ones((2, 2, 3, 3))), {"keep_order": True},
         {}),
        ("fused_token_prune", (ATTN, f64(2, 6, 3), np.ones((2, 2, 6, 6)),
                               np.ones((2, 2, 4, 4))),
         {"keep_first_token": False}, {"id": "unordered"}),
        ("max_pool2d_v2", (f64(2, 3, 6, 6), 2), {"stride": 2}, {}),
        ("max_pool2d_v2", (f64(2, 3, 6, 6), 2), {"global_pooling": True},
         {"id": "global"}),
        ("variable_length_memory_efficient_attention",
         (VQ, VK, VV, SEQ, np.array([3, 0], np.int32)), {}, {}),
        ("variable_length_memory_efficient_attention",
         (VQ, VK, VV, SEQ, np.array([5, 4], np.int32)),
         {"causal": True, "mask": f64(2, 1, 5, 5)}, {"id": "causal"}),
        ("gemm_epilogue", (f64(3, 4), f64(5, 4), f64(5)),
         {"trans_y": True, "activation": "gelu"}, {"grad": True}),
        ("resnet_unit", (f64(1, 6, 6, 4), f64(8, 4, 3, 3), G8, B8, B8,
                         R.uniform(0.5, 2.0, (8,))), {}, {}),
        ("resnet_unit", (f64(1, 6, 6, 4), f64(8, 4, 3, 3), G8, B8, B8,
                         R.uniform(0.5, 2.0, (8,)), f64(1, 6, 6, 8)),
         {"fuse_add": True, "act": "identity"}, {"id": "add"}),
        ("fp8_fp8_half_gemm_fused", (f32(4, 16), f32(16, 8)),
         {"bias": f32(8), "scale": 0.5, "activation_type": "relu"}, {}),
        ("fp8_fp8_half_gemm_fused", (f32(16, 4), f32(8, 16)),
         {"transpose_x": True, "transpose_y": True,
          "output_dtype": "float32"}, {"tol": F32_TOL, "id": "transposed"}),
    ]
    RANDOM = {"fused_dropout_add": ((f32(64, 8), f32(64, 8)), {"p": 0.3})}
    return SimpleNamespace(**locals())


def _incubate():
    """The quantization ops, the MoE ops and the geometric ops (each
    registered when its module is imported: ``quantization``,
    ``incubate``): one or more cases each, from
    ``tests/test_torch_quantization.py``, ``test_torch_moe.py`` and
    ``test_torch_incubate_tail.py``."""
    R = np.random.default_rng(29)
    F32_TOL = (1e-5, 1e-6)

    def f64(*shape):
        return R.standard_normal(shape)

    def f32(*shape):
        return R.standard_normal(shape).astype(np.float32)

    W = f32(16, 8)
    CODES = R.integers(-127, 128, (8, 16)).astype(np.int8)
    SRC = np.array([0, 1, 2, 3, 4, 0, 2], np.int64)
    DST = np.array([1, 2, 1, 0, 0, 4, 4], np.int64)
    SEG = np.array([0, 0, 1, 3, 3, 3], np.int64)
    LOGITS = f32(16, 4)
    CASES = [
        ("fake_quant_dequant", (f32(4, 8), 2.5), {}, {"grad": True}),
        ("fake_quant_dequant", (f32(4, 8), 1.5), {"bit_length": 4},
         {"id": "int4"}),
        ("weight_quantize", (W,), {}, {}),
        ("weight_quantize", (W,), {"algo": "weight_only_int4",
                                   "group_size": 8}, {"id": "int4_g8"}),
        ("weight_only_linear", (f32(3, 16), CODES, None,
                                R.uniform(0.001, 0.01, (8,)).astype(
                                    np.float32)), {}, {"tol": F32_TOL}),
        ("weight_only_linear", (f32(3, 16), CODES, f32(8),
                                R.uniform(0.001, 0.01, (8, 2)).astype(
                                    np.float32)), {"group_size": 8},
         {"tol": F32_TOL, "id": "grouped"}),
        ("moe_dispatch_combine", (f32(16, 8), LOGITS, f32(4, 8, 12),
                                  f32(4, 12, 8), 2, 1.0), {},
         {"tol": F32_TOL}),
        ("moe_balance_loss", (LOGITS,), {}, {"tol": F32_TOL}),
        ("send_u_recv", (f64(5, 3), SRC, DST), {}, {"grad": True}),
        ("send_u_recv", (f64(5, 3), SRC, DST), {"reduce_op": "max"},
         {"id": "max"}),
        ("send_u_recv", (f64(5, 3), SRC, DST), {"reduce_op": "mean",
                                                "out_size": 6},
         {"id": "mean"}),
        ("send_ue_recv", (f64(5, 3), f64(7, 3), SRC, DST),
         {"message_op": "mul", "reduce_op": "min"}, {}),
        ("send_ue_recv", (f64(5, 3), f64(7, 3), SRC, DST),
         {"message_op": "sub", "reduce_op": "sum"}, {"id": "sum"}),
        ("segment_sum", (f64(6, 3), SEG), {}, {"grad": True}),
        ("segment_mean", (f64(6, 3), SEG), {}, {}),
        ("segment_max", (f64(6, 3), SEG), {}, {}),
        ("segment_min", (f64(6, 3), SEG), {}, {}),
    ]
    RANDOM = {}
    return SimpleNamespace(**locals())


MATH, CREATION, MANIPULATION = _math(), _creation(), _manipulation()
REDUCE, LOGIC, ACTIVATION = _reduce(), _logic(), _activation()
LINALG, EXTRA, TAIL, FFT = _linalg(), _extra(), _tail(), _fft()
NN, LEGACY, NNTAIL = _nn(), _legacy(), _nntail()
FUSEDINF, INCUBATE = _fused_inference(), _incubate()
TABLES = {"math": MATH, "creation": CREATION, "manipulation": MANIPULATION,
          "reduce": REDUCE, "logic": LOGIC, "activation": ACTIVATION,
          "linalg": LINALG, "extra": EXTRA, "tail": TAIL, "fft": FFT,
          "nn": NN, "legacy": LEGACY, "nntail": NNTAIL,
          "fused_inference": FUSEDINF, "incubate": INCUBATE}


def _random_cases():
    r = np.random.default_rng(13)
    x = r.standard_normal((64, 8)).astype(np.float32)
    p = r.uniform(0.1, 0.9, (64, 8)).astype(np.float32)
    probs = r.uniform(0.1, 1.0, (4, 6)).astype(np.float32)
    return {
        "rand": (([64, 8],), {}), "randn": (([64, 8],), {}),
        "standard_normal": (([64, 8],), {"dtype": "float64"}),
        "normal": ((1.0, 2.0, [64, 8]), {}),
        "uniform": (([64, 8],), {"min": -2.0, "max": 4.0}),
        "randint": ((0, 10, [64, 8]), {}),
        "randint_like": ((x.astype(np.int32), 0, 5), {}),
        "randperm": ((64,), {}), "bernoulli": ((p,), {}),
        "poisson": ((p * 4,), {}),
        "multinomial": ((probs, 3), {}),
        "normal_": ((x,), {"mean": 1.0, "std": 0.5}),
        "exponential_": ((x,), {"lam": 2.0}),
        "uniform_": ((x,), {"min": 0.0, "max": 1.0}),
        "rrelu": ((x,), {"training": True}),
        "gumbel_softmax": ((x,), {"hard": True}),
        "binomial": ((np.full((64, 8), 10.0, np.float32), p), {}),
        "standard_gamma": ((p * 3,), {}),
        "dirichlet": ((probs,), {}),
        "truncated_gaussian_random": (([64, 8],), {"std": 2.0}),
        "top_p_sampling": ((probs / probs.sum(-1, keepdims=True),
                            np.full((4,), 0.7, np.float32)), {}),
        "uniform_random_batch_size_like": ((x, [1, 3]), {}),
        "log_normal": ((1.0, 0.5, [64, 8]), {}),
        "log_normal_": ((x,), {}), "cauchy_": ((x,), {}),
        "geometric_": ((p,), {"probs": 0.3}),
    }


RANDOM = _random_cases()


def _more_cases():
    """Sweep cases of the ops the tests hold by hand (the
    decompositions, the loss scaler's ops, p2p_transfer)."""
    r = np.random.default_rng(14)
    a = r.standard_normal((4, 4))
    tall = r.standard_normal((5, 3))
    spd = a @ a.T + 4 * np.eye(4)
    lu_m, piv = torch.linalg.lu_factor(torch.from_numpy(a))
    grads = [r.standard_normal((3,)).astype(np.float32) * 64,
             r.standard_normal((2, 2)).astype(np.float32) * 64]
    return {
        "eig": ((a,), {}), "eigh": ((spd,), {}), "eigvals": ((a,), {}),
        "qr": ((tall,), {}), "svd": ((tall,), {}),
        "pca_lowrank": ((tall,), {"q": 2}),
        "householder_product": ((tall, np.array([1.2, 0.7, 0.0])), {}),
        "lstsq": ((tall, r.standard_normal((5, 2))), {}),
        "lu_unpack": ((lu_m.numpy(), piv.numpy()), {}),
        "check_finite_and_unscale_": ((grads, np.float32(64.0)), {}),
        "update_loss_scaling_": ((grads, np.array([False]),
                                  np.array([64.0], np.float32),
                                  np.array([0], np.int32),
                                  np.array([0], np.int32), 1, 1, 2.0, 0.5),
                                 {}),
        "p2p_transfer": ((a, DEVICE), {}),
    }


DEVICE = "<the sweep's device>"
MORE = _more_cases()
# outputs unique only up to sign or phase: compared by what is unique
DECOMP = {"svd", "qr", "eig", "eigh", "eigvals", "svd_lowrank",
          "pca_lowrank"}
SPECIAL = {"lgamma", "digamma", "polygamma", "gammaln", "erfinv", "i0",
           "i0e", "i1", "i1e", "gammainc", "gammaincc", "multigammaln",
           "cholesky", "cholesky_solve", "inverse", "pinv", "det",
           "slogdet", "solve", "triangular_solve", "lstsq", "lu",
           "lu_unpack", "eigvalsh", "matrix_power", "matrix_norm", "svdvals",
           "householder_product", "corrcoef"}
# ops that compute in float32 whatever their inputs' type (the JAX
# package's bodies cast): float32's tolerance
FLOAT32_INSIDE = {"p_norm", "clip_by_norm", "renorm", "swiglu",
                  "fused_rms_norm", "fused_rope", "rms_norm", "hsigmoid_loss",
                  "rnnt_loss",
                  "fused_rotary_position_embedding",
                  "fused_bias_dropout_residual_layer_norm",
                  "fused_feedforward", "fused_linear_cross_entropy",
                  "roi_align", "deform_conv2d", "add_group_norm_silu",
                  "moe_dispatch_combine", "moe_balance_loss"}
DEVICE_TOL = {torch.float64: (1e-9, 1e-11), torch.complex128: (1e-9, 1e-11),
              torch.float32: (1e-4, 1e-5), torch.complex64: (1e-4, 1e-5),
              torch.float16: (1e-2, 1e-3), torch.bfloat16: (2e-2, 1e-2)}
SPECIAL_DEVICE_TOL = (1e-7, 1e-9)


def op_of(name):
    """The port's public function named `name` (top level, ``fft`` or
    ``signal``)."""
    import paddle_tpu_torch as ptt
    for ns in (ptt.fft, ptt.signal, ptt):
        fn = getattr(ns, name, None)
        if callable(fn) and not isinstance(fn, type(ptt)):
            return fn
    raise AttributeError(name)


def first_cases():
    """{op name: (args, kwargs)}: each op's first case over the tables
    (FFT's signal cases too) and the random ops'."""
    out = {}
    for table in TABLES.values():
        for name, args, kwargs, _ in list(table.CASES) + list(
                getattr(table, "SIGNAL_CASES", [])):
            out.setdefault(name, (args, kwargs))
    out.update(RANDOM)
    for table in TABLES.values():
        out.update(getattr(table, "RANDOM", {}))
    out.update(MORE)
    return out


def _to(v, dev):
    if isinstance(v, np.ndarray):
        return torch.from_numpy(v.copy()).to(dev)
    if isinstance(v, np.generic):
        return torch.tensor(v.item(), device=dev)
    if isinstance(v, str) and v == DEVICE:
        return dev
    if isinstance(v, dict):
        return {k: _to(e, dev) for k, e in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_to(e, dev) for e in v)
    return v


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _flat(o)]
    return [out]


def _err(got, want, tol):
    """Largest |got - want| / (atol + rtol |want|) over the elements
    (<= 1 passes); exact types must match exactly."""
    if not isinstance(want, torch.Tensor):
        return 0.0 if got == want else float("inf")
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{tuple(got.shape)} {got.dtype} against "
                             f"{tuple(want.shape)} {want.dtype}")
    g, w = got.detach().cpu(), want.detach()
    if not (w.is_floating_point() or w.is_complex()):
        return 0.0 if torch.equal(g, w) else float("inf")
    rtol, atol = tol or DEVICE_TOL[w.dtype]
    g, w = g.to(torch.complex128 if w.is_complex() else torch.float64), \
        w.to(torch.complex128 if w.is_complex() else torch.float64)
    both_nan = torch.isnan(g.abs()) & torch.isnan(w.abs())
    same = (g == w) | both_nan
    diff = torch.where(same, torch.zeros_like(g.abs()), (g - w).abs())
    return float((diff / (atol + rtol * w.abs())).max()) if diff.numel() \
        else 0.0


def _decomp_err(name, got, want, args):
    """What is unique of a decomposition: values (sorted) and the
    reconstruction of the input."""
    g = [t.detach().cpu().to(torch.complex128 if t.is_complex() else
                             torch.float64) for t in _flat(got)]
    w = [t.to(torch.complex128 if t.is_complex() else torch.float64)
         for t in _flat(want)]
    tol = SPECIAL_DEVICE_TOL
    if name in ("eig", "eigvals"):
        key = lambda v: torch.sort(torch.view_as_real(v).reshape(-1))[0]  # noqa: E731
        return _err(key(g[0]), key(w[0]), tol)
    if name in ("eigh",):
        return _err(g[0], w[0], tol)
    if name in ("svd", "svd_lowrank", "pca_lowrank"):
        return _err(g[1], w[1], tol)
    x = torch.from_numpy(np.asarray(args[0])).to(torch.float64)
    if args[1:] == () and len(g) == 1:          # qr(mode="r")
        return _err(g[0].abs(), w[0].abs(), tol)
    return max(_err(g[0] @ g[1], x, tol), _err(g[1].abs(), w[1].abs(), tol))


def _run(fn, args, kwargs, dev):
    import paddle_tpu_torch as ptt
    ptt.set_device(dev)
    return fn(*_to(args, dev), **_to(kwargs, dev))


def sweep(device="cuda", seed=5):
    """Every op of the port's surface, its first case, on `device` and on
    the CPU. Returns {"ops": n, "failed": {op: why}, "worst": (op, err)}:
    err is the largest |device - cpu| / tolerance (1 passes)."""
    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.incubate  # noqa: F401  (MoE, geometric ops)
    import paddle_tpu_torch.nn  # noqa: F401  (registers its ops)
    import paddle_tpu_torch.quantization.quant  # noqa: F401
    import paddle_tpu_torch.vision.ops  # noqa: F401
    from paddle_tpu_torch.device import _CURRENT
    from paddle_tpu_torch.ops.registry import OP_TABLE

    dev = torch.device(device)
    cases = first_cases()
    failed, worst, prev = {}, ("", 0.0), _CURRENT[0]
    names = sorted(OP_TABLE)
    try:
        for name in names:
            if name not in cases:
                failed[name] = "no case"
                continue
            args, kwargs = cases[name]
            fn = op_of(name)
            try:
                if name in RANDOM or any(
                        name in getattr(t, "RANDOM", {})
                        for t in TABLES.values()):
                    ptt.seed(seed)
                    a = _flat(_run(fn, args, kwargs, dev))
                    ptt.seed(seed)
                    b = _flat(_run(fn, args, kwargs, dev))
                    c = _flat(_run(fn, args, kwargs, "cpu"))
                    for x, y, z in zip(a, b, c):
                        if not torch.equal(x, y) or x.device.type != \
                                dev.type or x.shape != z.shape or \
                                x.dtype != z.dtype:
                            raise AssertionError(
                                f"draws {tuple(x.shape)} {x.dtype} "
                                f"{x.device}, cpu {tuple(z.shape)} "
                                f"{z.dtype}, repeat equal "
                                f"{torch.equal(x, y)}")
                    continue
                got = _run(fn, args, kwargs, dev)
                want = _run(fn, args, kwargs, "cpu")
                for t in _flat(got):
                    if isinstance(t, torch.Tensor) and \
                            t.device.type != dev.type:
                        raise AssertionError(f"output on {t.device}")
                if name in DECOMP:
                    err = _decomp_err(name, got, want, args)
                else:
                    tol = SPECIAL_DEVICE_TOL if name in SPECIAL else \
                        DEVICE_TOL[torch.float32] if name in FLOAT32_INSIDE \
                        else None
                    gs, ws = _flat(got), _flat(want)
                    if len(gs) != len(ws):
                        raise AssertionError(f"{len(gs)} outputs, "
                                             f"{len(ws)} on the cpu")
                    err = max((_err(g, w, tol) for g, w in zip(gs, ws)),
                              default=0.0)
                if err > 1.0:
                    raise AssertionError(f"error {err:.3g} x tolerance")
                if err >= worst[1]:
                    worst = (name, err)
            except Exception as e:      # noqa: BLE001 — reported per op
                failed[name] = f"{type(e).__name__}: {e}"[:300]
    finally:
        _CURRENT[0] = prev
    return {"ops": len(names), "failed": failed, "worst": worst}


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = sweep(args.device)
    print(json.dumps(out, indent=1))
    return 1 if out["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
