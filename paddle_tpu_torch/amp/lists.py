"""AMP op lists: a copy of ``paddle_tpu/amp/lists.py``, under the JAX
package's op names. White = compute in low precision (the matmul, conv
and attention family), black = left as it is (numerically sensitive
reductions, norms and the exp family)."""

WHITE_LIST = {
    "matmul", "mm", "bmm", "mv", "einsum", "addmm",
    "conv2d", "conv3d", "conv1d", "conv2d_transpose", "conv3d_transpose",
    "fc", "linear", "flash_attention", "scaled_dot_product_attention",
}

BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "expm1",
    "softmax", "log_softmax", "logsumexp",
    "cross_entropy", "softmax_with_cross_entropy", "binary_cross_entropy",
    "nll_loss", "kl_div",
    "mean", "sum", "prod", "std", "var", "norm", "dist",
    "cumsum", "cumprod", "logcumsumexp",
    "layer_norm", "batch_norm", "instance_norm", "group_norm", "rms_norm",
    "pow", "square", "reciprocal", "rsqrt",
    "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh",
    "erf", "erfinv", "lgamma", "digamma",
    "linspace", "cholesky", "svd", "qr", "det", "slogdet", "inverse",
    "solve", "eig", "eigh",
}
