"""``paddle.linalg``: the namespace over the registered linear-algebra
ops (the counterpart of ``paddle_tpu/linalg.py``)."""

from .ops.registry import OP_TABLE as _T

__all__ = []
for _name in ("cholesky", "cholesky_solve", "corrcoef", "cov", "det",
              "eig", "eigh", "eigvals", "eigvalsh", "inverse", "lstsq",
              "lu", "lu_unpack", "matrix_power", "matrix_rank",
              "multi_dot", "norm", "pinv", "qr", "slogdet", "solve", "svd",
              "svdvals", "svd_lowrank", "pca_lowrank", "triangular_solve",
              "householder_product", "matrix_norm", "vector_norm", "matmul",
              "dist", "cdist"):
    globals()[_name] = _T[_name]["api"]
    __all__.append(_name)
del _name, _T
