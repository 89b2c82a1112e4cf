"""``paddle.linalg`` of the port (counterpart of ``paddle_tpu/linalg.py``):
the linear-algebra ops of ``ops/linalg.py`` under Paddle's namespace."""
from .ops.linalg import (  # noqa: F401
    cholesky, cholesky_solve, cond, corrcoef, cov, det, eig, eigh, eigvals,
    eigvalsh, inv, lstsq, lu, lu_unpack, matmul, matmul_int8, matrix_power,
    matrix_rank, multi_dot, norm, pinv, qr, slogdet, solve, svd,
    triangular_solve)

__all__ = ["cholesky", "cholesky_solve", "cond", "corrcoef", "cov", "det",
           "eig", "eigh", "eigvals", "eigvalsh", "inv", "lstsq", "lu",
           "lu_unpack", "matmul", "matmul_int8", "matrix_power",
           "matrix_rank", "multi_dot", "norm", "pinv", "qr", "slogdet",
           "solve", "svd", "triangular_solve"]
