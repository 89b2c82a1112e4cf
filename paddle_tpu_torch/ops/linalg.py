"""Linear algebra (counterpart of ``paddle_tpu/ops/linalg.py``), on the
tensor's device: ``torch.linalg`` (cuSOLVER/cuBLAS on the card) where it
computes the JAX function, the JAX formula written out where it does not.

- ``lstsq`` is SVD-based, as ``jnp.linalg.lstsq`` is (solution,
  residuals, rank, singular values): on CUDA ``torch.linalg.lstsq``
  offers only ``gels``, which takes full-rank inputs and returns no rank
  or singular values.
- The decompositions (``qr``, ``svd``, ``eig``, ``eigh``) are LAPACK's
  and cuSOLVER's: their columns' signs and phases may differ from
  XLA's. The tests compare them by reconstruction and by their sorted
  spectra (ROADMAP queue C).
- ``eig`` / ``eigvals`` run on the tensor's device (the JAX package
  calls numpy on the host); ``torch.linalg.eig`` on a CUDA tensor
  copies the matrix to the host inside the call (MAGMA's general
  eigensolver runs there), a round trip that queue C records.
- ``histogram`` bins on the device: float32 data with the JAX package's
  float32 formula, integer and float64 data with ``np.histogram``'s
  float64 edges (the JAX package's eager host path for them).
- ``matmul_int8`` runs the port's int8 kernels (``kernels/int8.py``:
  the row quantizer and the int8 x int8 matmul) on CUDA tensors, their
  plain versions on CPU tensors.
"""
from __future__ import annotations

import torch

from ..core.tensor import to_tensor_arg
from ..kernels import int8 as _i8
from .math import bmm, dot, matmul, mm  # noqa: F401 - Paddle's surface

__all__ = ["einsum", "norm", "dist", "cholesky", "inv", "inverse",
           "matrix_rank", "det", "slogdet", "qr", "svd", "eig", "eigh",
           "eigvals", "eigvalsh", "solve", "triangular_solve",
           "cholesky_solve", "lstsq", "matrix_power", "pinv", "multi_dot",
           "cross", "cov", "corrcoef", "bincount", "histogram",
           "matmul_int8", "cond", "lu", "lu_unpack", "matmul", "mm", "bmm",
           "dot"]


def _t(x):
    return to_tensor_arg(x)


def einsum(equation, *operands):
    return torch.einsum(equation, *[_t(o) for o in operands])


def norm(x, p=2, axis=None, keepdim=False, name=None):
    """The JAX package's vector norm over ``axis`` (every axis by
    default; ``"fro"`` over two axes is the 2-norm of their elements)."""
    x = _t(x)
    if isinstance(axis, (list, tuple)):
        axis = tuple(axis)
        if p == "fro" and len(axis) == 2:
            p = 2
    dim = axis if axis is None or isinstance(axis, tuple) else (axis,)
    if p == "fro" or (p == 2 and axis is None):
        return torch.sqrt(torch.sum(torch.square(x), dim=dim,
                                    keepdim=keepdim))
    if p in (float("inf"), "inf"):
        return torch.amax(torch.abs(x), dim=dim or (), keepdim=keepdim)
    if p in (float("-inf"), "-inf"):
        return torch.amin(torch.abs(x), dim=dim or (), keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), dim=dim, keepdim=keepdim)
    if p == 1:
        return torch.sum(torch.abs(x), dim=dim, keepdim=keepdim)
    return torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=dim,
                               keepdim=keepdim), 1.0 / p)


def dist(x, y, p=2, name=None):
    return norm(_t(x) - _t(y), p=p)


def cholesky(x, upper=False, name=None):
    return torch.linalg.cholesky(_t(x), upper=upper)


def inv(x, name=None):
    return torch.linalg.inv(_t(x))


inverse = inv


def matrix_rank(x, tol=None, hermitian=False, name=None):
    if isinstance(tol, torch.Tensor):
        tol = tol.item()
    if tol is None:
        return torch.linalg.matrix_rank(_t(x), hermitian=hermitian)
    return torch.linalg.matrix_rank(_t(x), atol=tol, rtol=0.0,
                                    hermitian=hermitian)


def det(x, name=None):
    return torch.linalg.det(_t(x))


def slogdet(x, name=None):
    """``[sign, log|det|]`` stacked on a new first axis."""
    sign, logabs = torch.linalg.slogdet(_t(x))
    return torch.stack([sign, logabs])


def qr(x, mode="reduced", name=None):
    q, r = torch.linalg.qr(_t(x), mode=mode)
    return r if mode == "r" else (q, r)


def svd(x, full_matrices=False, name=None):
    """``(U, S, V)``: Paddle returns V, not V^H (the transpose of
    ``vh``, not its conjugate, as the JAX package's ``swapaxes``)."""
    u, s, vh = torch.linalg.svd(_t(x), full_matrices=full_matrices)
    return u, s, vh.transpose(-1, -2)


def eig(x, name=None):
    return torch.linalg.eig(_t(x))


def eigh(x, UPLO="L", name=None):  # noqa: N803 - Paddle's name
    return torch.linalg.eigh(_t(x), UPLO=UPLO)


def eigvals(x, name=None):
    return torch.linalg.eigvals(_t(x))


def eigvalsh(x, UPLO="L", name=None):  # noqa: N803 - Paddle's name
    return torch.linalg.eigvalsh(_t(x), UPLO=UPLO)


def solve(x, y, name=None):
    return torch.linalg.solve(_t(x), _t(y))


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    """``solve_triangular(x, y)``; ``transpose`` solves with x^T."""
    a, b = _t(x), _t(y)
    if transpose:
        a, upper = a.transpose(-1, -2), not upper
    vec = b.ndim == 1
    out = torch.linalg.solve_triangular(a, b[:, None] if vec else b,
                                        upper=upper,
                                        unitriangular=unitriangular)
    return out[:, 0] if vec else out


def cholesky_solve(x, y, upper=False, name=None):
    """Solve ``A z = x`` given A's Cholesky factor ``y``."""
    return torch.cholesky_solve(_t(x), _t(y), upper=upper)


def lstsq(x, y, rcond=None, driver=None, name=None):
    """``jnp.linalg.lstsq``: the SVD least-squares solution with
    singular values under ``rcond * s_max`` dropped (default ``rcond``
    ``eps * max(M, N)``), the summed squared residuals (only when the
    rank is N < M; else empty), the rank and the singular values. One
    host read (the rank, which sizes the residuals)."""
    a, b = _t(x), _t(y)
    vec = b.ndim == a.ndim - 1
    if vec:
        b = b[..., None]
    m, n = a.shape[-2:]
    if rcond is None:
        rcond = torch.finfo(a.dtype).eps * max(m, n)
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    keep = s > rcond * s[..., :1]
    inv_s = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    sol = vh.transpose(-1, -2).conj() @ (inv_s[..., None] * (
        u.transpose(-1, -2).conj() @ b))
    rank = keep.sum(-1)
    if bool((rank == n).all()) and m > n:
        resid = torch.sum(torch.abs(a @ sol - b) ** 2, dim=-2)
    else:
        resid = torch.empty((0,), dtype=a.dtype, device=a.device)
    return (sol[..., 0] if vec else sol), resid, rank.to(torch.int32), s


def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(_t(x), int(n))


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return torch.linalg.pinv(_t(x), rtol=rcond, hermitian=hermitian)


def multi_dot(x, name=None):
    return torch.linalg.multi_dot([_t(a) for a in x])


def cross(x, y, axis=9, name=None):
    """The cross product along ``axis`` (default 9: the first axis of
    size 3, Paddle's rule)."""
    x, y = _t(x), _t(y)
    if axis == 9:
        axis = next(i for i, s in enumerate(x.shape) if s == 3)
    return torch.linalg.cross(x, y, dim=axis)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    """``jnp.cov`` as the JAX package calls it: the weights are ignored
    there, and so here."""
    x = _t(x)
    return torch.cov(x if rowvar else x.t(), correction=1 if ddof else 0)


def corrcoef(x, rowvar=True, name=None):
    x = _t(x)
    return torch.corrcoef(x if rowvar else x.t())


def bincount(x, weights=None, minlength=0, name=None):
    """Counts (or summed weights) per value, ``max(x) + 1`` long at
    least ``minlength`` (one host read: the length)."""
    x = _t(x)
    w = None if weights is None else _t(weights)
    out = torch.bincount(x.long(), weights=w, minlength=int(minlength))
    return out if w is None else out.to(w.dtype)


def histogram(input, bins=100, min=0, max=0, name=None):  # noqa: A002
    """int64 counts of ``bins`` equal bins over ``[min, max]`` (the
    data's range when both are 0), the last bin closed, values outside
    dropped; on the tensor's device."""
    x = _t(input).reshape(-1)
    if x.dtype in (torch.int64, torch.int32, torch.float64):
        return _histogram_f64(x.to(torch.float64), bins, min, max)
    xf = x.to(torch.float32)
    if min == 0 and max == 0:
        lo, hi = xf.min(), xf.max()
    else:
        lo = torch.tensor(float(min), dtype=torch.float32, device=x.device)
        hi = torch.tensor(float(max), dtype=torch.float32, device=x.device)
    width = torch.clamp(hi - lo, min=1e-30)
    idx = torch.floor((xf - lo) / width * bins).to(torch.int64)
    idx = torch.clamp(idx, max=bins - 1)
    idx = torch.where((xf >= lo) & (xf <= hi), idx,
                      torch.full_like(idx, bins))
    return torch.bincount(idx, minlength=bins + 1)[:bins]


def _histogram_f64(x, bins, min, max):  # noqa: A002
    """``np.histogram``'s binning in float64: the index from the scaled
    offset, then moved by one where the value falls across an edge."""
    if min == 0 and max == 0:
        lo, hi = x.min(), x.max()
    else:
        lo = torch.tensor(float(min), dtype=torch.float64, device=x.device)
        hi = torch.tensor(float(max), dtype=torch.float64, device=x.device)
    same = hi == lo
    lo, hi = torch.where(same, lo - 0.5, lo), torch.where(same, hi + 0.5, hi)
    edges = torch.linspace(0, 1, bins + 1, dtype=torch.float64,
                           device=x.device) * (hi - lo) + lo
    keep = (x >= lo) & (x <= hi)
    xv = x[keep]
    idx = ((xv - lo) * (bins / (hi - lo))).to(torch.int64)
    idx = torch.where(idx == bins, idx - 1, idx)
    idx = idx - (xv < edges[idx]).to(torch.int64)
    idx = idx + ((xv >= edges[idx + 1]) & (idx != bins - 1)).to(torch.int64)
    return torch.bincount(idx, minlength=bins)[:bins]


def matmul_int8(x, y, name=None):
    """int8 quantize-matmul-dequantize: float x quantized per row and
    float y per output column (absmax, the row quantizer over y^T), the
    int8 x int8 product summed exactly and rescaled in float32; int8
    inputs take unit scales. ``K`` must be a multiple of 16 on the
    card. Cut from the gradient, as the JAX op is."""
    x, y = _t(x).detach(), _t(y).detach()
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if x2.dtype == torch.int8:
        xq, xs = x2.contiguous(), torch.ones((x2.shape[0], 1),
                                             dtype=torch.float32,
                                             device=x.device)
    else:
        xq, xs = _i8.quantize_rows(x2.float().contiguous())
    if y.dtype == torch.int8:
        wqt, ws = y.t().contiguous(), torch.ones(
            (y.shape[1], 1), dtype=torch.float32, device=y.device)
    else:
        wqt, ws = _i8.quantize_rows(y.float().t().contiguous())
    out = _i8.int8_matmul(xq, xs, wqt, ws)
    return out.reshape(*shape[:-1], y.shape[-1])


def cond(x, p=None, name=None):
    return torch.linalg.cond(_t(x), 2 if p is None else p)


def lu(x, pivot=True, get_infos=False, name=None):
    """Packed LU and 1-based int32 pivots (LAPACK's); with
    ``get_infos`` an int32 info tensor of zeros, as the JAX package's."""
    if not pivot:
        raise NotImplementedError("lu requires pivot=True")
    x = _t(x)
    lu_mat, piv = torch.linalg.lu_factor(x)
    piv = piv.to(torch.int32)
    if get_infos:
        return lu_mat, piv, torch.zeros(x.shape[:-2] or (1,),
                                        dtype=torch.int32, device=x.device)
    return lu_mat, piv


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """``(P, L, U)`` with ``A = P L U``."""
    return torch.lu_unpack(_t(x), _t(y).to(torch.int32))
