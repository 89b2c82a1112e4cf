"""Elementwise math, scans, ``cast`` and the matrix products
(counterpart of ``paddle_tpu/ops/math.py``), registered under the JAX
package's op names."""
from __future__ import annotations

import torch

from ..core import dtypes as _dt
from ..core.dispatch import defop
from ..core.tensor import to_tensor_arg

__all__ = ["add", "subtract", "multiply", "divide", "floor_divide",
           "remainder", "mod", "floor_mod", "pow", "pow_", "maximum",
           "minimum", "fmax", "fmin", "atan2", "hypot", "logaddexp",
           "nextafter", "copysign", "heaviside", "gcd", "lcm", "inner",
           "outer", "kron", "exp", "expm1", "log", "log2", "log10", "log1p",
           "sqrt", "rsqrt", "square", "abs", "sign", "floor", "ceil",
           "round", "trunc", "frac", "sin", "cos", "tan", "asin", "acos",
           "atan", "sinh", "cosh", "tanh", "asinh", "acosh", "atanh",
           "reciprocal", "neg", "erf", "erfinv", "sigmoid", "logit",
           "lgamma", "digamma", "angle", "conj", "real", "imag", "deg2rad",
           "rad2deg", "i0", "isnan", "isinf", "isfinite", "isnan_",
           "isinf_", "isfinite_", "scale", "clip", "cast", "lerp", "stanh",
           "matmul", "mm", "bmm", "dot", "addmm", "cumsum", "cumprod",
           "cummax", "cummin", "logcumsumexp", "nan_to_num", "diff",
           "trace", "increment", "multiplex"]


def _binary(name, fn):
    op = defop(name)(lambda x, y: fn(x, y))

    def wrapper(x, y, name=None):
        return op(x, y)

    wrapper.__name__ = name
    return wrapper


def _unary(name, fn, differentiable=True):
    op = defop(name, differentiable)(fn)

    def wrapper(x, name=None):
        return op(x)

    wrapper.__name__ = name
    return wrapper


def _t(x, like):
    """A Python number as a tensor of ``like``'s device and dtype (for
    torch functions that take tensors only)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.tensor(x, dtype=like.dtype if isinstance(
        like, torch.Tensor) else None, device=getattr(like, "device", None))


def _pair(fn):
    return lambda x, y: fn(_t(x, y), _t(y, x))


add = _binary("add", torch.add)
subtract = _binary("subtract", torch.sub)
multiply = _binary("multiply", torch.mul)
divide = _binary("divide", torch.true_divide)
floor_divide = _binary("floor_divide", torch.floor_divide)
remainder = _binary("remainder", torch.remainder)
mod = remainder
floor_mod = remainder
pow_ = _binary("elementwise_pow", torch.pow)
pow = pow_  # noqa: A001 - Paddle's name
maximum = _binary("maximum", torch.maximum)
minimum = _binary("minimum", torch.minimum)
fmax = _binary("fmax", _pair(torch.fmax))
fmin = _binary("fmin", _pair(torch.fmin))
atan2 = _binary("atan2", _pair(torch.atan2))
hypot = _binary("hypot", _pair(torch.hypot))
logaddexp = _binary("logaddexp", _pair(torch.logaddexp))
nextafter = _binary("nextafter", _pair(torch.nextafter))
copysign = _binary("copysign", torch.copysign)
heaviside = _binary("heaviside", _pair(torch.heaviside))
gcd = _binary("gcd", _pair(torch.gcd))
lcm = _binary("lcm", _pair(torch.lcm))
inner = _binary("inner", torch.inner)
outer = _binary("outer", lambda x, y: torch.outer(x.reshape(-1),
                                                  y.reshape(-1)))
kron = _binary("kron", torch.kron)


def _imag(x):
    return x.imag if x.is_complex() else torch.zeros_like(x)


def _angle(x):
    return torch.angle(x) if x.is_floating_point() or x.is_complex() \
        else torch.angle(x.float())


exp = _unary("exp", torch.exp)
expm1 = _unary("expm1", torch.expm1)
log = _unary("log", torch.log)
log2 = _unary("log2", torch.log2)
log10 = _unary("log10", torch.log10)
log1p = _unary("log1p", torch.log1p)
sqrt = _unary("sqrt", torch.sqrt)
rsqrt = _unary("rsqrt", torch.rsqrt)
square = _unary("square", torch.square)
abs = _unary("abs", torch.abs)  # noqa: A001 - Paddle's name
sign = _unary("sign", torch.sign)
floor = _unary("floor", torch.floor)
ceil = _unary("ceil", torch.ceil)
round = _unary("round", torch.round)  # noqa: A001 - Paddle's name
trunc = _unary("trunc", torch.trunc)
frac = _unary("frac", lambda x: x - torch.trunc(x))
sin = _unary("sin", torch.sin)
cos = _unary("cos", torch.cos)
tan = _unary("tan", torch.tan)
asin = _unary("asin", torch.asin)
acos = _unary("acos", torch.acos)
atan = _unary("atan", torch.atan)
sinh = _unary("sinh", torch.sinh)
cosh = _unary("cosh", torch.cosh)
tanh = _unary("tanh", torch.tanh)
asinh = _unary("asinh", torch.asinh)
acosh = _unary("acosh", torch.acosh)
atanh = _unary("atanh", torch.atanh)
reciprocal = _unary("reciprocal", torch.reciprocal)
neg = _unary("neg", torch.neg)
erf = _unary("erf", torch.erf)
erfinv = _unary("erfinv", torch.erfinv)
sigmoid = _unary("sigmoid", torch.sigmoid)
logit = _unary("logit", torch.logit)
lgamma = _unary("lgamma", torch.lgamma)
digamma = _unary("digamma", torch.digamma)
angle = _unary("angle", _angle)
conj = _unary("conj", torch.conj_physical)
real = _unary("real", torch.real)
imag = _unary("imag", _imag)
deg2rad = _unary("deg2rad", torch.deg2rad)
rad2deg = _unary("rad2deg", torch.rad2deg)
i0 = _unary("i0", torch.i0)
isnan = _unary("isnan", torch.isnan, differentiable=False)
isinf = _unary("isinf", torch.isinf, differentiable=False)
isfinite = _unary("isfinite", torch.isfinite, differentiable=False)
isnan_, isinf_, isfinite_ = isnan, isinf, isfinite


def _item(v):
    return v.item() if isinstance(v, torch.Tensor) else v


@defop("scale")
def _scale(x, scale=1.0, bias=0.0, bias_after_scale=True):
    return x * scale + bias if bias_after_scale else (x + bias) * scale


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """``x * scale + bias`` (or ``(x + bias) * scale``), then the
    activation named ``act`` of ``nn.functional``."""
    out = _scale(x, scale=float(_item(scale)), bias=float(bias),
                 bias_after_scale=bias_after_scale)
    if act is not None:
        from ..nn import functional as F

        out = getattr(F, act)(out)
    return out


@defop("clip")
def _clip(x, min=None, max=None):  # noqa: A002
    return torch.clamp(x, min, max)


def clip(x, min=None, max=None, name=None):  # noqa: A002
    return _clip(x, min=_item(min), max=_item(max))


@defop("cast")
def _cast(x, dtype=None):
    return x.to(dtype)


def cast(x, dtype):
    """``x`` in ``dtype`` (a Paddle name or a torch dtype); the gradient
    is cast back, as the JAX cast's is."""
    return _cast(x, dtype=_dt.convert_dtype(dtype))


@defop("lerp")
def _lerp(x, y, w):
    return x + w * (y - x)


def lerp(x, y, weight, name=None):
    """``x + weight * (y - x)``, the JAX formula (``torch.lerp`` takes
    another one for weights of 0.5 and above)."""
    return _lerp(x, y, weight)


@defop("stanh")
def _stanh(x, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(x * scale_a)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return _stanh(x, scale_a=scale_a, scale_b=scale_b)


@defop("matmul")
def _matmul(x, y, transpose_x=False, transpose_y=False):
    if transpose_x and x.ndim > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.ndim > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """``x @ y``; bf16/fp16 products sum in float32 on cuBLAS, as the
    JAX op asks of the MXU with ``preferred_element_type``."""
    return _matmul(x, y, transpose_x=transpose_x, transpose_y=transpose_y)


def mm(x, y, name=None):
    return matmul(x, y)


def bmm(x, y, name=None):
    return matmul(x, y)


@defop("dot")
def _dot(x, y):
    return torch.sum(x * y, dim=-1)


def dot(x, y, name=None):
    return _dot(x, y)


@defop("addmm")
def _addmm(inp, x, y, beta=1.0, alpha=1.0):
    return beta * inp + alpha * torch.matmul(x, y)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):  # noqa: A002
    return _addmm(input, x, y, beta=float(beta), alpha=float(alpha))


# ------------------------------------------------------------------ scans --


def cumsum(x, axis=None, dtype=None, name=None):
    x = to_tensor_arg(x)
    if dtype is not None:
        x = cast(x, dtype)
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.cumsum(x, int(axis))


def cumprod(x, dim=None, dtype=None, name=None):
    x = to_tensor_arg(x)
    if dtype is not None:
        x = cast(x, dtype)
    if dim is None:
        x, dim = x.reshape(-1), 0
    return torch.cumprod(x, int(dim))


def _cum_extreme(x, axis, dtype, is_max):
    """(running extreme, index of its first occurrence): ties keep the
    earlier index, as the JAX scan's strict comparison does (torch's
    ``cummax`` takes the later one)."""
    x = to_tensor_arg(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    axis = int(axis) % x.ndim
    run = (torch.cummax if is_max else torch.cummin)(x, axis).values
    prev = torch.cat([run.narrow(axis, 0, 1), run.narrow(
        axis, 0, x.shape[axis] - 1)], axis) if x.shape[axis] else run
    new = (x > prev) if is_max else (x < prev)
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    pos = torch.arange(x.shape[axis], device=x.device).reshape(shape)
    new = new | (pos == 0)
    idx = torch.cummax(torch.where(new, pos, torch.zeros_like(pos)),
                       axis).values
    return run, idx.to(_dt.convert_dtype(dtype))


def cummax(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(x, axis, dtype, True)


def cummin(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(x, axis, dtype, False)


def logcumsumexp(x, axis=None, dtype=None, name=None):
    x = to_tensor_arg(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.logcumsumexp(x, int(axis))


# --------------------------------------------------------- misc numerics --


@defop("nan_to_num")
def _nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return _nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


@defop("diff")
def _diff(x, n=1, axis=-1):
    return torch.diff(x, n=n, dim=axis)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    x = to_tensor_arg(x)
    if prepend is not None or append is not None:
        parts = [to_tensor_arg(p) for p in (prepend, x, append)
                 if p is not None]
        x = torch.cat(parts, dim=axis)
    return _diff(x, n=n, axis=axis)


@defop("trace")
def _trace(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return _trace(x, offset=offset, axis1=axis1, axis2=axis2)


@torch.no_grad()
def increment(x, value=1.0, name=None):
    """``x += value`` in place."""
    return x.add_(value)


def multiplex(inputs, index, name=None):
    """Row i of the output is row i of ``inputs[index[i]]``."""
    stacked = torch.stack([to_tensor_arg(i) for i in inputs], dim=0)
    idx = to_tensor_arg(index).reshape(-1).long()
    return stacked[idx, torch.arange(stacked.shape[1], device=idx.device)]
