"""Custom ops from Python: ``custom_op`` (functions on tensors) and
``cuda_op`` (a hand-written CUDA kernel).

Counterpart of ``paddle_tpu/utils/custom_op.py``. ``custom_op`` registers
a function on torch tensors in the op registry: torch differentiates it,
or, with ``backward=``, it is a ``torch.autograd.Function`` whose
``fwd`` returns ``(out, residuals)`` and whose ``backward(residuals,
grad)`` returns the inputs' gradients. ``cuda_op`` is the counterpart of
``pallas_op``: where the JAX package registers a user's Pallas kernel as
an op, the port registers a user's ``__global__`` function, built with
``nvcc`` for ``sm_90a`` at first use and launched on the current
stream, as a ``torch.library`` custom op.
"""
from __future__ import annotations

import ctypes
import re
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from ..core import dtypes as _dt
from ..core.dispatch import defop, register_op
from ..kernels import _build

__all__ = ["custom_op", "cuda_op", "ShapeDtypeStruct", "LAUNCHES"]

# launches of each cuda_op kernel, by op name: a plain count, added to
# where the kernel is launched and nowhere else
LAUNCHES: Dict[str, int] = {}


def custom_op(name: str, fn: Optional[Callable] = None, *,
              backward: Optional[Callable] = None,
              num_residuals: Optional[int] = None,
              differentiable: bool = True):
    """Register a custom op on tensors. Positional arguments are
    tensors, keyword arguments static, as for built-in ops.

    Autodiff backward::

        @custom_op("my_gelu")
        def my_gelu(x):
            return 0.5 * x * (1 + torch.tanh(0.79788456 * (x + 0.044715 * x**3)))

    Custom backward (``fwd`` returns ``(out, residuals)``, ``bwd`` takes
    ``(residuals, grad_out)`` and returns one gradient per positional
    argument)::

        my_relu = custom_op("my_relu", lambda x: (x.clamp(min=0), (x,)),
                            backward=lambda res, g: (g * (res[0] > 0),))
    """

    def build(f):
        if backward is None:
            return defop(name, differentiable=differentiable)(f)

        class _CustomBackward(torch.autograd.Function):
            @staticmethod
            def forward(ctx, kwargs, *args):
                out, res = f(*args, **kwargs)
                res = tuple(res) if isinstance(res, (list, tuple)) else (res,)
                ctx.is_tensor = [isinstance(r, torch.Tensor) for r in res]
                ctx.others = [None if t else r
                              for r, t in zip(res, ctx.is_tensor)]
                ctx.save_for_backward(*(r for r in res
                                        if isinstance(r, torch.Tensor)))
                ctx.n_args = len(args)
                return out

            @staticmethod
            def backward(ctx, g):
                saved = iter(ctx.saved_tensors)
                res = tuple(next(saved) if t else o
                            for t, o in zip(ctx.is_tensor, ctx.others))
                grads = backward(res, g)
                grads = tuple(grads) if isinstance(grads, (list, tuple)) \
                    else (grads,)
                return (None, *grads, *[None] * (ctx.n_args - len(grads)))

        def apply(*args, **kwargs):
            return _CustomBackward.apply(kwargs, *args)

        return defop(name)(apply)

    if fn is not None:
        return build(fn)
    return build


class ShapeDtypeStruct(NamedTuple):
    """An output's shape and dtype, as ``out_shape_fn`` declares it (the
    counterpart of ``jax.ShapeDtypeStruct``; the dtype may be a Paddle
    name)."""
    shape: tuple
    dtype: object


# pointer element types a cuda_op kernel may take, and their dtypes
_POINTEE = {"float": torch.float32, "double": torch.float64,
            "__half": torch.float16, "half": torch.float16,
            "__nv_bfloat16": torch.bfloat16, "nv_bfloat16": torch.bfloat16,
            "int8_t": torch.int8, "signed char": torch.int8,
            "uint8_t": torch.uint8, "unsigned char": torch.uint8,
            "int16_t": torch.int16, "short": torch.int16,
            "int": torch.int32, "int32_t": torch.int32,
            "int64_t": torch.int64, "long long": torch.int64,
            "bool": torch.bool}


def kernel_pointer_dtypes(source: str, kernel: str) -> List[torch.dtype]:
    """The dtypes of ``kernel``'s pointer parameters, read from its
    ``__global__ void kernel(...)`` signature in ``source``. Raises
    ``ValueError`` unless the parameters are pointers to types of
    ``_POINTEE`` followed by one ``int64_t`` count."""
    m = re.search(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?"
                  + re.escape(kernel) + r"\s*\(([^)]*)\)", source)
    if m is None:
        raise ValueError(f"cuda_op: no `__global__ void {kernel}(...)` in "
                         "the source")
    *pointers, count = [p.strip() for p in m.group(1).split(",")]
    if not re.fullmatch(r"(?:const\s+)?(?:int64_t|long\s+long)\s+\w+",
                        count):
        raise ValueError(f"cuda_op: {kernel}'s last parameter must be the "
                         f"int64_t element count, not {count!r}")
    dtypes = []
    for p in pointers:
        tokens = p.replace("*", " * ").split()
        if tokens.count("*") != 1:
            raise ValueError(f"cuda_op: {kernel}'s parameter {p!r} is not "
                             "a pointer")
        base = " ".join(t for t in tokens[:tokens.index("*")]
                        if t != "const")
        if base not in _POINTEE:
            raise ValueError(f"cuda_op: {kernel}'s parameter {p!r}: element "
                             f"type {base!r} is not one of {sorted(_POINTEE)}")
        dtypes.append(_POINTEE[base])
    if not dtypes:
        raise ValueError(f"cuda_op: {kernel} takes no pointers")
    return dtypes


def launcher_source(source: str, kernel: str, n_pointers: int) -> str:
    """``source`` with an ``extern "C"`` launcher appended: it casts each
    of ``n_pointers`` data pointers and the count to the kernel's own
    parameter types and launches ``kernel`` on the given grid, block and
    stream, returning ``cudaGetLastError()``."""
    args = ", ".join([f"ptrs[{i}]" for i in range(n_pointers)]
                     + ["(int64_t)n"])
    return f"""{source}

// ---- launcher added by paddle_tpu_torch.utils.custom_op.cuda_op ----
#include <cstdint>
#include <cuda_runtime.h>

template <typename... P, typename... A>
static cudaError_t paddle_tpu_launch_(void (*kernel)(P...), dim3 grid,
                                      dim3 block, cudaStream_t stream,
                                      A... args) {{
  static_assert(sizeof...(P) == sizeof...(A),
                "cuda_op: the kernel's parameter count");
  kernel<<<grid, block, 0, stream>>>(static_cast<P>(args)...);
  return cudaGetLastError();
}}

extern "C" int paddle_tpu_cuda_op_launch(void* const* ptrs, long long n,
                                         unsigned gx, unsigned gy,
                                         unsigned gz, unsigned block,
                                         void* stream) {{
  return (int)paddle_tpu_launch_({kernel}, dim3(gx, gy, gz), dim3(block),
                                 (cudaStream_t)stream, {args});
}}
"""


class _CudaOp:
    """What ``cuda_op`` registered under ``name``: the torch op calls
    :meth:`run` and its fake implementation :meth:`fake`."""

    def __init__(self, name, source, kernel, out_shape_fn, grid_fn, block,
                 reference):
        self.name = name
        self.kernel = kernel
        self.pointer_dtypes = kernel_pointer_dtypes(source, kernel)
        self.source = launcher_source(source, kernel,
                                      len(self.pointer_dtypes))
        self.out_shape_fn = out_shape_fn
        self.grid_fn = grid_fn
        self.block = int(block)
        self.reference = reference
        self.library = f"cuda_op_{name}"

    def out_specs(self, xs):
        spec = self.out_shape_fn(*xs)
        specs = list(spec) if isinstance(spec, (list, tuple)) and not \
            isinstance(spec, ShapeDtypeStruct) else [spec]
        return [(tuple(int(d) for d in s.shape), _dt.convert_dtype(s.dtype))
                for s in specs]

    def fake(self, xs):
        return [xs[0].new_empty(shape, dtype=dtype)
                for shape, dtype in self.out_specs(xs)]

    def run(self, xs):
        specs = self.out_specs(xs)
        if xs[0].device.type != "cuda":
            return self._reference(xs, specs)
        self._check(xs, specs)
        outs = [torch.empty(shape, dtype=dtype, device=xs[0].device)
                for shape, dtype in specs]
        self._launch(xs, outs)
        return outs

    def _reference(self, xs, specs):
        if self.reference is None:
            raise RuntimeError(f"cuda_op {self.name!r}: the kernel runs on "
                               "CUDA tensors only, and no reference was "
                               "given for the CPU")
        out = self.reference(*xs)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        got = [(tuple(o.shape), o.dtype) for o in outs]
        if got != specs:
            raise RuntimeError(f"cuda_op {self.name!r}: the reference gave "
                               f"{got}, out_shape_fn declares {specs}")
        return outs

    def _check(self, xs, specs):
        want = self.pointer_dtypes
        if len(xs) + len(specs) != len(want):
            raise ValueError(f"cuda_op {self.name!r}: {len(xs)} inputs and "
                             f"{len(specs)} outputs for a kernel of "
                             f"{len(want)} pointers")
        for i, x in enumerate(xs):
            if x.device != xs[0].device or x.dtype != want[i]:
                raise ValueError(f"cuda_op {self.name!r}: input {i} is "
                                 f"{x.dtype} on {x.device}; the kernel "
                                 f"takes {want[i]} on {xs[0].device}")
            if not x.is_contiguous():
                raise ValueError(f"cuda_op {self.name!r}: input {i} is not "
                                 "contiguous")
        for j, (_, dtype) in enumerate(specs):
            if dtype != want[len(xs) + j]:
                raise ValueError(f"cuda_op {self.name!r}: output {j} is "
                                 f"declared {dtype}; the kernel writes "
                                 f"{want[len(xs) + j]}")

    def _launch(self, xs, outs):
        n = xs[0].numel()
        grid = (tuple(int(g) for g in self.grid_fn(*xs)) if self.grid_fn
                else (max(1, -(-n // self.block)),))
        grid = grid + (1,) * (3 - len(grid))
        lib = _build.load_source(self.library, self.source)
        fn = lib.paddle_tpu_cuda_op_launch
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_longlong,
                       ctypes.c_uint, ctypes.c_uint, ctypes.c_uint,
                       ctypes.c_uint, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        ptrs = (ctypes.c_void_p * (len(xs) + len(outs)))(
            *[t.data_ptr() for t in (*xs, *outs)])
        with torch.cuda.device(xs[0].device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(ptrs, n, *grid, self.block, stream)
        if err:
            raise RuntimeError(f"cuda_op {self.name!r}: launch of "
                               f"{self.kernel} on grid {grid} x block "
                               f"{self.block} failed, cudaError {err}")
        LAUNCHES[self.name] = LAUNCHES.get(self.name, 0) + 1


_CUDA_OPS: Dict[str, _CudaOp] = {}


def cuda_op(name: str, source: str, kernel: str, out_shape_fn: Callable,
            grid_fn: Optional[Callable] = None, block: int = 256,
            reference: Optional[Callable] = None):
    """Register a hand-written CUDA kernel as the op ``name``: the
    counterpart of the JAX package's ``pallas_op``.

    ``source`` is CUDA C++ holding ``__global__ void kernel(...)``. The
    kernel's contract: its parameters are the inputs' data pointers,
    then the outputs' data pointers, then the first input's element
    count as ``int64_t``; each pointer's element type (``float``,
    ``__nv_bfloat16``, ``int64_t`` ...) is the dtype its tensor must
    have. ``out_shape_fn(*inputs)`` returns a :class:`ShapeDtypeStruct`
    (or a list of them) for the outputs, which the op allocates;
    ``grid_fn(*inputs)`` returns the grid (1 to 3 block counts), by
    default ``ceil(n / block)``; ``block`` is the threads per block.

    The op is ``torch.ops.paddle_tpu.<name>``, registered with
    ``torch.library.custom_op`` with a fake implementation built from
    ``out_shape_fn``, so shapes are inferred without running it (as
    ``jax.eval_shape`` infers them). On CUDA tensors it checks the
    inputs' dtypes, device and contiguity and the declared outputs'
    dtypes, builds the source with an added ``extern "C"`` launcher at
    first use (``nvcc``, ``sm_90a``, into ``kernels/build/``) and
    launches it on the current stream; a failed build or launch raises,
    and nothing falls back. On CPU tensors it runs ``reference``, the
    plain PyTorch version (what ``interpret=True`` is to ``pallas_op``),
    and raises if there is none. Like ``pallas_op``'s, the op is not
    differentiable. Registering a name again replaces its kernel and
    functions, as the JAX registry replaces an op.

    Returns a function of the input tensors that returns the output
    tensor (a tuple for several outputs); it carries the op's source
    with its launcher as ``.source`` and, as ``.build_sources``, the
    library to build ahead of the first launch
    (``kernels._build.build(sources=...)``)."""
    spec = _CudaOp(name, source, kernel, out_shape_fn, grid_fn, block,
                   reference)
    if name not in _CUDA_OPS:
        lib_op = torch.library.custom_op(
            f"paddle_tpu::{name}", lambda xs: _CUDA_OPS[name].run(xs),
            mutates_args=(), schema="(Tensor[] xs) -> Tensor[]")
        lib_op.register_fake(lambda xs: _CUDA_OPS[name].fake(xs))
    _CUDA_OPS[name] = spec
    torch_op = getattr(torch.ops.paddle_tpu, name)

    def call(*xs):
        if not xs:
            raise ValueError(f"cuda_op {name!r}: the launch contract needs "
                             "at least one input (its element count)")
        outs = torch_op(list(xs))
        return outs[0] if len(outs) == 1 else tuple(outs)

    registered = register_op(name, call, differentiable=False)

    def op(*xs):
        return registered(*xs)

    op.op, op.source, op.name = registered, spec.source, name
    op.build_sources = {spec.library: spec.source}
    return op
