"""``paddle.utils.cpp_extension``: JIT-compiled host C++ custom ops.

Counterpart of ``paddle_tpu/utils/cpp_extension.py`` (reference:
``python/paddle/utils/cpp_extension/cpp_extension.py``). User C++
exports plain C symbols with the JAX package's contract::

    extern "C" void my_op(const float* in, float* out,
                          const int64_t* shape, int64_t ndim);

(``out`` has ``in``'s shape). :func:`load` compiles the sources with
``g++`` into the port's own build directory (``get_build_directory``:
``~/.cache/paddle_tpu_torch_extensions``, or ``PADDLE_TORCH_EXTENSION_DIR``),
cached by a hash of the sources and flags, binds each symbol through
ctypes and registers it as the non-differentiable op ``cpp::<symbol>``.

The op runs on host memory. Called with a CUDA tensor it copies the
tensor to the host, runs, and copies the result back to the tensor's
device: the JAX semantics, where the op is a ``jax.pure_callback`` (a
host op on the TPU too). Inside a CUDA-graph capture that copy is a
host read, so it raises ``CaptureUnsupported`` (``jit.to_static`` runs
such a signature eagerly); a static program records it as one op. The
device route for a user's kernel is ``utils.cuda_op``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
from typing import List, Optional, Sequence

import torch

from ..core.dispatch import recordable, register_op

__all__ = ["load", "CppExtension", "CUDAExtension", "BuildExtension",
           "get_build_directory"]

_DEFAULT_BUILD_DIR = os.path.join(
    os.path.expanduser("~"), ".cache", "paddle_tpu_torch_extensions")


def get_build_directory(verbose=False) -> str:
    d = os.environ.get("PADDLE_TORCH_EXTENSION_DIR", _DEFAULT_BUILD_DIR)
    os.makedirs(d, exist_ok=True)
    return d


def _compile(name: str, sources: Sequence[str], extra_cxx_flags, build_dir,
             verbose: bool) -> str:
    srcs = [os.path.abspath(s) for s in sources]
    h = hashlib.sha1()
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    h.update(" ".join(extra_cxx_flags or []).encode())
    so = os.path.join(build_dir, f"{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
           *(extra_cxx_flags or []), *srcs, "-o", tmp]
    if verbose:
        print("compiling:", " ".join(cmd))
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(
            f"cpp_extension build failed:\n"
            f"{e.stderr.decode(errors='replace')}") from e
    os.replace(tmp, so)
    return so


def host_call(name: str, x: torch.Tensor, run) -> torch.Tensor:
    """``run(host_tensor) -> host_tensor`` on a float32 host copy of
    ``x``, the result on ``x``'s device; a host read inside a capture
    raises ``CaptureUnsupported``."""
    from ..jit import dy2static

    if dy2static.capturing(x):
        dy2static._host_read(f"the host op {name}")
    out = run(x.detach().to("cpu", torch.float32).contiguous())
    return out.to(x.device)


class _LoadedOp:
    """One C symbol as the op ``cpp::<symbol>``."""

    def __init__(self, lib: ctypes.CDLL, symbol: str):
        self._fn = getattr(lib, symbol)
        self._fn.restype = None
        self._fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_void_p, ctypes.c_longlong]
        self.symbol = symbol
        self.name = f"cpp::{symbol}"

        def host(x: torch.Tensor) -> torch.Tensor:
            out = torch.empty_like(x)
            shape = torch.tensor(list(x.shape), dtype=torch.int64)
            self._fn(x.data_ptr(), out.data_ptr(), shape.data_ptr(),
                     x.dim())
            return out

        @recordable(self.name, lambda x: torch.empty_like(
            x, dtype=torch.float32))
        def body(x):
            return host_call(self.name, x, host)

        self._op = register_op(self.name, body, differentiable=False)

    def __call__(self, x):
        from ..core.tensor import _wrap, to_tensor_arg

        return _wrap(self._op(to_tensor_arg(x)))


class _LoadedModule:
    def __init__(self, lib_path: str, symbols: List[str]):
        self._lib = ctypes.CDLL(lib_path)
        self._path = lib_path
        for s in symbols:
            setattr(self, s, _LoadedOp(self._lib, s))

    def __repr__(self):
        return f"CppExtensionModule({os.path.basename(self._path)})"


def _discover_symbols(sources: Sequence[str]) -> List[str]:
    """Exported op symbols: ``void name(`` inside ``extern "C"``."""
    out = []
    pat = re.compile(r'void\s+([A-Za-z_]\w*)\s*\(')
    for s in sources:
        with open(s) as f:
            text = f.read()
        for m in re.finditer(
                r'extern\s+"C"\s*(?:\{(.*?)\}|([^;{]*\{)|([^;]*;))',
                text, re.S):
            chunk = next(g for g in m.groups() if g is not None)
            out.extend(pat.findall(chunk))
    return list(dict.fromkeys(out))


def load(name: str, sources: Sequence[str], extra_cxx_flags=None,
         extra_cuda_cflags=None, extra_ldflags=None, build_directory=None,
         verbose: bool = False, functions: Optional[List[str]] = None):
    """Compile and load host C++ ops (reference ``cpp_extension.load``):
    a module-like object with one callable per exported symbol
    (``functions`` overrides the discovery)."""
    if extra_cuda_cflags:
        raise RuntimeError("cpp_extension builds host C++ only; a device "
                           "kernel goes through paddle_tpu_torch.utils."
                           "cuda_op")
    build_dir = build_directory or get_build_directory()
    os.makedirs(build_dir, exist_ok=True)
    so = _compile(name, sources, extra_cxx_flags, build_dir, verbose)
    symbols = functions or _discover_symbols(sources)
    if not symbols:
        raise ValueError(
            "no extern \"C\" void symbols found in sources; export ops as "
            "extern \"C\" void my_op(const float*, float*, const int64_t*, "
            "int64_t)")
    return _LoadedModule(so, symbols)


class CppExtension:
    """setuptools-style spec (reference parity), built by
    ``BuildExtension`` through :func:`load`."""

    def __init__(self, sources, *args, **kwargs):
        self.sources = list(sources)
        self.kwargs = kwargs


def CUDAExtension(*args, **kwargs):  # noqa: N802 — reference name
    raise RuntimeError("CUDAExtension is not taken: a device kernel goes "
                       "through paddle_tpu_torch.utils.cuda_op (nvcc, "
                       "ctypes, torch.library); host C++ uses CppExtension")


class BuildExtension:
    """Minimal stand-in: builds CppExtension sources."""

    def __init__(self, *a, **k):
        pass

    @classmethod
    def with_options(cls, **options):
        return cls

    def build_extension(self, ext: CppExtension, name="custom_ops"):
        return load(name, ext.sources, **ext.kwargs)
