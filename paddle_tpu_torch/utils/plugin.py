"""Out-of-tree kernel plugins (the PHI C API counterpart).

Counterpart of ``paddle_tpu/utils/plugin.py`` (reference
``paddle/phi/capi/``). ``load_kernel_plugin(path)`` dlopens a shared
object built against ``plugin_abi.h`` (:func:`plugin_abi_header`: the
port's copy of the JAX package's header, the same ABI, so a plugin built
against either loads in both packages) and registers each kernel as the
op ``plugin::<name>`` in the port's registry (``core/dispatch.py``).

- ABI v1 (``PT_GetKernelRegistry``): float32 kernels whose output takes
  the first input's shape; the call checks the kernel's arity.
- ABI v2 (``PT_GetKernelRegistryV2``): float32/float64/int32/int64/
  bfloat16/uint8/bool tensors, output shapes from the kernel's
  ``infer``, int/float/str attributes as keywords, several outputs, and
  a custom vjp through a named gradient kernel (a
  ``torch.autograd.Function``; integer inputs get no gradient).
- A registry whose version is not the loader's raises.

The kernels run on host memory: CUDA inputs are copied to the host and
the outputs back to the first input's device, as the JAX package runs
them through ``jax.pure_callback``. Inside a CUDA-graph capture that is
a host read (``CaptureUnsupported``: ``jit.to_static`` runs such a
signature eagerly); a static program records each call as one op shaped
by the kernel's declared shapes.
"""
from __future__ import annotations

import ctypes
import os
from types import SimpleNamespace

import torch

from ..core.dispatch import recordable, register_op
from ..core.tensor import _wrap, to_tensor_arg

__all__ = ["load_kernel_plugin", "plugin_abi_header"]

_ABI_VERSION = 1
_ABI_VERSION_V2 = 2
_PT_MAX_RANK = 8


def plugin_abi_header() -> str:
    """Path of ``plugin_abi.h`` to compile plugins against (the port's
    copy of the JAX package's header)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                        "plugin_abi.h")


class _PTKernelDesc(ctypes.Structure):
    _fields_ = [("name", ctypes.c_char_p), ("n_inputs", ctypes.c_int32),
                ("fn", ctypes.c_void_p)]


class _PTKernelRegistry(ctypes.Structure):
    _fields_ = [("abi_version", ctypes.c_int32),
                ("n_kernels", ctypes.c_int32),
                ("kernels", ctypes.POINTER(_PTKernelDesc))]


_KERNEL_CFUNC = ctypes.CFUNCTYPE(
    None, ctypes.POINTER(ctypes.c_void_p),
    ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
    ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_void_p)


class _PTAttrValue(ctypes.Structure):
    _fields_ = [("name", ctypes.c_char_p), ("kind", ctypes.c_int32),
                ("d", ctypes.c_double), ("i", ctypes.c_int64),
                ("s", ctypes.c_char_p)]


class _PTTensorView(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p),
                ("shape", ctypes.POINTER(ctypes.c_int64)),
                ("ndim", ctypes.c_int32), ("dtype", ctypes.c_int32)]


class _PTKernelDescV2(ctypes.Structure):
    _fields_ = [("name", ctypes.c_char_p), ("n_inputs", ctypes.c_int32),
                ("n_outputs", ctypes.c_int32), ("infer", ctypes.c_void_p),
                ("fn", ctypes.c_void_p), ("vjp_kernel", ctypes.c_char_p)]


class _PTKernelRegistryV2(ctypes.Structure):
    _fields_ = [("abi_version", ctypes.c_int32),
                ("n_kernels", ctypes.c_int32),
                ("kernels", ctypes.POINTER(_PTKernelDescV2))]


_INFER_CFUNC_V2 = ctypes.CFUNCTYPE(
    ctypes.c_int32, ctypes.POINTER(_PTTensorView), ctypes.c_int32,
    ctypes.POINTER(_PTAttrValue), ctypes.c_int32,
    ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
    ctypes.POINTER(ctypes.c_int32))
_KERNEL_CFUNC_V2 = ctypes.CFUNCTYPE(
    ctypes.c_int32, ctypes.POINTER(_PTTensorView), ctypes.c_int32,
    ctypes.POINTER(_PTAttrValue), ctypes.c_int32,
    ctypes.POINTER(ctypes.c_void_p), ctypes.c_int32)

# the ABI's dtype codes
_DTYPES = {0: torch.float32, 1: torch.float64, 2: torch.int32,
           3: torch.int64, 4: torch.bfloat16, 5: torch.uint8, 6: torch.bool}
_CODES = {d: c for c, d in _DTYPES.items()}


def _host(tensors, name):
    """Contiguous host copies of ``tensors`` (a host read inside a
    capture raises ``CaptureUnsupported``)."""
    from ..jit import dy2static

    if any(dy2static.capturing(t) for t in tensors):
        dy2static._host_read(f"the plugin kernel {name}")
    return [t.detach().cpu().contiguous() for t in tensors]


# ------------------------------------------------------------------ v1 ---


def _register_v1(ns, reg):
    for i in range(reg.n_kernels):
        desc = reg.kernels[i]
        name = desc.name.decode()
        n_in = int(desc.n_inputs)
        cfn = _KERNEL_CFUNC(desc.fn)

        def run(*tensors, _cfn=cfn, _name=f"plugin::{name}"):
            host = [t.float() for t in _host(tensors, _name)]
            out = torch.empty_like(host[0])
            ptrs = (ctypes.c_void_p * len(host))(
                *[t.data_ptr() for t in host])
            shapes = [torch.tensor(list(t.shape), dtype=torch.int64)
                      for t in host]
            shape_ptrs = (ctypes.POINTER(ctypes.c_int64) * len(host))(*[
                ctypes.cast(s.data_ptr(), ctypes.POINTER(ctypes.c_int64))
                for s in shapes])
            ndims = (ctypes.c_int32 * len(host))(*[t.dim() for t in host])
            _cfn(ptrs, shape_ptrs, ndims, len(host), out.data_ptr())
            return out.to(tensors[0].device)

        body = recordable(f"plugin::{name}", lambda *t: torch.empty_like(
            t[0], dtype=torch.float32))(run)
        op = register_op(f"plugin::{name}", body, differentiable=False)

        def call(*tensors, _op=op, _n=n_in, _name=name):
            if len(tensors) != _n:
                raise TypeError(f"{_name} expects {_n} inputs")
            return _wrap(_op(*[to_tensor_arg(t) for t in tensors]))

        setattr(ns, name, call)


# ------------------------------------------------------------------ v2 ---


def _marshal_attrs(attrs):
    keep = []
    arr = (_PTAttrValue * max(len(attrs), 1))()
    for j, (name, value) in enumerate(attrs):
        nb = name.encode()
        keep.append(nb)
        a = _PTAttrValue(name=nb, kind=0, d=0.0, i=0, s=None)
        if isinstance(value, (bool, int)):
            a.kind, a.i = 1, int(value)
        elif isinstance(value, float):
            a.kind, a.d = 0, float(value)
        elif isinstance(value, str):
            sb = value.encode()
            keep.append(sb)
            a.kind, a.s = 2, sb
        else:
            raise TypeError(
                f"plugin attr {name}={value!r}: only int/float/str/bool")
        arr[j] = a
    return arr, keep


def _views(metas, datas):
    views = (_PTTensorView * max(len(metas), 1))()
    keep = []
    for j, ((shape, code), ptr) in enumerate(zip(metas, datas)):
        sh = (ctypes.c_int64 * max(len(shape), 1))(*[int(s) for s in shape])
        keep.append(sh)
        views[j] = _PTTensorView(
            data=ptr, shape=ctypes.cast(sh, ctypes.POINTER(ctypes.c_int64)),
            ndim=len(shape), dtype=code)
    return views, keep


def _code(dtype):
    if dtype not in _CODES:
        raise TypeError(f"plugin ABI v2 does not carry dtype {dtype}")
    return _CODES[dtype]


class _V2Kernel:
    def __init__(self, desc):
        self.name = desc.name.decode()
        self.n_inputs = int(desc.n_inputs)
        self.n_outputs = int(desc.n_outputs)
        self.infer = _INFER_CFUNC_V2(desc.infer)
        self.fn = _KERNEL_CFUNC_V2(desc.fn)
        self.vjp_kernel = (desc.vjp_kernel.decode()
                           if desc.vjp_kernel else None)

    def infer_specs(self, in_metas, attrs):
        """``[(shape, dtype)]`` of the inputs -> those of the outputs (the
        kernel's InferMeta; it sees no data)."""
        metas = [(tuple(s), _code(d)) for s, d in in_metas]
        views, keep = _views(metas, [None] * len(metas))
        attr_arr, akeep = _marshal_attrs(attrs)
        out_shapes = (ctypes.c_int64 * (self.n_outputs * _PT_MAX_RANK))()
        out_ndims = (ctypes.c_int32 * self.n_outputs)()
        out_dtypes = (ctypes.c_int32 * self.n_outputs)()
        rc = self.infer(views, len(metas), attr_arr, len(attrs),
                        out_shapes, out_ndims, out_dtypes)
        if rc != 0:
            raise RuntimeError(f"plugin {self.name}: infer failed rc={rc}")
        return [(tuple(int(out_shapes[o * _PT_MAX_RANK + d])
                       for d in range(int(out_ndims[o]))),
                 _DTYPES[int(out_dtypes[o])])
                for o in range(self.n_outputs)]

    def run(self, tensors, attrs):
        """The kernel on host copies of ``tensors``; the outputs on the
        first input's device."""
        host = _host(tensors, f"plugin::{self.name}")
        specs = self.infer_specs([(t.shape, t.dtype) for t in host], attrs)
        views, keep = _views([(tuple(t.shape), _code(t.dtype)) for t in host],
                             [t.data_ptr() for t in host])
        attr_arr, akeep = _marshal_attrs(attrs)
        outs = [torch.empty(s, dtype=d) for s, d in specs]
        out_ptrs = (ctypes.c_void_p * max(len(outs), 1))(
            *[o.data_ptr() for o in outs])
        rc = self.fn(views, len(host), attr_arr, len(attrs), out_ptrs,
                     len(outs))
        if rc != 0:
            raise RuntimeError(f"plugin {self.name}: kernel rc={rc}")
        return [o.to(tensors[0].device) for o in outs]

    def infer_fake(self, tensors, attrs):
        return [tensors[0].new_empty(s, dtype=d) for s, d in
                self.infer_specs([(t.shape, t.dtype) for t in tensors],
                                 attrs)]


def _differentiable(k, gk):
    """``k`` with ``gk`` as its vjp: ``gk(inputs..., grad_outputs...)``
    gives the inputs' gradients (none for integer inputs)."""

    class _PluginFn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, attrs, *tensors):
            ctx.attrs = attrs
            ctx.save_for_backward(*tensors)
            outs = k.run(list(tensors), attrs)
            return tuple(outs) if len(outs) > 1 else outs[0]

        @staticmethod
        def backward(ctx, *gouts):
            saved = list(ctx.saved_tensors)
            grads = gk.run(saved + [g.contiguous() for g in gouts],
                           ctx.attrs)
            return (None, *[g.to(a.dtype) if a.is_floating_point() else None
                            for a, g in zip(saved, grads)])

    return _PluginFn


def _register_v2(ns, kernels):
    by_name = {k.name: k for k in kernels}
    for k in kernels:
        fn = None
        if k.vjp_kernel is not None:
            gk = by_name.get(k.vjp_kernel)
            if gk is None:
                raise RuntimeError(f"plugin {k.name}: vjp kernel "
                                   f"{k.vjp_kernel!r} not in registry")
            fn = _differentiable(k, gk)

        def run(*tensors, _attrs=(), _k=k, _fn=fn):
            if _fn is not None:
                return _fn.apply(_attrs, *tensors)
            outs = _k.run(list(tensors), _attrs)
            return tuple(outs) if len(outs) > 1 else outs[0]

        def infer(*tensors, _attrs=(), _k=k):
            outs = _k.infer_fake(tensors, _attrs)
            return tuple(outs) if len(outs) > 1 else outs[0]

        body = recordable(f"plugin::{k.name}", infer)(run)
        op = register_op(f"plugin::{k.name}", body,
                         differentiable=k.vjp_kernel is not None)

        def call(*tensors, _op=op, _k=k, **attrs):
            if len(tensors) != _k.n_inputs:
                raise TypeError(f"{_k.name} expects {_k.n_inputs} inputs")
            return _wrap(_op(*[to_tensor_arg(t) for t in tensors],
                             _attrs=tuple(sorted(attrs.items()))))

        setattr(ns, k.name, call)


def load_kernel_plugin(path):
    """Load the plugin at ``path``: a namespace with one callable per
    kernel (v2 kernels first, then v1)."""
    lib = ctypes.CDLL(path)
    ns = SimpleNamespace()
    ns._lib = lib  # keep the dlopen handle alive
    get_v2 = getattr(lib, "PT_GetKernelRegistryV2", None)
    if get_v2 is not None:
        get_v2.restype = ctypes.POINTER(_PTKernelRegistryV2)
        reg2 = get_v2().contents
        if reg2.abi_version != _ABI_VERSION_V2:
            raise RuntimeError(f"plugin ABI {reg2.abi_version} != supported "
                               f"{_ABI_VERSION_V2}")
        _register_v2(ns, [_V2Kernel(reg2.kernels[i])
                          for i in range(reg2.n_kernels)])
    get_v1 = getattr(lib, "PT_GetKernelRegistry", None)
    if get_v1 is None:
        if get_v2 is None:
            raise RuntimeError(f"{path}: exports neither PT_GetKernelRegistry "
                               "nor PT_GetKernelRegistryV2")
        return ns
    get_v1.restype = ctypes.POINTER(_PTKernelRegistry)
    reg = get_v1().contents
    if reg.abi_version != _ABI_VERSION:
        raise RuntimeError(f"plugin ABI {reg.abi_version} != supported "
                           f"{_ABI_VERSION}")
    _register_v1(ns, reg)
    return ns
