"""``Layer`` and ``Parameter`` (counterpart of
``paddle_tpu/nn/layer/layers.py``).

``Layer`` is a ``torch.nn.Module`` with Paddle's methods, so the port's
``TrainStep``, ``amp.decorate`` and optimizers take a ``Layer`` model as
they take any module: ``parameters()`` returns a list,
``create_parameter`` makes a :class:`Parameter` from an initializer,
``register_buffer(persistable=)``, ``set_state_dict`` (``load_dict``)
loads Paddle's structured names (``layer1.0.bn1._mean``; ``state_dict``
is torch's, whose names are the same; a tensor registered under two
names, as a tied weight is, loads from either; after
``amp.decorate(save_dtype=)`` ``state_dict`` casts its floating
tensors), ``to(dtype=)`` (``astype``) casts every floating parameter
*and* buffer, as the JAX ``Layer.to`` does, and ``clear_gradients``,
``add_parameter``, ``sublayers`` and ``full_name``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ...core import dtypes as _dt
from ...core.device import to_torch_device
from ...core.tensor import Tensor, from_numpy
from ..initializer import (Constant, XavierNormal, XavierUniform,
                           global_initializer)

__all__ = ["Parameter", "Layer", "layer_state_from_jax", "create_parameter",
           "functional_layer"]


class Parameter(Tensor, torch.nn.Parameter):
    """A trainable leaf ``Tensor`` (``stop_gradient`` False unless made
    with ``requires_grad=False``); ``torch.nn.Module`` registers it as a
    parameter."""

    def __new__(cls, data=None, requires_grad=True):
        if data is None:
            data = torch.empty(0)
        with torch._C.DisableTorchFunctionSubclass():
            plain = data.detach()
        param = torch.Tensor._make_subclass(cls, plain, requires_grad)
        if _PARAMETER_HOOK:
            _PARAMETER_HOOK[0](param)
        return param


def create_parameter(shape, dtype=None, initializer=None, is_bias=False,
                     trainable=True, name=None, default_initializer=None,
                     device=None) -> Parameter:
    """A free-standing parameter: ``initializer`` (else
    ``default_initializer``, else the one ``set_global_initializer``
    set, else zeros for a bias and Xavier-normal for a weight) on
    ``device`` (default: the current device)."""
    init = initializer or default_initializer or global_initializer(is_bias)
    if init is None:
        init = Constant(0.0) if is_bias else XavierNormal()
    value = init([int(s) for s in shape],
                 _dt.convert_dtype(dtype) or _dt.get_default_dtype(), device)
    p = Parameter(value, requires_grad=trainable)
    if name is not None:
        p.name = name
    return p


def _groups(own) -> Dict[int, List[str]]:
    """The names of each tensor of a ``state_dict(keep_vars=True)``,
    grouped by the tensor (a shared one has several)."""
    groups: Dict[int, List[str]] = {}
    for k, t in own.items():
        groups.setdefault(id(t), []).append(k)
    return groups


# called with every new Parameter (the static recorder registers the
# parameters made in static mode with the startup program)
_PARAMETER_HOOK: list = []


def set_parameter_hook(hook) -> None:
    _PARAMETER_HOOK[:] = [hook]


class Layer(torch.nn.Module):
    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = _dt.convert_dtype(dtype)
        self._full_name = name_scope or type(self).__name__.lower()

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, device=None) -> Parameter:
        """A new parameter of ``shape`` on ``device`` (default: the
        current device), filled by ``attr.initializer``, else
        the one ``set_global_initializer`` set, else
        ``default_initializer``, else zeros for a bias and Xavier-uniform
        for a weight. The global initializer ranks below ``attr``'s and
        above the layer's default, as in Paddle (the JAX
        ``Layer.create_parameter`` does not read it)."""
        init, trainable = None, True
        if attr is not None and attr is not False:
            init = getattr(attr, "initializer", None)
            trainable = getattr(attr, "trainable", True)
        init = init or global_initializer(is_bias) or default_initializer
        if init is None:
            init = Constant(0.0) if is_bias else XavierUniform()
        value = init(shape, _dt.convert_dtype(dtype) or self._dtype, device)
        return Parameter(value, requires_grad=trainable)

    def parameters(self, include_sublayers: bool = True) -> List[Parameter]:
        return list(super().parameters(recurse=include_sublayers))

    def register_buffer(self, name, tensor, persistable=True,
                        persistent=None):
        super().register_buffer(
            name, tensor, persistable if persistent is None else persistent)
        return tensor

    def add_sublayer(self, name, sublayer):
        self.add_module(name, sublayer)
        return sublayer

    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def sublayers(self, include_self=False) -> List["Layer"]:
        """Every layer below this one, depth first (and this one first
        with ``include_self``)."""
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def full_name(self) -> str:
        """The name scope given at construction, else the class name in
        lower case (the JAX package's scheme)."""
        return self.__dict__.get("_full_name") or type(self).__name__.lower()

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def named_sublayers(self, prefix="", include_self=False):
        for name, m in self.named_modules(prefix=prefix):
            if m is not self or include_self:
                yield name, m

    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, output)`` after each forward (a result
        other than None replaces the output); returns a handle whose
        ``remove()`` takes it off."""
        return self.register_forward_hook(hook)

    def clear_gradients(self) -> None:
        for p in self.parameters():
            p.grad = None

    def to(self, device=None, dtype=None, blocking=None):
        """Move to ``device`` (a Paddle or torch name) and/or cast every
        floating parameter and buffer to ``dtype`` (a Paddle name or a
        torch dtype), in place; the parameter objects stay."""
        if isinstance(device, torch.dtype):
            device, dtype = None, device
        kwargs = {}
        if device is not None:
            kwargs["device"] = to_torch_device(device)
        if dtype is not None:
            kwargs["dtype"] = _dt.convert_dtype(dtype)
        return super().to(**kwargs) if kwargs else self

    def state_dict(self, *args, prefix="", keep_vars=False, **kwargs):
        """torch's ``state_dict``; after ``amp.decorate(save_dtype=...)``
        (``_save_dtype``) every floating tensor of this layer comes as a
        copy in that dtype, as the JAX ``Layer.state_dict`` gives it (not
        with ``keep_vars=True``, which returns the tensors themselves)."""
        sd = super().state_dict(*args, prefix=prefix, keep_vars=keep_vars,
                                **kwargs)
        save_dtype = getattr(self, "_save_dtype", None)
        if save_dtype is None or keep_vars:
            return sd
        dtype = _dt.convert_dtype(save_dtype)
        for k, v in sd.items():
            if k.startswith(prefix) and v.is_floating_point():
                sd[k] = v.detach().to(dtype)
        return sd

    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name=True
                       ) -> Tuple[List[str], List[str]]:
        """Copy ``state_dict`` (structured name -> tensor or array) into
        the layer's parameters and buffers, each keeping its own dtype
        and device; returns ``(missing, unexpected)`` names: a tensor the
        layer holds under several names (a tied weight) is missing only
        when none of them is given. Raises on a shape that differs."""
        own = self.state_dict(keep_vars=True)
        unexpected = [k for k in state_dict if k not in own]
        for name, value in state_dict.items():
            if name not in own:
                continue
            target = own[name]
            src = (value.detach() if isinstance(value, torch.Tensor)
                   else from_numpy(np.asarray(value)))
            if tuple(src.shape) != tuple(target.shape):
                raise ValueError(f"shape mismatch for {name}: "
                                 f"{tuple(target.shape)} vs {tuple(src.shape)}")
            target.copy_(src.to(device=target.device, dtype=target.dtype))
        missing = [k for names in _groups(own).values()
                   if not any(n in state_dict for n in names) for k in names]
        return missing, unexpected

    load_dict = set_state_dict


def layer_state_from_jax(arrays: Dict[str, np.ndarray], model: Layer
                         ) -> Layer:
    """Carry a JAX ``Layer``'s weights into the port's ``model`` in place
    and return it: ``arrays`` is the JAX model's ``state_dict()`` as
    numpy arrays (parameters and buffers, BatchNorm's ``_mean`` and
    ``_variance`` included) under the structured names both packages
    share (the JAX ``state_dict`` names a shared tensor once, under its
    first name). Raises on a missing or extra name or a shape that
    differs."""
    missing, extra = model.set_state_dict(arrays)
    if missing or extra:
        raise KeyError(f"names differ: missing {sorted(missing)}, extra "
                       f"{sorted(extra)}")
    return model


def functional_layer(name, fn, call=None, **defaults):
    """A ``Layer`` class ``name`` over the functional ``fn``: it keeps
    ``defaults`` (overridden in order or by keyword at construction)
    and its forward is ``fn(*inputs, **values)``, or ``call(fn, inputs,
    values)`` where the inputs map to ``fn`` otherwise."""
    keys = list(defaults)

    class _Layer(Layer):
        def __init__(self, *args, name=None, **kwargs):
            super().__init__()
            self._values = {**defaults, **dict(zip(keys, args)), **kwargs}

        def forward(self, *inputs):
            if call is not None:
                return call(fn, inputs, self._values)
            return fn(*inputs, **self._values)

        def extra_repr(self):
            return ", ".join(f"{k}={v}" for k, v in self._values.items())

    _Layer.__name__ = _Layer.__qualname__ = name
    return _Layer
