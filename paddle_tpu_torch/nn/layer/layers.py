"""``Layer`` and ``Parameter`` (counterpart of
``paddle_tpu/nn/layer/layers.py``).

``Layer`` is a ``torch.nn.Module`` with Paddle's methods, so the port's
``TrainStep``, ``amp.decorate`` and optimizers take a ``Layer`` model as
they take any module: ``parameters()`` returns a list,
``create_parameter`` makes a :class:`Parameter` from an initializer,
``register_buffer(persistable=)``, ``set_state_dict`` loads Paddle's
structured names (``layer1.0.bn1._mean``; ``state_dict`` is torch's,
whose names are the same), ``to(dtype=)`` casts every floating
parameter *and* buffer, as the JAX ``Layer.to`` does, and
``clear_gradients``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ...core import dtypes as _dt
from ...core.device import to_torch_device
from ...core.tensor import Tensor, from_numpy
from ..initializer import Constant, XavierUniform

__all__ = ["Parameter", "Layer", "layer_state_from_jax"]


class Parameter(Tensor, torch.nn.Parameter):
    """A trainable leaf ``Tensor`` (``stop_gradient`` False unless made
    with ``requires_grad=False``); ``torch.nn.Module`` registers it as a
    parameter."""

    def __new__(cls, data=None, requires_grad=True):
        if data is None:
            data = torch.empty(0)
        with torch._C.DisableTorchFunctionSubclass():
            plain = data.detach()
        return torch.Tensor._make_subclass(cls, plain, requires_grad)


class Layer(torch.nn.Module):
    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = _dt.convert_dtype(dtype)

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, device=None) -> Parameter:
        """A new parameter of ``shape`` on ``device`` (default: the
        current device), filled by ``attr.initializer``, else
        ``default_initializer``, else zeros for a bias and Xavier-uniform
        for a weight (the JAX ``Layer.create_parameter``'s rule)."""
        init, trainable = default_initializer, True
        if attr is not None and attr is not False:
            init = getattr(attr, "initializer", None) or init
            trainable = getattr(attr, "trainable", True)
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

    def named_sublayers(self, prefix="", include_self=False):
        for name, m in self.named_modules(prefix=prefix):
            if m is not self or include_self:
                yield name, m

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

    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name=True
                       ) -> Tuple[List[str], List[str]]:
        """Copy ``state_dict`` (structured name -> tensor or array) into
        the layer's parameters and buffers, each keeping its own dtype
        and device; returns ``(missing, unexpected)`` names. Raises on a
        shape that differs."""
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
        return [k for k in own if k not in state_dict], unexpected


def layer_state_from_jax(arrays: Dict[str, np.ndarray], model: Layer
                         ) -> Layer:
    """Carry a JAX ``Layer``'s weights into the port's ``model`` in place
    and return it: ``arrays`` is the JAX model's ``state_dict()`` as
    numpy arrays (parameters and buffers, BatchNorm's ``_mean`` and
    ``_variance`` included) under the structured names both packages
    share. Raises on a missing or extra name or a shape that differs."""
    own = model.state_dict()
    if set(arrays) != set(own):
        raise KeyError(f"names differ: missing {sorted(set(own) - set(arrays))}"
                       f", extra {sorted(set(arrays) - set(own))}")
    model.set_state_dict(arrays)
    return model
