"""``paddle.nn.utils`` (counterpart of ``paddle_tpu/nn/utils.py``):
``ParamAttr``, the weight-norm and spectral-norm reparameterisations,
the gradient clips and the parameter <-> vector packing.

``spectral_norm``'s power iterates start from
``np.random.default_rng(0)`` normals, exactly as the JAX package's, so
the two agree from the first call.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.tensor import as_tensor
from .layer.layers import Parameter

__all__ = ["ParamAttr", "weight_norm", "remove_weight_norm",
           "spectral_norm", "clip_grad_norm_", "clip_grad_value_",
           "parameters_to_vector", "vector_to_parameters"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip


def _norm_except(w, dim):
    if dim is None:
        return torch.sqrt(torch.sum(torch.square(w)))
    axes = [i for i in range(w.ndim) if i != dim]
    return torch.sqrt(torch.sum(torch.square(w), dim=axes, keepdim=True))


def weight_norm(layer, name: str = "weight", dim: int = 0):
    """``layer.<name>`` becomes ``g * v / ||v||`` (the norm over every
    axis but ``dim``, or over all with ``dim=None``), recomputed before
    each forward; the trainable parameters are ``<name>_g`` and
    ``<name>_v``."""
    if f"_weight_norm_{name}" in layer.__dict__:
        raise ValueError(f"{name!r} is already weight-normed on this layer")
    w = getattr(layer, name, None)
    if w is None:
        raise ValueError(f"layer has no parameter {name!r}")
    if dim is not None:
        dim = dim % w.ndim
    with torch.no_grad():
        g = Parameter(_norm_except(w.detach(), dim).clone())
        v = Parameter(w.detach().clone())
    del layer._parameters[name]
    layer.register_parameter(f"{name}_g", g)
    layer.register_parameter(f"{name}_v", v)

    def compute():
        return v / _norm_except(v, dim) * g

    def hook(module, inputs):
        object.__setattr__(module, name, compute())

    handle = layer.register_forward_pre_hook(hook)
    layer.__dict__[f"_weight_norm_{name}"] = (handle, dim)
    object.__setattr__(layer, name, compute())
    return layer


def remove_weight_norm(layer, name: str = "weight"):
    """Bake ``g * v / ||v||`` back into one parameter ``<name>``."""
    entry = layer.__dict__.pop(f"_weight_norm_{name}", None)
    if entry is None:
        raise ValueError(f"{name!r} is not weight-normed on this layer")
    handle, dim = entry
    handle.remove()
    g = layer._parameters.pop(f"{name}_g")
    v = layer._parameters.pop(f"{name}_v")
    with torch.no_grad():
        w = Parameter(v / _norm_except(v, dim) * g)
    layer.__dict__.pop(name, None)
    layer.register_parameter(name, w)
    return layer


def _matrix(a, dim):
    if dim != 0:
        perm = [dim] + [i for i in range(a.ndim) if i != dim]
        a = a.permute(perm)
    return a.reshape(a.shape[0], -1)


def spectral_norm(layer, name: str = "weight", n_power_iterations: int = 1,
                  eps: float = 1e-12, dim: int = 0):
    """``layer.<name>`` becomes ``<name>_orig / sigma``, sigma estimated
    by power iteration from the buffers ``<name>_u`` / ``<name>_v``,
    which advance only in training; sigma is ``u^T W v`` with u and v
    held constant (the gradient carries the ``-(dL . W) u v^T /
    sigma^2`` term)."""
    w = getattr(layer, name)
    h, wd = _matrix(w.detach(), dim).shape
    rng = np.random.default_rng(0)
    u0 = rng.normal(size=(h,)).astype(np.float32)
    v0 = rng.normal(size=(wd,)).astype(np.float32)
    u0 = u0 / (np.linalg.norm(u0) + eps)
    v0 = v0 / (np.linalg.norm(v0) + eps)
    layer.register_buffer(f"{name}_u", as_tensor(torch.as_tensor(
        u0, device=w.device)))
    layer.register_buffer(f"{name}_v", as_tensor(torch.as_tensor(
        v0, device=w.device)))
    orig = Parameter(w.detach().clone())
    del layer._parameters[name]
    layer.register_parameter(f"{name}_orig", orig)

    def compute(module):
        mat = _matrix(orig, dim)
        u, v = module._buffers[f"{name}_u"], module._buffers[f"{name}_v"]
        if module.training:
            with torch.no_grad():
                m = mat.detach()
                for _ in range(n_power_iterations):
                    v = m.t() @ u
                    v = v / (torch.linalg.vector_norm(v) + eps)
                    u = m @ v
                    u = u / (torch.linalg.vector_norm(u) + eps)
                module._buffers[f"{name}_u"].copy_(u)
                module._buffers[f"{name}_v"].copy_(v)
        sigma = (u[None, :] @ mat) @ v[:, None]
        return orig / sigma.reshape([])

    def hook(module, inputs):
        object.__setattr__(module, name, compute(module))

    layer.register_forward_pre_hook(hook)
    object.__setattr__(layer, name, compute(layer))
    return layer


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every ``.grad`` in place by ``min(max_norm / (total +
    1e-6), 1)``, total the global ``norm_type`` norm; returns the total."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return as_tensor(torch.zeros(()))
    grads = [p.grad for p in params]
    if math.isinf(norm_type):
        total = torch.max(torch.stack([g.abs().max() for g in grads]))
    else:
        total = torch.pow(sum(torch.sum(torch.pow(torch.abs(g), norm_type))
                              for g in grads), 1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError("non-finite total gradient norm")
    scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    with torch.no_grad():
        for g in grads:
            g.mul_(scale)
    return total


def clip_grad_value_(parameters, clip_value):
    params = ([parameters] if isinstance(parameters, torch.Tensor)
              else list(parameters))
    cv = abs(float(clip_value))
    with torch.no_grad():
        for p in params:
            if p.grad is not None:
                p.grad.clamp_(-cv, cv)


def parameters_to_vector(parameters, name=None):
    return torch.cat([p.reshape(-1) for p in parameters])


@torch.no_grad()
def vector_to_parameters(vec, parameters, name=None):
    params = list(parameters)
    total = sum(p.numel() for p in params)
    if total != vec.shape[0]:
        raise ValueError(f"vector length {vec.shape[0]} != total parameter "
                         f"size {total}")
    off = 0
    for p in params:
        p.copy_(vec[off:off + p.numel()].reshape(p.shape))
        off += p.numel()
