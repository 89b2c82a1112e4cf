"""``save_inference_model`` / ``load_inference_model``: exported programs.

Counterpart of ``paddle_tpu/static/io.py``. The JAX package serializes
the pruned forward as StableHLO through ``jax.export`` with a symbolic
batch dimension; here the same forward (the pruned records replayed, the
parameters as inputs) goes through ``torch.export`` with every unknown
dimension a ``torch.export.Dim`` shared by all feeds at the same axis
(:func:`symbolic_feed_specs`), and is written with ``torch.export.save``
beside the parameters and a small signature. ``jit.save`` writes the
same files. The format is the port's own: the JAX package cannot read
it, nor the port the JAX package's. An exported inference program runs
the test-mode form of its records (dropout off, as
``clone(for_test=True)`` gives it).

Files: ``{prefix}.pdmodel`` (the signature, pickled), ``{prefix}.pt2``
(the exported program) and ``{prefix}.pdiparams`` (the parameter
tensors, ``torch.save``).
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.tensor import as_tensor, from_numpy
from .program import (Program, _TEST_MODE_REWRITES, bind_feeds, prune_ops,
                      replaying, run_ops)

__all__ = ["symbolic_feed_specs", "export_artifact", "write_artifact",
           "read_artifact", "save_inference_model", "load_inference_model",
           "ExportedProgram"]

_FORMAT_VERSION = 1
# 1 = static.save_inference_model export, 2 = jit.save export
SUPPORTED_ARTIFACT_VERSIONS = (1, 2)


def symbolic_feed_specs(shapes_dtypes, device=None):
    """``(declared_shape, dtype)`` pairs -> ``(samples, dynamic_shapes)``
    for ``torch.export``: every unknown dim gets a ``Dim`` shared per axis
    position, so e.g. image and label feeds keep one batch dim (axis 0);
    the sample sizes of axis ``a`` are ``2 + a``. Distinct unknown dims
    at one axis across feeds are not supported: pass concrete shapes."""
    axis_dims: Dict[int, object] = {}
    samples, dynamic = [], []
    for shape, dtype in shapes_dtypes:
        dims, spec = [], {}
        for axis, d in enumerate(shape):
            if d is None or int(d) < 0:
                if axis not in axis_dims:
                    axis_dims[axis] = torch.export.Dim(f"d{axis}", min=1)
                spec[axis] = axis_dims[axis]
                dims.append(2 + axis)
            else:
                dims.append(int(d))
        samples.append(torch.zeros(dims, dtype=dtype, device=device))
        dynamic.append(spec or None)
    return samples, dynamic


class _Exported(torch.nn.Module):
    """``fwd(params, feeds)`` as a module of two lists of tensors (the
    exported program is called the same way)."""

    def __init__(self, fwd):
        super().__init__()
        self._fwd = fwd

    def forward(self, params, feeds):
        return list(self._fwd(params, feeds))


def export_artifact(fwd, params, feed_specs):
    """``torch.export`` of ``fwd(param_tensors, feed_tensors) -> list``
    with the parameters as plain inputs and ``feed_specs = (samples,
    dynamic_shapes)``. Shared by ``save_inference_model`` and
    ``jit.save``."""
    samples, dynamic = feed_specs
    plain = [p.detach().as_subclass(torch.Tensor) for p in params]
    with replaying():             # the static recorder records nothing
        return torch.export.export(
            _Exported(fwd), (plain, samples),
            dynamic_shapes=([None] * len(plain), list(dynamic)),
            strict=False)


def write_artifact(path_prefix: str, meta: Dict, exported,
                   param_tensors) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path_prefix)) or ".",
                exist_ok=True)
    with open(path_prefix + ".pdmodel", "wb") as f:
        pickle.dump(meta, f, protocol=4)
    torch.export.save(exported, path_prefix + ".pt2")
    torch.save([t.detach().as_subclass(torch.Tensor).cpu()
                for t in param_tensors], path_prefix + ".pdiparams")


def read_artifact(path_prefix: str, params_path=None):
    """``(meta, exported, params)``; the parameters on the device the
    program was exported on."""
    from ..kernels import flash_attention  # noqa: F401 — registers the ops

    with open(path_prefix + ".pdmodel", "rb") as f:
        meta = pickle.load(f)  # noqa: S301 — the port's own artifact
    if meta.get("format_version") not in SUPPORTED_ARTIFACT_VERSIONS:
        raise ValueError(
            f"unsupported model format: {meta.get('format_version')}")
    with replaying():
        exported = torch.export.load(path_prefix + ".pt2")
    params = torch.load(params_path or path_prefix + ".pdiparams",
                        weights_only=True)
    dev = torch.device(meta["device"])
    return meta, exported, [p.to(dev) for p in params]


def _forward_fn(program: Program, feed_vars, fetch_vars, params):
    ops = [rec.with_func(rec.op_name + "@test",
                         _TEST_MODE_REWRITES[rec.op_name](rec))
           if rec.op_name in _TEST_MODE_REWRITES else rec
           for rec in prune_ops(program, fetch_vars)]

    def fwd(param_tensors, feed_tensors):
        env = {id(v): t for v, t in zip(feed_vars, feed_tensors)}
        by_param = {id(p): t for p, t in zip(params, param_tensors)}
        run_ops(ops, env, bind_feeds(program, env),
                param_lookup=lambda p: by_param.get(id(p), p))
        return [env[id(v)] for v in fetch_vars]

    return fwd


def save_inference_model(path_prefix: str, feed_vars, fetch_vars,
                         executor=None, program: Optional[Program] = None,
                         **kwargs) -> None:
    """Export the pruned forward program and its parameters (see the
    module docstring for the files)."""
    feed_vars = list(feed_vars) if isinstance(feed_vars, (list, tuple)) \
        else [feed_vars]
    fetch_vars = list(fetch_vars) if isinstance(fetch_vars, (list, tuple)) \
        else [fetch_vars]
    program = program or feed_vars[0].program
    params = program.all_parameters()
    fwd = _forward_fn(program, feed_vars, fetch_vars, params)
    specs = symbolic_feed_specs([(v.desc_shape, v.dtype) for v in feed_vars],
                                device=feed_vars[0].device)
    exported = export_artifact(fwd, params, specs)
    meta = {
        "format_version": _FORMAT_VERSION,
        "feed_names": [v.name for v in feed_vars],
        "fetch_names": [v.name for v in fetch_vars],
        "feed_shapes": [list(v.desc_shape) for v in feed_vars],
        "feed_dtypes": [str(v.dtype) for v in feed_vars],
        "n_params": len(params),
        "device": str(feed_vars[0].device),
    }
    write_artifact(path_prefix, meta, exported, params)


_TORCH_DTYPES = {str(d): d for d in (
    torch.float32, torch.float64, torch.float16, torch.bfloat16, torch.int8,
    torch.int16, torch.int32, torch.int64, torch.uint8, torch.bool)}


class ExportedProgram:
    """A loaded inference program: callable with numpy arrays or tensors,
    and an ``Executor.run`` target."""

    def __init__(self, meta: Dict, exported, params: List[torch.Tensor]):
        self._meta = meta
        self._module = exported.module()
        self._params = params
        self.feed_names: List[str] = meta["feed_names"]
        self.fetch_names: List[str] = meta["fetch_names"]
        self._device = torch.device(meta["device"])

    def _feeds(self, values) -> List[torch.Tensor]:
        out = []
        for i, val in enumerate(values):
            t = (val.detach().as_subclass(torch.Tensor)
                 if isinstance(val, torch.Tensor)
                 else from_numpy(np.asarray(val)))
            out.append(t.to(device=self._device,
                            dtype=_TORCH_DTYPES[self._meta["feed_dtypes"][i]]))
        return out

    def _call(self, values):
        with torch.no_grad(), replaying():
            return self._module(self._params, self._feeds(values))

    def _run(self, feed: Dict[str, object], return_numpy=True):
        missing = [n for n in self.feed_names if n not in feed]
        if missing:
            raise ValueError(f"missing feed {missing[0]!r}")
        outs = self._call([feed[n] for n in self.feed_names])
        if return_numpy:
            from .executor import _to_numpy

            return [_to_numpy(o) for o in outs]
        return [as_tensor(o) for o in outs]

    def __call__(self, *args):
        return [as_tensor(o) for o in self._call(args)]

    def clone(self, for_test=False):
        return self


def load_inference_model(path_prefix: str, executor=None, params_path=None,
                         **kwargs):
    """``[program, feed_names, fetch_names]``, as the reference."""
    meta, exported, params = read_artifact(path_prefix, params_path)
    prog = ExportedProgram(meta, exported, params)
    return [prog, prog.feed_names, prog.fetch_names]

