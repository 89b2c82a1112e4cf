"""``paddle.onnx``: ONNX export.

Counterpart of ``paddle_tpu/onnx/__init__.py`` (reference:
``python/paddle/onnx/export.py``, which delegates to paddle2onnx). The
export is native and offline: the layer's forward goes through
``torch.export`` and its core ATen ops are lowered to the JAX exporter's
ONNX-13 op set (``_export.py``), written with the hand-rolled protobuf
encoder (``_proto.py``; no ``onnx`` package is needed). An op outside
that set raises naming it. The port's ``jit.save`` artifact, which
covers every op, is written at ``path`` as well (the JAX package writes
its StableHLO artifact there).
"""
from __future__ import annotations

__all__ = ["export"]


def export(layer, path: str, input_spec=None, opset_version=13, **configs):
    """Write ``<path>.onnx`` (and the ``jit.save`` artifact at
    ``<path>``); returns the ``.onnx`` path. ``input_spec``: a list of
    ``(shape, dtype)`` pairs or ``InputSpec`` with static shapes."""
    import numpy as np
    import torch
    from torch.nn.utils.stateless import _reparametrize_module
    from torch.utils import _pytree as pytree

    from .. import jit as _jit
    from ..core import dtypes as _dt
    from ..static.io import export_artifact
    from ..static.program import InputSpec
    from ._export import graph_to_onnx

    if input_spec is None:
        raise ValueError("onnx.export requires input_spec (static shapes)")
    specs, as_specs = [], []
    for s in input_spec:
        if isinstance(s, tuple):
            shape, dtype = s
            as_specs.append(InputSpec(shape=list(shape), dtype=str(dtype)))
        else:
            shape, dtype = s.shape, getattr(s, "dtype", "float32")
            as_specs.append(s)
        dtype = str(dtype).replace("torch.", "")
        specs.append((tuple(int(d) for d in shape), np.dtype(dtype)))
    _jit.save(layer, path, input_spec=as_specs)

    names, tensors = [], []
    for n, p in layer.named_parameters():
        names.append(n)
        tensors.append(p)
    for n, b in layer.named_buffers():
        if n not in names:
            names.append(n)
            tensors.append(b)

    def fwd(param_tensors, input_tensors):
        with _reparametrize_module(layer, dict(zip(names, param_tensors))):
            return pytree.tree_leaves(layer(*input_tensors))

    was_training = layer.training
    layer.eval()
    try:
        device = tensors[0].device if tensors else None
        samples = [torch.zeros(s, dtype=_dt.convert_dtype(str(d)),
                               device=device) for s, d in specs]
        exported = export_artifact(fwd, tensors,
                                   (samples, [None] * len(samples)))
        exported = exported.run_decompositions(_decompositions())
        blob = graph_to_onnx(exported, [t.detach() for t in tensors], specs,
                             graph_name=type(layer).__name__)
        onnx_path = path if path.endswith(".onnx") else path + ".onnx"
        with open(onnx_path, "wb") as f:
            f.write(blob)
        return onnx_path
    finally:
        if was_training:
            layer.train()


def _decompositions():
    """torch.export's core-ATen table without the average pools: the
    JAX exporter has no average pooling (``reduce_window_sum``), so they
    stay whole and are refused by name rather than lowered to means."""
    import torch

    aten = torch.ops.aten
    table = torch.export.default_decompositions()
    for op in (aten.avg_pool1d, aten.adaptive_avg_pool1d,
               aten.adaptive_avg_pool2d, aten.adaptive_avg_pool3d):
        table.pop(op.default, None)
    return table

