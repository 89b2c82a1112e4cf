"""A numpy evaluator for the graphs ``paddle_tpu_torch.onnx.export``
writes (its ONNX-13 op set only), to check an export where no ONNX
runtime is installed: ``chip_smoke.py``'s ONNX phase runs the exported
file through ``run``. Convolutions sum in float64 and round to the
input's dtype."""
from __future__ import annotations

import math

import numpy as np

from paddle_tpu_torch.onnx._proto import decode_model

__all__ = ["run"]

_CAST = {1: np.float32, 3: np.int8, 6: np.int32, 7: np.int64, 9: np.bool_}
_BINARY = {"Add": np.add, "Sub": np.subtract, "Mul": np.multiply,
           "Div": np.divide, "Max": np.maximum, "Min": np.minimum,
           "Pow": np.power, "And": np.logical_and, "Or": np.logical_or,
           "Xor": np.logical_xor, "Greater": np.greater, "Less": np.less,
           "Equal": np.equal, "MatMul": np.matmul}
_UNARY = {"Relu": lambda x: np.maximum(x, 0).astype(x.dtype),
          "Tanh": np.tanh, "Exp": np.exp, "Log": np.log, "Sqrt": np.sqrt,
          "Neg": np.negative, "Abs": np.abs, "Floor": np.floor,
          "Ceil": np.ceil, "Sign": np.sign, "Sin": np.sin, "Cos": np.cos,
          "Not": np.logical_not, "Identity": lambda x: x,
          "Sigmoid": lambda x: (1 / (1 + np.exp(-x))).astype(x.dtype),
          "Reciprocal": lambda x: (1 / x).astype(x.dtype),
          "Erf": lambda x: np.vectorize(math.erf)(x).astype(x.dtype)}


def _att(n, name, default=None):
    a = n["attrs"].get(name)
    if a is None:
        return default
    if "i" in a:
        return a["i"]
    if a.get("ints"):
        return a["ints"]
    return a.get("f", default)


def _windows(x, kernel, strides, dilations):
    """``[N, C, Ho, Wo, kh, kw]`` views of padded ``x``."""
    eff = [(k - 1) * d + 1 for k, d in zip(kernel, dilations)]
    win = np.lib.stride_tricks.sliding_window_view(x, eff, axis=(2, 3))
    win = win[:, :, ::strides[0], ::strides[1], ::dilations[0],
              ::dilations[1]]
    return win


def _pad(x, pads, value):
    k = len(pads) // 2
    width = [(0, 0), (0, 0)] + list(zip(pads[:k], pads[k:]))
    return np.pad(x, width, constant_values=value)


def _conv(n, x, w, b=None):
    strides = _att(n, "strides", [1, 1])
    dil = _att(n, "dilations", [1, 1])
    pads = _att(n, "pads", [0, 0, 0, 0])
    win = _windows(_pad(x, pads, 0), w.shape[2:], strides, dil)
    out = np.einsum("nchwkl,ockl->nohw", win.astype(np.float64),
                    w.astype(np.float64))
    if b is not None:
        out = out + b.astype(np.float64).reshape(1, -1, 1, 1)
    return out.astype(x.dtype)


def _max_pool(n, x):
    kernel = _att(n, "kernel_shape")
    win = _windows(_pad(x, _att(n, "pads", [0, 0, 0, 0]), -np.inf), kernel,
                   _att(n, "strides", [1, 1]), [1, 1])
    return win.max(axis=(-2, -1))


def run(model_bytes: bytes, feeds):
    m = decode_model(model_bytes)
    g = m["graph"]
    env = dict(g["initializers"])
    for vi, arr in zip(g["inputs"], feeds):
        if list(np.shape(arr)) != vi["shape"]:
            raise ValueError(f"input {vi['name']}: shape {np.shape(arr)}, "
                             f"the graph wants {vi['shape']}")
        env[vi["name"]] = np.asarray(arr)
    for n in g["nodes"]:
        i = [env[x] for x in n["inputs"]]
        op = n["op_type"]
        if op in _BINARY:
            r = _BINARY[op](i[0], i[1])
        elif op in _UNARY:
            r = _UNARY[op](i[0])
        elif op == "Mod":
            r = np.fmod(i[0], i[1]) if _att(n, "fmod", 0) \
                else np.mod(i[0], i[1])
        elif op == "Reshape":
            r = i[0].reshape([int(d) for d in i[1]])
        elif op == "Transpose":
            r = np.transpose(i[0], _att(n, "perm"))
        elif op == "Expand":
            shape = [int(d) for d in i[1]]
            r = np.broadcast_to(i[0].reshape(
                [1] * (len(shape) - i[0].ndim) + list(i[0].shape)), shape)
        elif op == "Unsqueeze":
            r = np.expand_dims(i[0], tuple(int(d) for d in i[1]))
        elif op == "Squeeze":
            r = np.squeeze(i[0], tuple(int(d) for d in i[1]))
        elif op == "Cast":
            r = i[0].astype(_CAST[_att(n, "to")])
        elif op == "ReduceSum":
            r = i[0].sum(axis=tuple(int(d) for d in i[1]),
                         keepdims=bool(_att(n, "keepdims", 1)))
        elif op in ("ReduceMax", "ReduceMin"):
            fn = np.max if op == "ReduceMax" else np.min
            r = fn(i[0], axis=tuple(_att(n, "axes")),
                   keepdims=bool(_att(n, "keepdims", 1)))
        elif op == "Where":
            r = np.where(i[0], i[1], i[2])
        elif op == "Concat":
            r = np.concatenate(i, axis=_att(n, "axis"))
        elif op == "Conv":
            r = _conv(n, *i)
        elif op == "MaxPool":
            r = _max_pool(n, i[0])
        else:
            raise NotImplementedError(f"onnx runtime: op {op}")
        env[n["outputs"][0]] = np.asarray(r)
    return [env[v["name"]] for v in g["outputs"]]
