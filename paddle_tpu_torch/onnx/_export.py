"""``torch.export`` graph -> ONNX-13 graph, for the JAX exporter's op set.

Counterpart of ``paddle_tpu/onnx/_export.py``, which lowers a jaxpr's
primitives. Here the layer's forward is exported with ``torch.export``
(parameters and buffers as inputs), decomposed to core ATen ops, and
each op is lowered to the ONNX-13 nodes the JAX exporter emits: MatMul,
Conv, MaxPool, Add / Sub / Mul / Div / Pow / Max / Min, the unary math,
Reshape / Transpose / Squeeze / Unsqueeze / Expand / Concat, Cast,
ReduceSum / ReduceMax / ReduceMin, Where, the comparisons and the
logical ops, Mod (with fmod=1). An op whose inputs are all constants
(the parameters, or anything computed from them alone) is evaluated and
becomes an initializer. Any other op raises ``NotImplementedError``
naming it. Everything the exporter keeps lives in one call, so a refused
export leaves nothing behind.
"""
from __future__ import annotations

import math
import operator
from typing import Dict, List

import numpy as np
import torch

from . import _proto as P

_DT = {
    np.dtype("float32"): P.FLOAT,
    np.dtype("int64"): P.INT64,
    np.dtype("int32"): P.INT32,
    np.dtype("bool"): P.BOOL,
    np.dtype("int8"): P.INT8,
}
_TORCH_DT = {torch.float32: P.FLOAT, torch.int64: P.INT64,
             torch.int32: P.INT32, torch.bool: P.BOOL, torch.int8: P.INT8}

_A = torch.ops.aten
_BINARY = {_A.add.Tensor: "Add", _A.sub.Tensor: "Sub", _A.mul.Tensor: "Mul",
           _A.div.Tensor: "Div", _A.maximum.default: "Max",
           _A.minimum.default: "Min", _A.pow.Tensor_Tensor: "Pow",
           _A.pow.Tensor_Scalar: "Pow", _A.add.Scalar: "Add",
           _A.sub.Scalar: "Sub", _A.mul.Scalar: "Mul", _A.div.Scalar: "Div"}
_UNARY = {_A.relu.default: "Relu", _A.tanh.default: "Tanh",
          _A.exp.default: "Exp", _A.log.default: "Log",
          _A.sqrt.default: "Sqrt", _A.neg.default: "Neg",
          _A.abs.default: "Abs", _A.sigmoid.default: "Sigmoid",
          _A.floor.default: "Floor", _A.ceil.default: "Ceil",
          _A.sign.default: "Sign", _A.erf.default: "Erf",
          _A.sin.default: "Sin", _A.cos.default: "Cos",
          _A.reciprocal.default: "Reciprocal", _A.clone.default: "Identity",
          _A.alias.default: "Identity", _A.detach.default: "Identity",
          _A.logical_not.default: "Not"}
_COMPARE = {"gt": ("Greater", False), "lt": ("Less", False),
            "eq": ("Equal", False), "ge": ("Less", True),
            "le": ("Greater", True), "ne": ("Equal", True)}
_LOGICAL = {_A.logical_and.default: "And", _A.logical_or.default: "Or",
            _A.logical_xor.default: "Xor"}
_RESHAPES = (_A.view.default, _A.reshape.default, _A._unsafe_view.default)
_SKIP = (_A._assert_tensor_metadata.default,)


class _Const:
    """A value known at export time (a parameter or a folded op)."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


class _Ctx:
    def __init__(self):
        self.nodes: List[bytes] = []
        self.initializers: List[bytes] = []
        self.counter = 0
        self._const_names: Dict[int, str] = {}

    def fresh(self, hint="t"):
        self.counter += 1
        return f"{hint}_{self.counter}"

    def const(self, arr, hint="const"):
        arr = np.ascontiguousarray(arr)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        if arr.dtype not in _DT:
            raise NotImplementedError(
                f"onnx export: initializer dtype {arr.dtype}")
        name = self.fresh(hint)
        self.initializers.append(
            P.tensor_proto(name, arr.shape, _DT[arr.dtype], arr.tobytes()))
        return name

    def const_of(self, c: _Const):
        key = id(c)
        if key not in self._const_names:
            v = c.value
            arr = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                   else np.asarray(v, np.float32 if isinstance(v, float)
                                   else None))
            self._const_names[key] = self.const(arr, "w")
        return self._const_names[key]

    def add(self, op, ins, attrs=()):
        out = self.fresh(op.lower())
        self.nodes.append(P.node(op, list(ins), [out], attrs=list(attrs)))
        return out


def _ints(name, values):
    return P.attribute(name, ints=[int(v) for v in values])


def _is_tensor_value(a):
    return isinstance(a, (str, _Const))


def _refuse(node, why=""):
    raise NotImplementedError(
        f"onnx export: unsupported op '{node.target}'{why} -- the "
        "portable artifact (paddle.jit.save) covers the full op set")


def _lower(ctx: _Ctx, node, args, kwargs):
    """The ONNX name of ``node``'s output (args already mapped: graph
    tensors to names, constants to ``_Const``)."""
    t = node.target

    def name(a):
        if isinstance(a, _Const):
            return ctx.const_of(a)
        if isinstance(a, str):
            return a
        return ctx.const_of(_Const(a))

    if t in _UNARY:
        return ctx.add(_UNARY[t], [name(args[0])])
    if t in _BINARY:
        if t in (_A.add.Tensor, _A.sub.Tensor) and kwargs.get("alpha", 1) != 1:
            _refuse(node, " with alpha")
        if kwargs.get("rounding_mode") is not None:
            _refuse(node, " with a rounding mode")
        b = args[1]
        if not _is_tensor_value(b):
            b = _Const(np.asarray(b, _np_dtype(node)))
        return ctx.add(_BINARY[t], [name(args[0]), name(b)])
    if t in _LOGICAL:
        return ctx.add(_LOGICAL[t], [name(args[0]), name(args[1])])
    base = getattr(t, "_overloadpacket", None)
    op_name = getattr(base, "__name__", "")
    if op_name in _COMPARE:
        op, negate = _COMPARE[op_name]
        b = args[1]
        if not _is_tensor_value(b):
            b = _Const(np.asarray(b, _np_dtype(node.args[0])))
        out = ctx.add(op, [name(args[0]), name(b)])
        return ctx.add("Not", [out]) if negate else out
    if t == _A.rsqrt.default:
        return ctx.add("Reciprocal", [ctx.add("Sqrt", [name(args[0])])])
    if t == _A.gelu.default:
        if kwargs.get("approximate", "none") != "none":
            _refuse(node, " (tanh approximation)")
        x = name(args[0])
        inner = ctx.add("Div", [x, ctx.const(np.float32(math.sqrt(2.0)))])
        one_p = ctx.add("Add", [ctx.add("Erf", [inner]),
                                ctx.const(np.float32(1.0))])
        half_x = ctx.add("Mul", [x, ctx.const(np.float32(0.5))])
        return ctx.add("Mul", [half_x, one_p])
    if t in (_A.mm.default, _A.bmm.default, _A.matmul.default):
        return ctx.add("MatMul", [name(args[0]), name(args[1])])
    if t == _A.addmm.default:
        if kwargs.get("beta", 1) != 1 or kwargs.get("alpha", 1) != 1:
            _refuse(node, " with beta or alpha")
        mm = ctx.add("MatMul", [name(args[1]), name(args[2])])
        return ctx.add("Add", [mm, name(args[0])])
    if t in _RESHAPES:
        shape = np.asarray(list(node.meta["val"].shape), np.int64)
        return ctx.add("Reshape", [name(args[0]), ctx.const(shape, "shape")])
    if t == _A.permute.default:
        return ctx.add("Transpose", [name(args[0])],
                       [_ints("perm", args[1])])
    if t in (_A.t.default, _A.numpy_T.default):
        return ctx.add("Transpose", [name(args[0])], [_ints("perm", [1, 0])])
    if t in (_A.squeeze.dims, _A.squeeze.dim):
        dims = args[1] if isinstance(args[1], (list, tuple)) else [args[1]]
        rank = len(node.args[0].meta["val"].shape)
        dims = [d % rank for d in dims]
        return ctx.add("Squeeze", [name(args[0]),
                                   ctx.const(np.asarray(dims, np.int64),
                                             "axes")])
    if t == _A.unsqueeze.default:
        rank = len(node.meta["val"].shape)
        return ctx.add("Unsqueeze", [name(args[0]), ctx.const(
            np.asarray([args[1] % rank], np.int64), "axes")])
    if t == _A.expand.default:
        shape = np.asarray(list(node.meta["val"].shape), np.int64)
        return ctx.add("Expand", [name(args[0]), ctx.const(shape, "shape")])
    if t == _A.cat.default:
        axis = args[1] if len(args) > 1 else kwargs.get("dim", 0)
        rank = len(node.meta["val"].shape)
        return ctx.add("Concat", [name(a) for a in args[0]],
                       [P.attribute("axis", i=int(axis) % rank)])
    if t in (_A._to_copy.default, _A.to.dtype):
        dt = _TORCH_DT.get(node.meta["val"].dtype)
        if dt is None:
            _refuse(node, f" to {node.meta['val'].dtype}")
        return ctx.add("Cast", [name(args[0])], [P.attribute("to", i=dt)])
    if t in (_A.sum.dim_IntList, _A.amax.default, _A.amin.default,
             _A.mean.dim):
        rank = len(node.args[0].meta["val"].shape)
        dims = args[1] if len(args) > 1 and args[1] else range(rank)
        dims = sorted(int(d) % rank for d in dims)
        keep = int(bool(args[2] if len(args) > 2 else kwargs.get("keepdim")))
        attrs = [P.attribute("keepdims", i=keep)]
        if t in (_A.sum.dim_IntList, _A.mean.dim):
            out = ctx.add("ReduceSum", [name(args[0]), ctx.const(
                np.asarray(dims, np.int64), "axes")], attrs)
            if t == _A.mean.dim:
                count = math.prod(node.args[0].meta["val"].shape[d]
                                  for d in dims)
                out = ctx.add("Div", [out, ctx.const(np.float32(count))])
            return out
        op = "ReduceMax" if t == _A.amax.default else "ReduceMin"
        return ctx.add(op, [name(args[0])], attrs + [_ints("axes", dims)])
    if t in (_A._softmax.default, _A._log_softmax.default):
        x = name(args[0])
        rank = len(node.meta["val"].shape)
        axes = [int(args[1]) % rank]
        keep = [P.attribute("keepdims", i=1)]
        shifted = ctx.add("Sub", [x, ctx.add("ReduceMax", [x],
                                             keep + [_ints("axes", axes)])])
        e = ctx.add("Exp", [shifted])
        total = ctx.add("ReduceSum", [e, ctx.const(np.asarray(
            axes, np.int64), "axes")], keep)
        if t == _A._softmax.default:
            return ctx.add("Div", [e, total])
        return ctx.add("Sub", [shifted, ctx.add("Log", [total])])
    if t == _A.where.self:
        return ctx.add("Where", [name(a) for a in args[:3]])
    if t == _A.clamp.default:
        out = name(args[0])
        lo = args[1] if len(args) > 1 else kwargs.get("min")
        hi = args[2] if len(args) > 2 else kwargs.get("max")
        if lo is not None:
            out = ctx.add("Max", [out, ctx.const(np.float32(lo))])
        if hi is not None:
            out = ctx.add("Min", [out, ctx.const(np.float32(hi))])
        return out
    if t == _A.remainder.Tensor:
        # floor modulo from the truncating Mod: add y where the remainder
        # is nonzero and its sign differs from y's
        x, y = name(args[0]), name(args[1])
        r = ctx.add("Mod", [x, y], [P.attribute("fmod", i=1)])
        zero = ctx.const(np.float32(0.0))
        nonzero = ctx.add("Not", [ctx.add("Equal", [r, zero])])
        signs = ctx.add("Xor", [ctx.add("Less", [r, zero]),
                                ctx.add("Less", [y, zero])])
        fix = ctx.add("And", [nonzero, signs])
        return ctx.add("Where", [fix, ctx.add("Add", [r, y]), r])
    if t == _A.convolution.default:
        (x, w, b, stride, padding, dilation, transposed, _out_pad,
         groups) = args
        if transposed:
            raise NotImplementedError(
                "onnx export: transposed conv is not expressible as ONNX "
                "Conv here; use the portable artifact")
        if groups != 1 or len(node.meta["val"].shape) != 4:
            raise NotImplementedError(
                "onnx export: conv layout must be NCHW/OIHW, groups=1")
        ins = [name(x), name(w)] + ([name(b)] if b is not None else [])
        return ctx.add("Conv", ins, [
            _ints("strides", stride), _ints("dilations", dilation),
            _ints("pads", list(padding) + list(padding))])
    if t == _A._native_batch_norm_legit_no_training.default:
        x, w, b, mean, var, _mom, eps = args
        rank = len(node.args[0].meta["val"].shape)
        shape = np.asarray([1, -1] + [1] * (rank - 2), np.int64)

        def col(a):
            return ctx.add("Reshape", [name(a), ctx.const(shape, "shape")])

        std = ctx.add("Sqrt", [ctx.add("Add", [col(var), ctx.const(
            np.float32(eps))])])
        out = ctx.add("Div", [ctx.add("Sub", [name(x), col(mean)]), std])
        if w is not None:
            out = ctx.add("Mul", [out, col(w)])
        if b is not None:
            out = ctx.add("Add", [out, col(b)])
        return (out, None, None)
    _refuse(node)


def _np_dtype(node):
    """The numpy dtype of a node's value."""
    val = node.meta.get("val")
    dt = getattr(val, "dtype", torch.float32)
    return torch.empty((), dtype=dt).numpy().dtype


def _max_pool(ctx, node, args):
    x, kernel, stride = args[0], args[1], args[2] or args[1]
    padding = args[3] if len(args) > 3 else [0, 0]
    dilation = args[4] if len(args) > 4 else [1, 1]
    ceil = args[5] if len(args) > 5 else False
    if ceil or any(d != 1 for d in dilation):
        _refuse(node, " with ceil_mode or dilation")
    lo = hi = list(_pair(padding))
    src = x
    if isinstance(x, tuple):       # a -inf constant pad folded in
        src, (plo, phi) = x
        lo = [a + b for a, b in zip(lo, plo)]
        hi = [a + b for a, b in zip(hi, phi)]
    out = ctx.add("MaxPool", [src], [
        _ints("kernel_shape", _pair(kernel)), _ints("strides", _pair(stride)),
        _ints("pads", lo + hi)])
    return (out, None)


def _pair(v):
    return list(v) * 2 if len(v) == 1 else list(v)


def graph_to_onnx(exported, params, feed_specs,
                  graph_name="paddle_tpu_torch"):
    """Serialized ModelProto of an exported ``fwd(params, feeds)``
    program: the parameter inputs (``params``' values) become
    initializers, the feeds (``(shape, dtype)`` each) the graph inputs
    ``input_i``, the outputs ``output_i``."""
    ctx = _Ctx()
    gm = exported.graph_module
    sig = exported.graph_signature
    user_inputs = [s.arg.name for s in sig.input_specs]
    n_feeds = len(feed_specs)
    env: Dict[str, object] = {}
    in_infos = []
    feed_names = user_inputs[len(user_inputs) - n_feeds:]
    for i, (shape, dtype) in enumerate(feed_specs):
        nm = f"input_{i}"
        in_infos.append(P.value_info(nm, _DT[np.dtype(dtype)], shape))
        env[feed_names[i]] = nm
    for pname, value in zip(user_inputs[:len(user_inputs) - n_feeds],
                            params):
        env[pname] = _Const(value)

    def arg(a):
        if isinstance(a, torch.fx.Node):
            return env[a.name]
        if isinstance(a, (list, tuple)):
            return type(a)(arg(x) for x in a)
        return a

    def concrete(a):
        if isinstance(a, _Const):
            return a.value
        if isinstance(a, (list, tuple)):
            return type(a)(concrete(x) for x in a)
        return a

    def has_graph_tensor(a):
        if isinstance(a, (str, tuple)) and not isinstance(a, list):
            return isinstance(a, str) or any(has_graph_tensor(x) for x in a)
        if isinstance(a, list):
            return any(has_graph_tensor(x) for x in a)
        return False

    out_names = []
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            continue
        if node.op == "output":
            out_names = [env[a.name] for a in node.args[0]]
            break
        if node.op != "call_function":
            _refuse(node)
        t = node.target
        args = [arg(a) for a in node.args]
        kwargs = {k: arg(v) for k, v in node.kwargs.items()}
        if t in _SKIP:
            continue
        if t is operator.getitem:
            src, i = args
            env[node.name] = src[i] if isinstance(src, (tuple, list)) \
                else _Const(src.value[i])
            if env[node.name] is None:
                _refuse(node, " (an output the export does not give)")
            continue
        if not any(has_graph_tensor(a) for a in args) and not any(
                has_graph_tensor(v) for v in kwargs.values()):
            out = t(*concrete(args), **{k: concrete(v)
                                        for k, v in kwargs.items()})
            env[node.name] = (tuple(_Const(o) for o in out)
                              if isinstance(out, (tuple, list))
                              else _Const(out))
            continue
        if t == _A.constant_pad_nd.default:
            pads = list(args[1])
            value = args[2] if len(args) > 2 else 0
            users = list(node.users)
            if not any(pads):
                env[node.name] = args[0]
            elif value == float("-inf") and len(pads) == 4 and users and \
                    all(u.target == _A.max_pool2d_with_indices.default
                        for u in users):
                # (left, right, top, bottom): folded into the pool's pads
                env[node.name] = (args[0], ([pads[2], pads[0]],
                                            [pads[3], pads[1]]))
            else:
                _refuse(node, " (a pad the exporter's op set lacks)")
            continue
        if t == _A.max_pool2d_with_indices.default:
            env[node.name] = _max_pool(ctx, node, args)
            continue
        env[node.name] = _lower(ctx, node, args, kwargs)

    out_infos = []
    out_node = [n for n in gm.graph.nodes if n.op == "output"][0]
    vals = [a.meta["val"] for a in out_node.args[0]]
    for i, (nm, val) in enumerate(zip(out_names, vals)):
        if isinstance(nm, _Const):
            nm = ctx.const_of(nm)
        final = f"output_{i}"
        ctx.nodes.append(P.node("Identity", [nm], [final]))
        out_infos.append(P.value_info(final, _TORCH_DT[val.dtype],
                                      tuple(val.shape)))
    g = P.graph(ctx.nodes, graph_name, ctx.initializers, in_infos, out_infos)
    return P.model(g)
