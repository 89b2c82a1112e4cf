"""``paddle.static.nn``: layer helpers and control flow for programs.

Counterpart of ``paddle_tpu/static/nn.py`` (reference
``python/paddle/static/nn/``). The layer helpers make eager Parameters
on the current device (the startup program takes their initial values)
and call the functional ops, which the recorder captures. Control flow
with a concrete predicate is plain Python; with a traced one (a static
``Variable``, a fake tensor under ``torch.export``, a CUDA tensor under
CUDA-graph capture) ``cond`` and ``switch_case`` run every branch and
select leaf-wise with ``torch.where`` (dy2static's ``_select``), and
``while_loop`` goes through ``torch._higher_order_ops.while_loop`` under
export and cannot be captured or recorded. ``deform_conv2d`` and
``multi_box_head`` are built on ``vision.ops``; ``sparse_embedding``
(the parameter-server table) raises until ``distributed`` is ported.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as TF

from ..core import random as _rng
from ..core.device import current_device
from ..core.dispatch import recordable
from ..jit import dy2static as _d2s
from ..nn import functional as F
from ..nn.initializer import Constant, XavierUniform
from ..nn.layer.layers import Parameter

__all__ = ["fc", "embedding", "conv2d", "batch_norm", "cond", "while_loop",
           "switch_case", "case", "layer_norm", "group_norm",
           "instance_norm", "prelu", "conv3d", "conv2d_transpose",
           "conv3d_transpose", "bilinear_tensor_product", "spectral_norm",
           "deform_conv2d", "data_norm", "row_conv", "nce", "crf_decoding",
           "py_func", "sparse_embedding", "StaticRNN", "static_rnn_run",
           "multi_box_head"]


def _param(shape, initializer=None, is_bias=False, dtype=None,
           trainable=True) -> Parameter:
    """A Parameter on the current device: ``initializer``, else zeros for
    a bias and Xavier-uniform for a weight (the JAX
    ``create_parameter``'s rule)."""
    init = initializer or (Constant(0.0) if is_bias else XavierUniform())
    return Parameter(init([int(s) for s in shape], dtype, current_device()),
                     requires_grad=trainable)


def _act(out, act):
    if act is None:
        return out
    fn = getattr(F, act, None) or getattr(TF, act)
    return fn(out)


def fc(x, size: int, num_flatten_dims: int = 1, activation=None,
       weight_attr=None, bias_attr=None, name=None):
    """Fully-connected layer (reference ``static/nn/common.py::fc``)."""
    shape = list(x.shape)
    in_dim = 1
    for d in shape[num_flatten_dims:]:
        if d in (-1, None) or not isinstance(d, int):
            raise ValueError("fc: trailing dims must be static")
        in_dim *= int(d)
    w = _param([in_dim, size])
    b = None if bias_attr is False else _param([size], is_bias=True)
    if len(shape) > num_flatten_dims + 1 or num_flatten_dims != 1:
        if num_flatten_dims > 1:
            lead = [-1 if d in (-1, None) else d
                    for d in shape[:num_flatten_dims]]
            x = x.reshape(*lead, in_dim)
        else:
            x = x.reshape(-1, in_dim)
    return _act(F.linear(x, w, b), activation)


def embedding(input, size, is_sparse=False, padding_idx=None,  # noqa: A002
              dtype="float32", param_attr=None, name=None):
    from ..core import dtypes as _dt

    w = _param(list(size), dtype=_dt.convert_dtype(dtype))
    return TF.embedding(input, w, padding_idx=padding_idx)


def conv2d(input, num_filters, filter_size, stride=1, padding=0,  # noqa: A002
           dilation=1, groups=1, param_attr=None, bias_attr=None, act=None,
           data_format="NCHW", name=None):
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    in_c = input.shape[1 if data_format == "NCHW" else -1]
    w = _param([num_filters, in_c // groups, *filter_size])
    b = None if bias_attr is False else _param([num_filters], is_bias=True)
    out = F.conv2d(input, w, b, stride=stride, padding=padding,
                   dilation=dilation, groups=groups, data_format=data_format)
    return _act(out, act)


def batch_norm(input, act=None, is_test=False, momentum=0.9,  # noqa: A002
               epsilon=1e-5, param_attr=None, bias_attr=None,
               data_layout="NCHW", name=None):
    c = input.shape[1 if data_layout == "NCHW" else -1]
    weight = _param([c], Constant(1.0))
    bias = _param([c], is_bias=True)
    mean = _param([c], Constant(0.0), trainable=False)
    var = _param([c], Constant(1.0), trainable=False)
    out = F.batch_norm(input, mean, var, weight, bias, training=not is_test,
                       momentum=momentum, epsilon=epsilon,
                       data_format=data_layout)
    return _act(out, act)


# ---------------------------------------------------------- control flow ---


def _select_out(pred, t_out, f_out):
    pred = _d2s._scalar_pred(pred)
    return _d2s._select(pred, [t_out], [f_out])[0]


def cond(pred, true_fn: Callable, false_fn: Callable, name=None):
    """``paddle.static.nn.cond``: a data-dependent branch. A concrete
    predicate runs one branch; a traced one runs both and selects
    leaf-wise (the outputs must match in structure and shape)."""
    if not _d2s.is_traced(pred):
        return true_fn() if bool(pred) else false_fn()
    return _select_out(pred, true_fn(), false_fn())


def while_loop(cond_fn: Callable, body_fn: Callable, loop_vars: Sequence,
               name=None):
    """``paddle.static.nn.while_loop``: Python iteration on concrete
    values; on traced ones the loop state goes through
    ``torch._higher_order_ops.while_loop`` (``torch.export``), and a
    capture or a static program refuses it (the predicate is read on the
    host every iteration)."""
    loop_vars = list(loop_vars)
    first = cond_fn(*loop_vars)
    if not _d2s.is_traced(first):
        while bool(first):
            out = body_fn(*loop_vars)
            loop_vars = list(out) if isinstance(out, (list, tuple)) else [out]
            first = cond_fn(*loop_vars)
        return loop_vars
    if _d2s.capturing(first):
        _d2s._host_read("static.nn.while_loop on a tensor predicate")
    if getattr(type(first), "_symbolic", False):
        raise RuntimeError(
            "while_loop with a symbolic Variable predicate is not "
            "recordable; use paddle.jit.to_static for control flow")
    state = {"v": loop_vars}

    def get_args():
        return [state["v"]]

    def set_args(vals):
        state["v"] = list(vals[0])

    def body():
        out = body_fn(*state["v"])
        state["v"] = list(out) if isinstance(out, (list, tuple)) else [out]

    _d2s._while_export(lambda: cond_fn(*state["v"]), body, get_args,
                       set_args, first)
    return state["v"]


def switch_case(branch_index, branch_fns, default=None, name=None):
    """Python dispatch on a concrete index; a traced one runs every
    branch and selects (an unmatched key takes ``default``, else the
    last branch, as the JAX package's compiled form)."""
    if isinstance(branch_fns, dict):
        keys = sorted(branch_fns)
        fns = [branch_fns[k] for k in keys]
    else:
        keys = list(range(len(branch_fns)))
        fns = list(branch_fns)
    if not _d2s.is_traced(branch_index):
        i = int(branch_index)
        if i in keys:
            return fns[keys.index(i)]()
        if default is not None:
            return default()
        raise ValueError(f"switch_case: no branch for {i}")
    idx = branch_index.reshape(())
    out = (default or fns[-1])()
    for k, f in reversed(list(zip(keys, fns))):
        out = _select_out(idx == k, f(), out)
    return out


def case(pred_fn_pairs, default=None, name=None):
    """Reference ``static/nn/control_flow.py case``: the first true
    predicate's branch (concrete predicates), else ``default``, else the
    last branch; traced predicates select in reverse order."""
    if not any(_d2s.is_traced(p) for p, _ in pred_fn_pairs):
        for pred, f in pred_fn_pairs:
            if bool(pred):
                return f()
        if default is not None:
            return default()
        return pred_fn_pairs[-1][1]()
    out = (default or pred_fn_pairs[-1][1])()
    for pred, f in reversed(pred_fn_pairs):
        out = _select_out(pred, f(), out) if _d2s.is_traced(pred) else (
            f() if bool(pred) else out)
    return out


# ------------------------------------------------------- nn op helpers ----


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,  # noqa: A002
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    shape = list(input.shape)
    n = int(np.prod(shape[begin_norm_axis:]))
    w = _param([n], Constant(1.0)) if scale else None
    b = _param([n], is_bias=True) if shift else None
    flat = input.reshape(*shape[:begin_norm_axis], n)
    out = F.layer_norm(flat, [n], weight=w, bias=b, epsilon=epsilon)
    return _act(out.reshape(*shape), act)


def group_norm(input, groups, epsilon=1e-5, param_attr=None,  # noqa: A002
               bias_attr=None, act=None, data_layout="NCHW", name=None):
    c = input.shape[1]
    w = _param([c], Constant(1.0))
    b = _param([c], is_bias=True)
    out = TF.group_norm(input, groups, w, b, eps=epsilon)
    return _act(out, act)


def instance_norm(input, epsilon=1e-5, param_attr=None,  # noqa: A002
                  bias_attr=None, name=None):
    return TF.instance_norm(input, eps=epsilon)


def prelu(x, mode="all", param_attr=None, data_format="NCHW", name=None):
    n = {"all": 1, "channel": x.shape[1], "element": x.shape[-1]}[mode]
    w = _param([n], Constant(0.25))
    if mode == "element":
        return torch.where(x >= 0, x, w * x)
    return TF.prelu(x, w)


def _ntuple(v, n):
    return list(v) if isinstance(v, (list, tuple)) else [v] * n


def conv3d(input, num_filters, filter_size, stride=1, padding=0,  # noqa: A002
           dilation=1, groups=1, param_attr=None, bias_attr=None,
           data_format="NCDHW", name=None):
    w = _param([num_filters, input.shape[1] // groups,
                *_ntuple(filter_size, 3)])
    b = None if bias_attr is False else _param([num_filters], is_bias=True)
    return TF.conv3d(input, w, b, stride=stride, padding=padding,
                     dilation=dilation, groups=groups)


def conv2d_transpose(input, num_filters, output_size=None,  # noqa: A002
                     filter_size=None, padding=0, stride=1, dilation=1,
                     groups=1, param_attr=None, bias_attr=None, name=None):
    w = _param([input.shape[1], num_filters // groups,
                *_ntuple(filter_size, 2)])
    b = None if bias_attr is False else _param([num_filters], is_bias=True)
    return TF.conv_transpose2d(input, w, b, stride=stride, padding=padding,
                               dilation=dilation, groups=groups)


def conv3d_transpose(input, num_filters, output_size=None,  # noqa: A002
                     filter_size=None, padding=0, stride=1, dilation=1,
                     groups=1, param_attr=None, bias_attr=None, name=None):
    w = _param([input.shape[1], num_filters // groups,
                *_ntuple(filter_size, 3)])
    b = None if bias_attr is False else _param([num_filters], is_bias=True)
    return TF.conv_transpose3d(input, w, b, stride=stride, padding=padding,
                               dilation=dilation, groups=groups)


def bilinear_tensor_product(x, y, size, act=None, param_attr=None,
                            bias_attr=None, name=None):
    w = _param([size, x.shape[-1], y.shape[-1]])
    b = None if bias_attr is False else _param([size], is_bias=True)
    return _act(TF.bilinear(x, y, w, b), act)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """Power-iteration spectral normalization of a weight (reference
    ``static/nn/common.py spectral_norm``), from all-ones vectors."""
    wm = weight.movedim(dim, 0).reshape(weight.shape[dim], -1).float()
    u = torch.ones(wm.shape[0], device=wm.device)
    v = torch.ones(wm.shape[1], device=wm.device)
    for _ in range(power_iters):
        v = wm.t() @ u
        v = v / (torch.linalg.norm(v) + eps)
        u = wm @ v
        u = u / (torch.linalg.norm(u) + eps)
    sigma = u @ wm @ v
    return (weight / sigma).to(weight.dtype)


def deform_conv2d(x, offset, mask, num_filters, filter_size, stride=1,
                  padding=0, dilation=1, groups=1, deformable_groups=1,
                  im2col_step=1, param_attr=None, bias_attr=None, name=None):
    """Deformable convolution with a new weight ``[num_filters, C /
    groups, kh, kw]`` (Xavier-normal, the JAX free ``create_parameter``'s
    rule) and bias (zeros; none with ``bias_attr=False``), through
    ``vision.ops.deform_conv2d`` (``mask`` None: v1)."""
    from ..nn.layer.layers import create_parameter
    from ..vision.ops import deform_conv2d as _dc

    ks = filter_size if isinstance(filter_size, (list, tuple)) \
        else (filter_size,) * 2
    w = create_parameter([num_filters, x.shape[1] // groups, *ks])
    b = None if bias_attr is False else create_parameter(
        [num_filters], is_bias=True)
    return _dc(x, offset, w, bias=b, stride=stride, padding=padding,
               dilation=dilation, deformable_groups=deformable_groups,
               groups=groups, mask=mask)


def data_norm(input, act=None, epsilon=1e-5, param_attr=None,  # noqa: A002
              data_layout="NCHW", in_place=False, name=None,
              moving_mean_name=None, moving_variance_name=None,
              do_model_average_for_mean_and_var=True, slot_dim=-1,
              sync_stats=False, summary_decay_rate=0.9999999,
              enable_scale_and_shift=False):
    """Normalization by the batch's statistics (reference
    ``data_norm_op``: batch norm without gamma/beta)."""
    xf = input.float()
    mean = xf.mean(0, keepdim=True)
    var = xf.var(0, unbiased=False, keepdim=True)
    return ((xf - mean) / torch.sqrt(var + epsilon)).to(input.dtype)


def row_conv(input, future_context_size, param_attr=None, act=None,  # noqa: A002
             name=None):
    """Lookahead row convolution (reference ``row_conv_op``):
    ``out[t] = sum_{k=0..ctx} x[t+k] * w[k]`` per feature."""
    D = input.shape[-1]
    w = _param([future_context_size + 1, D])
    T = input.shape[1]
    out = torch.zeros_like(input)
    for k in range(w.shape[0]):
        shifted = TF.pad(input[:, k:], (0, 0, 0, k))[:, :T]
        out = out + shifted * w[k]
    return out.to(input.dtype)


def nce(input, label, num_total_classes, sample_weight=None,  # noqa: A002
        param_attr=None, bias_attr=None, num_neg_samples=10, name=None,
        sampler="uniform", custom_dist=None, seed=0, is_sparse=False):
    """Noise-contrastive estimation loss (reference ``nce_op``): one
    positive and ``num_neg_samples`` uniform negatives per row, drawn
    from the port's generator (the JAX package's draws are
    ``jax.random``'s), logistic loss on both."""
    D = input.shape[-1]
    w = _param([num_total_classes, D])
    b = _param([num_total_classes], is_bias=True)
    yv = label.reshape(-1).long()
    pos = (input * w[yv]).sum(-1) + b[yv]
    neg_ids = torch.randint(0, num_total_classes,
                            (input.shape[0], num_neg_samples),
                            generator=_rng.generator(input.device),
                            device=input.device)
    neg = torch.einsum("bd,bkd->bk", input, w[neg_ids]) + b[neg_ids]
    loss = -TF.logsigmoid(pos) - TF.logsigmoid(-neg).sum(1)
    return loss.reshape(-1, 1).to(input.dtype)


def crf_decoding(input, param_attr=None, label=None, length=None,  # noqa: A002
                 name=None, transition=None):
    """Viterbi decode over emission scores (reference
    ``crf_decoding_op``). ``transition`` is ``[num_tags + 2, num_tags]``:
    row 0 start scores, row 1 stop scores, then the tag-to-tag matrix;
    returns the best path ``[B, T]`` (zeros past each length)."""
    if transition is None:
        raise ValueError("pass transition= (the [num_tags+2, num_tags] "
                         "CRF transition parameter)")
    emis = np.asarray(input.detach().float().cpu().numpy(), np.float64)
    trans = np.asarray(transition.detach().float().cpu().numpy(), np.float64)
    B, T, _ = emis.shape
    lens = (np.full(B, T) if length is None
            else np.asarray(length.detach().cpu().numpy()).reshape(-1))
    start, stop, square = trans[0], trans[1], trans[2:]
    paths = np.zeros((B, T), np.int64)
    for i in range(B):
        n = int(lens[i])
        score = emis[i, 0] + start
        back = []
        for t in range(1, n):
            cand = score[:, None] + square
            back.append(cand.argmax(0))
            score = cand.max(0) + emis[i, t]
        score = score + stop
        best = [int(score.argmax())]
        for bp in reversed(back):
            best.append(int(bp[best[-1]]))
        paths[i, :n] = best[::-1]
    return torch.from_numpy(paths).to(input.device)


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """A host Python op (reference ``py_func_op``): ``func`` runs on
    numpy copies of ``x``; the outputs take ``out``'s shapes and dtypes.
    A static program records it as one op; under CUDA-graph capture it
    is a host read (the signature runs eagerly)."""
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    specs = [(tuple(o.shape), o.dtype) for o in outs]

    def infer(*arrays):
        res = [arrays[0].new_empty(s, dtype=d) for s, d in specs]
        return res[0] if len(res) == 1 else tuple(res)

    @recordable("py_func", infer)
    def run(*arrays):
        if any(_d2s.capturing(a) for a in arrays):
            _d2s._host_read("py_func")
        r = func(*[a.detach().cpu().numpy() for a in arrays])
        r = r if isinstance(r, (list, tuple)) else [r]
        res = [torch.as_tensor(np.asarray(v)).to(arrays[0].device)
               for v in r]
        return res[0] if len(res) == 1 else tuple(res)

    return run(*xs)


def sparse_embedding(input, size, padding_idx=None, is_test=False,  # noqa: A002
                     entry=None, table_class="MemorySparseTable",
                     param_attr=None, dtype="float32", slot=None, name=None):
    raise NotImplementedError("static.nn.sparse_embedding needs the "
                              "parameter-server tables of distributed/, "
                              "which are not ported yet")


class StaticRNN:
    """Handle-based surface of the reference's StaticRNN, kept for API
    parity; build loops with :func:`static_rnn_run`."""

    def __init__(self, name=None):
        self._memories = []
        self._outputs = []

    def step(self):
        rnn = self

        class _Guard:
            def __enter__(self):
                return rnn

            def __exit__(self, *exc):
                return False

        return _Guard()

    def step_input(self, x):
        return _StepHandle()

    def memory(self, init=None, shape=None, batch_ref=None, value=0.0):
        if init is None:
            raise ValueError("StaticRNN.memory needs init=")
        h = _StepHandle()
        self._memories.append([h, init, None])
        return h

    def update_memory(self, mem, new_val):
        for m in self._memories:
            if m[0] is mem:
                m[2] = new_val
                return
        raise ValueError("unknown memory handle")

    def step_output(self, o):
        self._outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def __call__(self):
        raise RuntimeError(
            "build the StaticRNN with functional deps: use "
            "static_rnn_run(rnn_body, inputs, init_states) instead")


class _StepHandle:
    pass


def static_rnn_run(step_fn, inputs, init_states):
    """``step_fn(x_t, *states) -> (out_t, *new_states)`` over the time
    axis (1) of ``inputs``, unrolled; returns the outputs stacked
    ``[B, T, ...]``."""
    states = list(init_states)
    outs = []
    for t in range(inputs.shape[1]):
        res = step_fn(inputs[:, t], *states)
        outs.append(res[0])
        states = list(res[1:])
    return torch.stack(outs, dim=1)


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """SSD detection head (reference ``static/nn/multi_box_head``): each
    feature map's prior boxes (``vision.ops.prior_box``) and its location
    and class convolutions (new bias-free weights, Xavier-normal),
    concatenated across the maps. Without ``min_sizes`` the sizes are
    interpolated between ``min_ratio`` and ``max_ratio`` percent of
    ``base_size``, as the reference does. Returns (mbox_loc ``[N, P,
    4]``, mbox_conf ``[N, P, classes]``, boxes ``[P, 4]``, variances).
    ``steps``, ``step_w`` and ``step_h`` are accepted and unused, as in
    the JAX package."""
    from ..nn.layer.layers import create_parameter
    from ..ops import concat, reshape, transpose
    from ..vision.ops import prior_box as _prior_box

    n_maps = len(inputs)
    if min_sizes is None:
        min_sizes, max_sizes = [], []
        step = int(np.floor((max_ratio - min_ratio) / (n_maps - 2)))
        for r in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * r / 100.0)
            max_sizes.append(base_size * (r + step) / 100.0)
        min_sizes = [base_size * 0.1] + min_sizes
        max_sizes = [base_size * 0.2] + max_sizes

    locs, confs, boxes_all, vars_all = [], [], [], []
    for i, feat in enumerate(inputs):
        mn = min_sizes[i] if isinstance(min_sizes[i], (list, tuple)) \
            else [min_sizes[i]]
        mx = (max_sizes[i] if isinstance(max_sizes[i], (list, tuple))
              else [max_sizes[i]]) if max_sizes else None
        boxes, variances = _prior_box(
            feat, image, min_sizes=mn, max_sizes=mx,
            aspect_ratios=aspect_ratios[i], variance=list(variance),
            flip=flip, clip=clip, offset=offset)
        nb = int(np.prod(boxes.shape[:-1]) // (feat.shape[2] * feat.shape[3]))
        c_in = feat.shape[1]
        w_loc = create_parameter([nb * 4, c_in, kernel_size, kernel_size])
        loc = transpose(F.conv2d(feat, w_loc, stride=stride, padding=pad),
                        [0, 2, 3, 1])
        locs.append(reshape(loc, [loc.shape[0], -1, 4]))
        w_conf = create_parameter(
            [nb * num_classes, c_in, kernel_size, kernel_size])
        conf = transpose(F.conv2d(feat, w_conf, stride=stride, padding=pad),
                         [0, 2, 3, 1])
        confs.append(reshape(conf, [conf.shape[0], -1, num_classes]))
        boxes_all.append(reshape(boxes, [-1, 4]))
        vars_all.append(reshape(variances, [-1, 4]))
    return (concat(locs, axis=1), concat(confs, axis=1),
            concat(boxes_all, axis=0), concat(vars_all, axis=0))


from .sequence import (  # noqa: F401,E402
    sequence_concat, sequence_conv, sequence_enumerate, sequence_expand,
    sequence_expand_as, sequence_first_step, sequence_last_step,
    sequence_pad, sequence_pool, sequence_reshape, sequence_reverse,
    sequence_scatter, sequence_slice, sequence_softmax, sequence_unpad,
)
