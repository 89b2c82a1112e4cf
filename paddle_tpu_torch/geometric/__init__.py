"""``paddle.geometric``: message passing and neighbour sampling
(counterpart of ``paddle_tpu/geometric/__init__.py``).

The message ops run on the input's device in PyTorch: the gather
``x[src]`` is ``index_select``; sum and mean reduce with ``index_add_``
(mean divides by the count clamped at 1), max and min with
``scatter_reduce_`` excluding the initial zeros, so an empty segment
gives 0 for every dtype, integers included, as the JAX package's fill
does. Gradients are torch's (``index_add_`` / ``scatter_reduce_``'s;
the JAX scatter-max's ties share their gradient as torch's do). On the
card ``index_add_`` sums with atomics, so a float sum's order of
addition (its last bits) varies from run to run.

``send_u_recv`` / ``send_ue_recv`` output ``out_size`` rows (default:
x's node count); ``segment_*`` ``max(ids) + 1`` rows (one host read).
Sampling and reindexing are the JAX package's host loops over numpy,
copied here: ``sample_neighbors`` draws from an unseeded
``np.random.default_rng()``, as the JAX package does, so both give the
same distribution and different draws (ROADMAP queue C). Their outputs
come back on the input's device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import as_tensor, to_numpy, to_tensor, to_tensor_arg

__all__ = [
    "send_u_recv", "send_ue_recv", "send_uv",
    "segment_sum", "segment_mean", "segment_max", "segment_min",
    "sample_neighbors", "reindex_graph", "reindex_heter_graph",
]

_MESSAGE_OPS = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
}
_EXTREMA = {"max": "amax", "min": "amin"}


def _segment_reduce(msg, seg_ids, n: int, reduce_op: str):
    """Rows of ``msg`` reduced by ``seg_ids`` into ``n`` rows."""
    ids = seg_ids.long()
    out_shape = (n,) + tuple(msg.shape[1:])
    if reduce_op in ("sum", "mean"):
        s = msg.new_zeros(out_shape).index_add(0, ids, msg)
        if reduce_op == "sum":
            return s
        counts = torch.zeros(n, dtype=torch.int32, device=msg.device)
        counts.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
        d = counts.clamp_min(1).to(msg.dtype)
        return s / d.reshape((n,) + (1,) * (msg.dim() - 1))
    if reduce_op in _EXTREMA:
        index = ids.reshape((-1,) + (1,) * (msg.dim() - 1)).expand_as(msg)
        return msg.new_zeros(out_shape).scatter_reduce(
            0, index, msg, _EXTREMA[reduce_op], include_self=False)
    raise ValueError(f"unknown reduce_op {reduce_op!r}")


def send_u_recv(x, src_index, dst_index, reduce_op="sum", out_size=None,
                name=None):
    """Gather ``x[src]`` and reduce it onto ``dst``."""
    x = to_tensor_arg(x)
    src, dst = to_tensor_arg(src_index), to_tensor_arg(dst_index)
    n = int(out_size) if out_size is not None else int(x.shape[0])
    return _segment_reduce(x.index_select(0, src.long()), dst, n, reduce_op)


def _message(message_op):
    if message_op not in _MESSAGE_OPS:
        raise ValueError(f"unknown message_op {message_op!r}")
    return _MESSAGE_OPS[message_op]


def send_ue_recv(x, y, src_index, dst_index, message_op="add",
                 reduce_op="sum", out_size=None, name=None):
    """Message ``x[src] (message_op) y[edge]``, reduced onto ``dst``."""
    mfn = _message(message_op)
    x, y = to_tensor_arg(x), to_tensor_arg(y)
    src, dst = to_tensor_arg(src_index), to_tensor_arg(dst_index)
    n = int(out_size) if out_size is not None else int(x.shape[0])
    msg = mfn(x.index_select(0, src.long()), y)
    return _segment_reduce(msg, dst, n, reduce_op)


def send_uv(x, y, src_index, dst_index, message_op="add", name=None):
    """The per-edge message ``x[src] (message_op) y[dst]``."""
    mfn = _message(message_op)
    x, y = to_tensor_arg(x), to_tensor_arg(y)
    src, dst = to_tensor_arg(src_index), to_tensor_arg(dst_index)
    return mfn(x.index_select(0, src.long()), y.index_select(0, dst.long()))


def _segment_op(reduce_op):
    def op(data, segment_ids, name=None):
        data, ids = to_tensor_arg(data), to_tensor_arg(segment_ids)
        n = int(ids.max()) + 1 if ids.numel() else 0
        return _segment_reduce(data, ids, n, reduce_op)

    op.__name__ = f"segment_{reduce_op}"
    op.__doc__ = (f"Rows of ``data`` reduced ({reduce_op}) by "
                  "``segment_ids`` into ``max(ids) + 1`` rows.")
    return op


segment_sum = _segment_op("sum")
segment_mean = _segment_op("mean")
segment_max = _segment_op("max")
segment_min = _segment_op("min")


def _on(arr: np.ndarray, like):
    """A host array as a tensor on ``like``'s device (the current device
    for an array input)."""
    if not isinstance(like, torch.Tensor):
        return to_tensor(arr)
    return as_tensor(torch.from_numpy(np.ascontiguousarray(arr)).to(
        like.device))


def _host(x):
    return to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def sample_neighbors(row, colptr, input_nodes, sample_size=-1, eids=None,
                     return_eids=False, perm_buffer=None, name=None):
    """Up to ``sample_size`` in-neighbours of each input node of a CSC
    graph, drawn uniformly without replacement (all of them for
    ``sample_size`` -1): ``(neighbors, counts)``, with ``return_eids``
    also their edge ids."""
    row_np, colptr_np = _host(row), _host(colptr)
    nodes = _host(input_nodes)
    eids_np = _host(eids) if eids is not None else None
    rng = np.random.default_rng()
    out_neighbors, out_counts, out_eids = [], [], []
    for nd in nodes.tolist():
        beg, end = int(colptr_np[nd]), int(colptr_np[nd + 1])
        cand = row_np[beg:end]
        ce = eids_np[beg:end] if eids_np is not None else None
        if sample_size >= 0 and len(cand) > sample_size:
            pick = rng.choice(len(cand), size=sample_size, replace=False)
            cand = cand[pick]
            ce = ce[pick] if ce is not None else None
        out_neighbors.append(cand)
        out_counts.append(len(cand))
        if ce is not None:
            out_eids.append(ce)
    neighbors = _on(np.concatenate(out_neighbors) if out_neighbors
                    else np.array([], row_np.dtype), input_nodes)
    counts = _on(np.asarray(out_counts, np.int32), input_nodes)
    if return_eids:
        if eids_np is None:
            raise ValueError("return_eids=True requires eids")
        eid_arr = (np.concatenate(out_eids) if out_eids
                   else np.array([], eids_np.dtype))
        return neighbors, counts, _on(eid_arr, input_nodes)
    return neighbors, counts


def _reindex(x_np, pairs):
    """The JAX package's first-appearance mapping over ``x`` then each
    ``(neighbors, counts)`` pair: (src, dst, nodes) arrays."""
    mapping = {}
    for v in x_np.tolist():
        if v not in mapping:
            mapping[v] = len(mapping)
    src_all, dst_all = [], []
    for nbr_np, cnt_np in pairs:
        for i, c in enumerate(cnt_np.tolist()):
            dst_all.extend([mapping[x_np[i]]] * int(c))
        for v in nbr_np.tolist():
            if v not in mapping:
                mapping[v] = len(mapping)
            src_all.append(mapping[v])
    out_nodes = np.empty(len(mapping), x_np.dtype)
    for v, i in mapping.items():
        out_nodes[i] = v
    return (np.asarray(src_all, np.int64), np.asarray(dst_all, np.int64),
            out_nodes)


def reindex_graph(x, neighbors, count, value_buffer=None, index_buffer=None,
                  name=None):
    """Local ids for a sampled graph: x's nodes get ``0..n-1``, unseen
    neighbours follow in order of first appearance. Returns
    ``(reindex_src, reindex_dst, out_nodes)``."""
    out = _reindex(_host(x), [(_host(neighbors), _host(count))])
    return tuple(_on(a, x) for a in out)


def reindex_heter_graph(x, neighbors, count, value_buffer=None,
                        index_buffer=None, name=None):
    """``reindex_graph`` over several edge types (lists of neighbours
    and counts) sharing one id space."""
    out = _reindex(_host(x), [(_host(n), _host(c))
                              for n, c in zip(neighbors, count)])
    return tuple(_on(a, x) for a in out)
