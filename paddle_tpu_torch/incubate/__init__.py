"""``paddle.incubate`` (counterpart of ``paddle_tpu/incubate/__init__.py``):
``LookAhead`` / ``ModelAverage``, the graph ops under their incubate
names (``geometric``'s), the segment reductions, the fused softmax-mask
ops and ``identity_loss``; the subpackages ``asp``, ``autograd``,
``checkpoint``, ``multiprocessing`` (imported on use: it registers a
pickler), ``nn`` and ``optimizer``. ``distributed`` raises on use
(ROADMAP A.12).
"""
import numpy as np
import torch

from . import asp, autograd, checkpoint, distributed, nn, optimizer  # noqa: F401
from ..geometric import (reindex_graph, sample_neighbors, segment_max,
                         segment_mean, segment_min, segment_sum, send_u_recv)
from ..core.tensor import to_numpy, to_tensor_arg
from .optimizer import LookAhead, ModelAverage

graph_reindex = reindex_graph
graph_sample_neighbors = sample_neighbors

__all__ = [
    "LookAhead", "ModelAverage", "graph_khop_sampler", "graph_reindex",
    "graph_sample_neighbors", "graph_send_recv", "identity_loss",
    "segment_max", "segment_mean", "segment_min", "segment_sum",
    "softmax_mask_fuse", "softmax_mask_fuse_upper_triangle",
]


def graph_send_recv(x, src_index, dst_index, pool_type="sum",
                    out_size=None, name=None):
    """``geometric.send_u_recv`` under its older name."""
    return send_u_recv(x, src_index, dst_index, reduce_op=pool_type,
                       out_size=out_size)


def graph_khop_sampler(row, colptr, input_nodes, sample_sizes,
                       return_eids=False, name=None):
    """Sample ``sample_sizes[i]`` in-neighbours a node at hop ``i`` from a
    CSC graph, then reindex against the seeds and every hop's frontier
    but the last: ``(reindex_src, reindex_dst, out_nodes)`` on the
    input's device. ``return_eids`` raises (edge ids are not tracked)."""
    if return_eids:
        raise NotImplementedError("edge ids not tracked in sampling")
    srcs, cnts = [], []
    frontier = input_nodes
    for k in sample_sizes:
        nbr, cnt = sample_neighbors(row, colptr, frontier, sample_size=k)
        srcs.append(to_numpy(nbr))
        cnts.append(to_numpy(cnt))
        frontier = nbr
    seeds = to_numpy(input_nodes) if isinstance(input_nodes, torch.Tensor) \
        else np.asarray(input_nodes)
    like = input_nodes if isinstance(input_nodes, torch.Tensor) else nbr
    as_like = lambda a: torch.from_numpy(  # noqa: E731
        a.astype(np.int64)).to(like.device)
    return reindex_graph(as_like(np.concatenate([seeds] + srcs[:-1])),
                         as_like(np.concatenate(srcs)),
                         as_like(np.concatenate(cnts)))


def softmax_mask_fuse(x, mask, name=None):
    """``softmax(x + mask)`` over the last axis."""
    from ..nn.functional import softmax

    return softmax(to_tensor_arg(x) + mask, axis=-1)


def softmax_mask_fuse_upper_triangle(x, name=None):
    """Causal softmax of ``[..., S, S]`` scores: float32 logits, the
    entries above the diagonal filled with -1e30, cast back to x's
    dtype."""
    x = to_tensor_arg(x)
    S = x.shape[-1]
    keep = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    logits = torch.where(keep, x.float(),
                         torch.full((), -1e30, device=x.device))
    return torch.softmax(logits, dim=-1).to(x.dtype)


def identity_loss(x, reduction="none"):
    """x, its sum (``"sum"`` / 1) or its mean (anything else but
    ``"none"`` / 2)."""
    if reduction in ("none", 2):
        return x
    if reduction in ("sum", 1):
        return x.sum()
    return x.mean()
