"""Ragged paged attention over a flat token block.

Counterpart of ``paddle_tpu/kernels/paged_attention.py``'s ragged tier.
Keys and values live in a shared paged pool ``[P, page, H, D]``; row b
of a step owns the flat query tokens ``[q_starts[b], q_starts[b] +
q_lens[b])`` of ``q [N, H, D]``, and token t of the row sits at global
position ``kv_lens[b] - q_lens[b] + t`` (``kv_lens`` are post-append:
the step's own K/V are already in the pool). It attends causally
through row b's page table over every position up to its own. Tokens
covered by no row (bucket padding) output exact zeros.

Two tiers behind one dispatcher, :func:`ragged_attention`:

- ``kernel``: the hand-written CUDA kernel (``csrc/ragged_attention.cu``)
  that replaces the JAX package's Pallas ``_ragged_kernel``. It takes
  CUDA tensors only and raises on anything else.
- ``ref``: :func:`ragged_attention_ref`, the plain PyTorch version of
  ``ragged_attention_lax`` — what the CPU runs and what the kernel is
  held against on the card.

``tier="auto"`` launches the kernel for CUDA tensors and takes the
plain version for CPU tensors; it never falls back from one to the
other.
"""
from __future__ import annotations

import collections
import ctypes
import math
from typing import Optional

import torch

__all__ = ["NEG_INF", "LAUNCHES", "ragged_rows", "ragged_attention",
           "ragged_attention_ref", "ragged_attention_cuda"]

NEG_INF = -1e30

# kernel launches by kernel name: each wrapper adds one where it launches
# its kernel and nowhere else, so a run can show which kernels it went
# through (reset with LAUNCHES.clear())
LAUNCHES: "collections.Counter[str]" = collections.Counter()

# the kernel's limits (csrc/ragged_attention.cu): one lane per key of a
# page, ceil(D / 32) head-dim elements per lane
_MAX_PAGE_SIZE = 32
_MAX_HEAD_DIM = 128


def ragged_rows(q_starts, q_lens, kv_lens, width: int):
    """Flat-token bookkeeping every ragged consumer shares: for each of
    the ``width`` flat token positions, (row, local t, global position,
    valid). Token i belongs to row b iff ``q_starts[b] <= i <
    q_starts[b] + q_lens[b]`` (rows must not overlap); its global
    sequence position is ``kv_lens[b] - q_lens[b] + t``. Tokens covered
    by no row are padding: row 0, position 0, valid False."""
    i = torch.arange(width, dtype=torch.int32, device=q_starts.device)
    member = ((i[None, :] >= q_starts[:, None])
              & (i[None, :] < (q_starts + q_lens)[:, None]))     # [B, N]
    valid = member.any(dim=0)
    # first member row (argmax over a bool matrix, as jnp.argmax picks
    # the first maximum)
    row = member.to(torch.int8).argmax(dim=0).to(torch.int32)
    t = i - q_starts[row]
    pos = torch.where(valid, (kv_lens - q_lens)[row] + t,
                      torch.zeros_like(t))
    return row, t, pos, valid


def ragged_attention_ref(q, k_pool, v_pool, page_table, kv_lens, q_starts,
                         q_lens, sm_scale: Optional[float] = None):
    """Plain PyTorch ragged attention, float32: the same masks and the
    same softmax as ``ragged_attention_lax``. It gathers each ROW's
    context once (``[S, H, D]`` per row, S = pages_per_seq * page) and
    attends that row's tokens over it, so it fits on the card at
    prefill shapes; padding tokens stay exact zeros. Reads the row
    metadata on the host (one sync): it is the reference, not the fast
    path."""
    N, H, D = q.shape
    page_size = k_pool.shape[1]
    S = page_table.shape[1] * page_size
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    out = torch.zeros_like(q)
    pos = torch.arange(S, device=q.device)
    for b, (qs, ql, kv) in enumerate(zip(q_starts.tolist(), q_lens.tolist(),
                                         kv_lens.tolist())):
        if ql <= 0:
            continue
        pages = page_table[b].long()
        k = k_pool[pages].reshape(S, H, D)
        v = v_pool[pages].reshape(S, H, D)
        qb = q[qs:qs + ql]
        logits = torch.einsum("thd,shd->ths", qb, k) * scale
        q_pos = kv - ql + torch.arange(ql, device=q.device)
        mask = (pos[None, :] < kv) & (pos[None, :] <= q_pos[:, None])
        logits = torch.where(mask[:, None, :], logits,
                             torch.full_like(logits, NEG_INF))
        m = logits.amax(dim=-1, keepdim=True)
        probs = torch.softmax(logits, dim=-1)
        probs = torch.where(m <= NEG_INF / 2, torch.zeros_like(probs), probs)
        out[qs:qs + ql] = torch.einsum("ths,shd->thd", probs, v)
    return out


def _kernel_lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("ragged_attention")
    fn = lib.ragged_attention_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def ragged_attention_cuda(q, k_pool, v_pool, page_table, kv_lens, q_starts,
                          q_lens, sm_scale: Optional[float] = None,
                          max_q_len: Optional[int] = None):
    """Launch the CUDA kernel on the current stream. ``max_q_len`` (the
    largest ``q_lens`` entry, which the engine knows on the host) sizes
    the grid without a device sync; ``None`` takes the whole flat width
    ``N``, whose extra blocks exit at once. Raises on CPU tensors, on
    dtypes, layouts or shapes the kernel does not take, and when the
    launch is refused."""
    N, H, D = q.shape
    B, pages_per_seq = page_table.shape
    page_size = k_pool.shape[1]
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "page_table": page_table, "kv_lens": kv_lens,
               "q_starts": q_starts, "q_lens": q_lens}
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"the ragged attention kernel needs CUDA "
                             f"tensors; {name} is on {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("q", "k_pool", "v_pool"):
        if tensors[name].dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got "
                             f"{tensors[name].dtype}")
    for name in ("page_table", "kv_lens", "q_starts", "q_lens"):
        if tensors[name].dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got "
                             f"{tensors[name].dtype}")
    if (k_pool.shape != v_pool.shape or k_pool.dim() != 4
            or k_pool.shape[2:] != (H, D)):
        raise ValueError(f"pools {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)} as [P, page, H, D]")
    if kv_lens.shape != (B,) or q_starts.shape != (B,) \
            or q_lens.shape != (B,):
        raise ValueError(f"kv_lens/q_starts/q_lens must be [{B}]")
    if not 1 <= page_size <= _MAX_PAGE_SIZE or not 1 <= D <= _MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes page_size <= {_MAX_PAGE_SIZE} "
                         f"and head_dim <= {_MAX_HEAD_DIM}; got "
                         f"{page_size}, {D}")
    scale = float(sm_scale if sm_scale is not None else 1.0 / math.sqrt(D))
    max_q = N if max_q_len is None else min(int(max_q_len), N)
    out = torch.zeros_like(q)
    if max_q <= 0 or N == 0:
        return out
    lib = _kernel_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.ragged_attention_f32(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), kv_lens.data_ptr(), q_starts.data_ptr(),
        q_lens.data_ptr(), out.data_ptr(), B, H, D, page_size,
        pages_per_seq, max_q, scale, stream)
    if err != 0:
        raise RuntimeError(f"ragged attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["ragged_attention"] += 1
    return out


def ragged_attention(q, k_pool, v_pool, page_table, kv_lens, q_starts,
                     q_lens, sm_scale: Optional[float] = None,
                     tier: str = "auto", max_q_len: Optional[int] = None):
    """The ragged paged-attention dispatcher. ``tier``: ``"kernel"``
    (the CUDA kernel; raises on CPU tensors), ``"ref"`` (the plain
    PyTorch version) or ``"auto"`` (the kernel for CUDA tensors, the
    plain version for CPU tensors). ``max_q_len`` only sizes the
    kernel's grid."""
    if tier == "auto":
        tier = "kernel" if q.is_cuda else "ref"
    if tier == "kernel":
        return ragged_attention_cuda(q, k_pool, v_pool, page_table, kv_lens,
                                     q_starts, q_lens, sm_scale=sm_scale,
                                     max_q_len=max_q_len)
    if tier == "ref":
        return ragged_attention_ref(q, k_pool, v_pool, page_table, kv_lens,
                                    q_starts, q_lens, sm_scale=sm_scale)
    raise ValueError(f"tier={tier!r} not in ('auto', 'kernel', 'ref')")
