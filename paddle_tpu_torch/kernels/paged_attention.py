"""Ragged paged attention over a flat token block.

Counterpart of ``paddle_tpu/kernels/paged_attention.py``'s ragged tier.
Keys and values live in a shared paged pool ``[P, page, H, D]`` —
float32, or 1-byte int8/fp8 codes beside float32 scale pools ``[P,
page, H]`` (quantized serving; K/V = code x scale); row b
of a step owns the flat query tokens ``[q_starts[b], q_starts[b] +
q_lens[b])`` of ``q [N, H, D]``, and token t of the row sits at global
position ``kv_lens[b] - q_lens[b] + t`` (``kv_lens`` are post-append:
the step's own K/V are already in the pool). It attends causally
through row b's page table over every position up to its own. Tokens
covered by no row (bucket padding) output exact zeros.

Two tiers behind one dispatcher, :func:`ragged_attention`:

- ``kernel``: the hand-written CUDA kernels (``csrc/ragged_attention*.cu``,
  one library per page type) that replace the JAX package's Pallas
  ``_ragged_kernel`` and, with ``split_pages``, its flash-decode
  ``_ragged_split_kernel``. They take CUDA tensors only and raise on
  anything else.
- ``ref``: :func:`ragged_attention_ref`, the plain PyTorch version of
  ``ragged_attention_lax`` — what the CPU runs and what the unsplit
  kernels are held against on the card. The split kernels are held
  against :func:`ragged_attention_ref_split`, the plain version of
  ``ragged_attention_lax_split`` (same chunk order, same merge).

``tier="auto"`` launches a kernel for CUDA tensors and takes the plain
unsplit version for CPU tensors; it never falls back from one to the
other. ``split_pages`` is a schedule of the kernels only: as on the JAX
side's gather tier, it is inert on the plain path, which is what keeps
split on and off bit-exact end to end on the CPU.
"""
from __future__ import annotations

import collections
import ctypes
import math
from typing import Optional

import torch

__all__ = ["NEG_INF", "LAUNCHES", "KERNEL_NAMES", "kernel_name",
           "ragged_rows", "ragged_attention", "ragged_attention_ref",
           "ragged_attention_ref_split", "ragged_attention_cuda",
           "split_active"]

NEG_INF = -1e30

# kernel launches by kernel name: each wrapper adds one where it launches
# its kernel and nowhere else, so a run can show which kernels it went
# through (reset with LAUNCHES.clear())
LAUNCHES: "collections.Counter[str]" = collections.Counter()

# the kernels' limits (csrc/ragged_attention.cuh): one lane per key of
# a page, ceil(D / 32) head-dim elements per lane
_MAX_PAGE_SIZE = 32
_MAX_HEAD_DIM = 128

# page dtype -> (library in csrc/, its C entry point, kernel-name suffix)
_LIBS = {torch.float32: ("ragged_attention", "ragged_attention_f32", ""),
         torch.int8: ("ragged_attention_int8", "ragged_attention_int8",
                      "_int8"),
         torch.float8_e4m3fn: ("ragged_attention_fp8", "ragged_attention_fp8",
                               "_fp8")}


def kernel_name(dtype: torch.dtype, split: bool) -> str:
    """The ``LAUNCHES`` key of the kernel for ``dtype`` pages, unsplit
    or split (e.g. ``ragged_attention_split_int8``)."""
    return "ragged_attention" + ("_split" if split else "") + _LIBS[dtype][2]


KERNEL_NAMES = tuple(kernel_name(dt, sp) for sp in (False, True)
                     for dt in _LIBS)


def split_active(split_pages: int, pages_per_seq: int) -> bool:
    """Whether ``split_pages`` selects the KV split for a page table of
    ``pages_per_seq`` columns (a chunk covering the whole table is the
    unsplit walk)."""
    return 0 < int(split_pages) < pages_per_seq


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


def _pages_f32(pool, scale, pages):
    """``pool[pages]`` as float32 ``[n, page, H, D]``: float pools as
    they are, code pools dequantized (code x its position's and head's
    scale, the product the kernels form while staging a page). Float8
    pools are gathered through a byte view."""
    if scale is None:
        return pool[pages]
    if pool.dtype == torch.float8_e4m3fn:
        codes = pool.view(torch.uint8)[pages].view(pool.dtype)
    else:
        codes = pool[pages]
    return codes.to(torch.float32) * scale[pages].to(torch.float32)[..., None]


def _row_spans(q_starts, q_lens, kv_lens):
    return [(b, qs, ql, kv) for b, (qs, ql, kv) in enumerate(zip(
        q_starts.tolist(), q_lens.tolist(), kv_lens.tolist())) if ql > 0]


def ragged_attention_ref(q, k_pool, v_pool, page_table, kv_lens, q_starts,
                         q_lens, sm_scale: Optional[float] = None,
                         k_scale=None, v_scale=None):
    """Plain PyTorch ragged attention, float32: the same masks and the
    same softmax as ``ragged_attention_lax``. It gathers each ROW's
    context once (``[S, H, D]`` per row, S = pages_per_seq * page,
    dequantized when ``k_scale``/``v_scale`` are given) and attends that
    row's tokens over it, so it fits on the card at prefill shapes;
    padding tokens stay exact zeros. Reads the row metadata on the host
    (one sync): it is the reference, not the fast path."""
    N, H, D = q.shape
    page_size = k_pool.shape[1]
    S = page_table.shape[1] * page_size
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    out = torch.zeros_like(q)
    pos = torch.arange(S, device=q.device)
    for b, qs, ql, kv in _row_spans(q_starts, q_lens, kv_lens):
        pages = page_table[b].long()
        k = _pages_f32(k_pool, k_scale, pages).reshape(S, H, D)
        v = _pages_f32(v_pool, v_scale, pages).reshape(S, H, D)
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


def ragged_attention_ref_split(q, k_pool, v_pool, page_table, kv_lens,
                               q_starts, q_lens, split_pages: int,
                               sm_scale: Optional[float] = None,
                               k_scale=None, v_scale=None):
    """Plain PyTorch version of ``ragged_attention_lax_split``: each
    row's page walk in chunks of ``split_pages`` pages (the table padded
    with the garbage page 0 to a whole number of chunks); each chunk's
    partial softmax state ``(m, l, acc)`` under the exact mask of the
    unsplit version, merged in chunk order::

        m' = max(m, m_c); l' = l e^(m - m') + l_c e^(m_c - m')
        acc' = acc e^(m - m') + acc_c e^(m_c - m')

    from the identity ``(NEG_INF, 0, 0)``, then ``acc / (l == 0 ? 1 :
    l)``. ``split_pages <= 0`` or a chunk covering the whole table is
    :func:`ragged_attention_ref`."""
    N, H, D = q.shape
    page_size = k_pool.shape[1]
    n_pages = page_table.shape[1]
    sp = int(split_pages)
    if not split_active(sp, n_pages):
        return ragged_attention_ref(q, k_pool, v_pool, page_table, kv_lens,
                                    q_starts, q_lens, sm_scale=sm_scale,
                                    k_scale=k_scale, v_scale=v_scale)
    n_chunks = -(-n_pages // sp)
    S_c = sp * page_size
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    out = torch.zeros_like(q)
    pad = torch.zeros(n_chunks * sp - n_pages, dtype=page_table.dtype,
                      device=page_table.device)
    for b, qs, ql, kv in _row_spans(q_starts, q_lens, kv_lens):
        row = torch.cat([page_table[b], pad]).long()
        qb = q[qs:qs + ql]
        q_pos = kv - ql + torch.arange(ql, device=q.device)
        m = torch.full((ql, H, 1), NEG_INF, device=q.device)
        l = torch.zeros((ql, H, 1), device=q.device)
        acc = torch.zeros((ql, H, D), device=q.device)
        for c in range(n_chunks):
            pages = row[c * sp:(c + 1) * sp]
            k = _pages_f32(k_pool, k_scale, pages).reshape(S_c, H, D)
            v = _pages_f32(v_pool, v_scale, pages).reshape(S_c, H, D)
            logits = torch.einsum("thd,shd->ths", qb, k) * scale
            pos = c * S_c + torch.arange(S_c, device=q.device)
            mask = ((pos[None, :] < kv)
                    & (pos[None, :] <= q_pos[:, None]))[:, None, :]
            logits = torch.where(mask, logits,
                                 torch.full_like(logits, NEG_INF))
            m_c = logits.amax(dim=-1, keepdim=True)
            p_c = torch.where(mask, torch.exp(logits - m_c),
                              torch.zeros_like(logits))
            l_c = p_c.sum(dim=-1, keepdim=True)
            acc_c = torch.einsum("ths,shd->thd", p_c, v)
            m_new = torch.maximum(m, m_c)
            alpha = torch.exp(m - m_new)
            beta = torch.exp(m_c - m_new)
            l = l * alpha + l_c * beta
            acc = acc * alpha + acc_c * beta
            m = m_new
        out[qs:qs + ql] = acc / torch.where(l == 0.0, torch.ones_like(l), l)
    return out


def _kernel_fn(dtype: torch.dtype):
    from ._build import load

    lib_name, entry, _ = _LIBS[dtype]
    fn = getattr(load(lib_name), entry)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def ragged_attention_cuda(q, k_pool, v_pool, page_table, kv_lens, q_starts,
                          q_lens, sm_scale: Optional[float] = None,
                          max_q_len: Optional[int] = None, k_scale=None,
                          v_scale=None, split_pages: int = 0):
    """Launch the CUDA kernel for the pools' page type on the current
    stream: float32 pools, or int8 / float8_e4m3fn code pools with
    float32 scale pools ``[P, page, H]``. ``split_pages`` in ``(0,
    pages_per_seq)`` launches the KV split (a chunk pass into a float32
    workspace from PyTorch's caching allocator, then the fixed-order
    combine); anything else the unsplit kernel. ``max_q_len`` (the
    largest ``q_lens`` entry, which the engine knows on the host) sizes
    the grid without a device sync; ``None`` takes the whole flat width
    ``N``, whose extra blocks exit at once. Raises on CPU tensors, on
    dtypes, layouts or shapes the kernels do not take, and when a
    launch is refused."""
    N, H, D = q.shape
    B, pages_per_seq = page_table.shape
    page_size = k_pool.shape[1]
    quant = k_pool.dtype != torch.float32
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "page_table": page_table, "kv_lens": kv_lens,
               "q_starts": q_starts, "q_lens": q_lens}
    if quant:
        if k_scale is None or v_scale is None:
            raise ValueError(f"{k_pool.dtype} code pools need k_scale and "
                             "v_scale")
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    elif k_scale is not None or v_scale is not None:
        raise ValueError("scale pools go with int8/fp8 code pools; the "
                         "K/V pools are float32")
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"the ragged attention kernel needs CUDA "
                             f"tensors; {name} is on {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype != torch.float32:
        raise ValueError(f"q must be float32, got {q.dtype}")
    if k_pool.dtype not in _LIBS or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"pools must both be one of {list(_LIBS)}, got "
                         f"{k_pool.dtype}/{v_pool.dtype}")
    for name in ("page_table", "kv_lens", "q_starts", "q_lens"):
        if tensors[name].dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got "
                             f"{tensors[name].dtype}")
    if (k_pool.shape != v_pool.shape or k_pool.dim() != 4
            or k_pool.shape[2:] != (H, D)):
        raise ValueError(f"pools {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)} as [P, page, H, D]")
    if quant:
        for name in ("k_scale", "v_scale"):
            t = tensors[name]
            if t.dtype != torch.float32 or t.shape != k_pool.shape[:3]:
                raise ValueError(f"{name} must be float32 "
                                 f"{tuple(k_pool.shape[:3])}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
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
    split = split_active(split_pages, pages_per_seq)
    sp = int(split_pages) if split else 0
    ws = None
    if split:
        n_chunks = -(-pages_per_seq // sp)
        ws = torch.empty((n_chunks, N, H, D + 2), dtype=torch.float32,
                         device=q.device)
    fn = _kernel_fn(k_pool.dtype)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             k_scale.data_ptr() if quant else None,
             v_scale.data_ptr() if quant else None,
             page_table.data_ptr(), kv_lens.data_ptr(), q_starts.data_ptr(),
             q_lens.data_ptr(), out.data_ptr(),
             ws.data_ptr() if split else None, N, B, H, D, page_size,
             pages_per_seq, max_q, sp, scale, stream)
    if err != 0:
        raise RuntimeError(f"ragged attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES[kernel_name(k_pool.dtype, split)] += 1
    return out


def ragged_attention(q, k_pool, v_pool, page_table, kv_lens, q_starts,
                     q_lens, sm_scale: Optional[float] = None,
                     tier: str = "auto", max_q_len: Optional[int] = None,
                     k_scale=None, v_scale=None, split_pages: int = 0):
    """The ragged paged-attention dispatcher. ``tier``: ``"kernel"``
    (the CUDA kernel for the pools' page type, split when ``0 <
    split_pages < pages_per_seq``; raises on CPU tensors), ``"ref"``
    (the plain unsplit PyTorch version) or ``"auto"`` (the kernel for
    CUDA tensors, the plain version for CPU tensors). ``k_scale``/
    ``v_scale`` go with int8/fp8 code pools. ``max_q_len`` only sizes
    the kernel's grid."""
    if tier == "auto":
        tier = "kernel" if q.is_cuda else "ref"
    if tier == "kernel":
        return ragged_attention_cuda(q, k_pool, v_pool, page_table, kv_lens,
                                     q_starts, q_lens, sm_scale=sm_scale,
                                     max_q_len=max_q_len, k_scale=k_scale,
                                     v_scale=v_scale, split_pages=split_pages)
    if tier == "ref":
        return ragged_attention_ref(q, k_pool, v_pool, page_table, kv_lens,
                                    q_starts, q_lens, sm_scale=sm_scale,
                                    k_scale=k_scale, v_scale=v_scale)
    raise ValueError(f"tier={tier!r} not in ('auto', 'kernel', 'ref')")
