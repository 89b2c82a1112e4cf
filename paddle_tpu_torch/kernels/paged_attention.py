"""Paged attention over the serving engine's K/V pages.

Counterpart of ``paddle_tpu/kernels/paged_attention.py``. Keys and
values live in a shared paged pool ``[P, page, H, D]`` — float32, or
1-byte int8/fp8 codes beside scale pools ``[P, page, H]`` of float32,
float16 or bfloat16 (quantized serving; K/V = code x scale, the scale
widened to float32) — addressed through a per-slot page table. Three query shapes:

- **ragged** (:func:`ragged_attention`, the unified engine step): one
  flat token block ``q [N, H, D]``; row b owns the flat tokens
  ``[q_starts[b], q_starts[b] + q_lens[b])``, token t of the row sits at
  global position ``kv_lens[b] - q_lens[b] + t`` (``kv_lens`` are
  post-append: the step's own K/V are already in the pool) and attends
  causally through row b's page table over every position up to its
  own. Tokens covered by no row (bucket padding) output exact zeros.
- **decode** (:func:`paged_attention`, the per-tier decode graph): one
  query per slot, ``q [B, H, D]``, at position ``seq_lens[b] - 1``
  (``seq_lens`` post-append), seeing every key position below
  ``seq_lens[b]``. Float pools.
- **mixed** (:func:`mixed_attention`, and :func:`verify_attention`
  which delegates to it: the per-tier chunk-prefill and verify graphs):
  a block ``q [B, T, H, D]`` per slot with ``q_lens [B]`` valid rows;
  row t sits at ``seq_lens[b] - q_lens[b] + t`` and sees every key
  position ``<=`` its own and ``< seq_lens[b]``. Padding rows (``t >=
  q_lens[b]``) lie past ``seq_lens[b]``, so they attend the whole
  context (they are not zeroed). Float pools.

In every shape a query that sees no key (``seq_len == 0``) outputs
exact zeros, and the finite ``NEG_INF`` masks.

Each shape has two tiers behind its dispatcher:

- ``kernel``: a hand-written CUDA kernel — ``csrc/ragged_attention*.cu``
  (one library per page type and scale dtype: a tensor-core tile for
  rows of several
  queries, a bandwidth walk for one-query rows, which ``split_pages``
  splits flash-decode style) replacing the Pallas ``_ragged_kernel`` and
  ``_ragged_split_kernel``; ``csrc/paged_attention.cu`` replacing
  ``_decode_kernel``; ``csrc/mixed_attention.cu`` replacing
  ``_mixed_kernel``. They take CUDA tensors only and raise on anything
  else, and on shapes outside their limits.
- ``ref``: the plain PyTorch version of the JAX ``_lax`` tier
  (:func:`ragged_attention_ref`, :func:`paged_attention_ref`,
  :func:`mixed_attention_ref`) — what the CPU runs and what the kernels
  are held against on the card. The split kernels are held against
  :func:`ragged_attention_ref_split`, the plain version of
  ``ragged_attention_lax_split`` (same chunk order, same merge).

``tier="auto"`` launches the kernel for CUDA tensors and takes the plain
version for CPU tensors; it never falls back from one to the other.
``split_pages`` is a schedule of the ragged kernels only: as on the JAX
side's gather tier, it is inert on the plain path, which is what keeps
split on and off bit-exact end to end on the CPU.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import math
from typing import Optional

import torch

__all__ = ["NEG_INF", "DECODE_MAX_Q", "LAUNCHES", "held_launches",
           "KERNEL_NAMES", "NARROW_KERNEL_NAMES", "SCALE_DTYPES",
           "PAGED_KERNEL",
           "MIXED_KERNEL", "kernel_name", "ragged_rows", "ragged_attention",
           "ragged_attention_ref", "ragged_attention_ref_split",
           "ragged_attention_cuda", "split_active", "paged_attention",
           "paged_attention_ref", "paged_attention_cuda", "mixed_attention",
           "mixed_attention_ref", "mixed_attention_cuda", "mixed_plan",
           "verify_attention"]

NEG_INF = -1e30

# rows of at most this many queries take the ragged kernels' one-query
# walk; a step whose rows are all that short launches no tile kernel
# (kDecodeMaxQ in csrc/ragged_attention.cuh)
DECODE_MAX_Q = 1

# kernel launches by kernel name: each wrapper adds one where it launches
# its kernel and nowhere else, so a run can show which kernels it went
# through (reset with LAUNCHES.clear())
LAUNCHES: "collections.Counter[str]" = collections.Counter()


@contextlib.contextmanager
def held_launches():
    """The kernel launches a CUDA-graph capture holds. The wrappers count
    as usual inside the block; on exit the yielded Counter holds what
    they counted and ``LAUNCHES`` is set back, since a capture launches
    nothing. A replay runs no Python: add the Counter to ``LAUNCHES``
    at each replay of the graph."""
    before = LAUNCHES.copy()
    held: "collections.Counter[str]" = collections.Counter()
    try:
        yield held
    finally:
        held.update(LAUNCHES - before)
        LAUNCHES.clear()
        LAUNCHES.update(before)

# the kernels' limits: the decode kernel and the ragged kernels' one-query
# rows walk pages of at most 32 keys with D padded to 32, 64 or 128 (eight
# columns a lane, csrc/paged_walk.cuh), and the tile pads D the same way;
# the mixed kernel's key blocks hold at least two whole pages and at most
# 128 columns
_MAX_PAGE_SIZE = 32
_MAX_HEAD_DIM = 128

# page dtype -> (library in csrc/, its C entry point, kernel-name suffix)
_LIBS = {torch.float32: ("ragged_attention", "ragged_attention_f32", ""),
         torch.int8: ("ragged_attention_int8", "ragged_attention_int8",
                      "_int8"),
         torch.float8_e4m3fn: ("ragged_attention_fp8", "ragged_attention_fp8",
                               "_fp8")}


# (code page dtype, narrow scale dtype) -> the same triple: the code pages
# whose scale pools are stored in float16 or bfloat16, widened to float32
# in registers as each page is staged
_NARROW_LIBS = {
    (code, scale): (f"ragged_attention_{c}_{s}", f"ragged_attention_{c}_{s}",
                    f"_{c}_{s}s")
    for code, c in ((torch.int8, "int8"), (torch.float8_e4m3fn, "fp8"))
    for scale, s in ((torch.float16, "f16"), (torch.bfloat16, "bf16"))}
SCALE_DTYPES = (torch.float32, torch.float16, torch.bfloat16)


def _lib(dtype: torch.dtype, scale_dtype: Optional[torch.dtype]) -> tuple:
    if scale_dtype in (None, torch.float32):
        return _LIBS[dtype]
    return _NARROW_LIBS[(dtype, scale_dtype)]


def kernel_name(dtype: torch.dtype, split: bool,
                scale_dtype: Optional[torch.dtype] = None) -> str:
    """The ``LAUNCHES`` key of the kernel for ``dtype`` pages, unsplit
    or split, with float32 scale pools (``None``) or narrow ones (e.g.
    ``ragged_attention_split_int8``, ``ragged_attention_int8_bf16s``)."""
    return ("ragged_attention" + ("_split" if split else "")
            + _lib(dtype, scale_dtype)[2])


KERNEL_NAMES = tuple(kernel_name(dt, sp) for sp in (False, True)
                     for dt in _LIBS)
# the narrow-scale variants of the code pages' kernels
NARROW_KERNEL_NAMES = tuple(kernel_name(dt, sp, sd) for sp in (False, True)
                            for dt, sd in _NARROW_LIBS)
# the per-tier graphs' kernels: decode, and mixed (chunk and verify)
PAGED_KERNEL = "paged_attention"
MIXED_KERNEL = "mixed_attention"


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


def _entry(lib_name: str, entry: str, n_ptr: int, n_int: int):
    """C entry point ``entry`` of kernel library ``lib_name`` (built at
    first use): ``n_ptr`` pointers, ``n_int`` ints, then the float
    softmax scale and the stream; returns a CUDA error code."""
    from ._build import load

    fn = getattr(load(lib_name), entry)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_inputs(kernel: str, q, tensors: dict, index_names) -> None:
    """The checks every kernel wrapper makes: each tensor on CUDA, on
    ``q``'s device and contiguous; ``q`` float32; the index tensors
    ``index_names`` int32."""
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"the {kernel} kernel needs CUDA tensors; "
                             f"{name} is on {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype != torch.float32:
        raise ValueError(f"q must be float32, got {q.dtype}")
    for name in index_names:
        if tensors[name].dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got "
                             f"{tensors[name].dtype}")


def _check_pools(k_pool, v_pool, q_shape, H: int, D: int) -> None:
    """Pools ``[P, page, H, D]`` matching ``q``'s heads and head dim,
    inside the kernels' limits."""
    if (k_pool.shape != v_pool.shape or k_pool.dim() != 4
            or k_pool.shape[2:] != (H, D)):
        raise ValueError(f"pools {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q_shape)} as [P, page, H, D]")
    page_size = k_pool.shape[1]
    if not 1 <= page_size <= _MAX_PAGE_SIZE or not 1 <= D <= _MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes page_size <= {_MAX_PAGE_SIZE} "
                         f"and head_dim <= {_MAX_HEAD_DIM}; got "
                         f"{page_size}, {D}")


def ragged_attention_cuda(q, k_pool, v_pool, page_table, kv_lens, q_starts,
                          q_lens, sm_scale: Optional[float] = None,
                          max_q_len: Optional[int] = None, k_scale=None,
                          v_scale=None, split_pages: int = 0):
    """Launch the CUDA kernel for the pools' page type on the current
    stream: float32 pools, or int8 / float8_e4m3fn code pools with
    scale pools ``[P, page, H]`` of float32, float16 or bfloat16 (both
    of one dtype; the kernel reads them as stored). ``split_pages`` in ``(0,
    pages_per_seq)`` launches the KV split: one-query rows walk their
    pages in chunks into a float32 workspace from PyTorch's caching
    allocator, merged by a fixed-order combine; rows of several queries
    walk unsplit. Anything else launches the unsplit kernels. ``max_q_len`` (the
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
    _check_inputs("ragged attention", q, tensors,
                  ("page_table", "kv_lens", "q_starts", "q_lens"))
    if k_pool.dtype not in _LIBS or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"pools must both be one of {list(_LIBS)}, got "
                         f"{k_pool.dtype}/{v_pool.dtype}")
    _check_pools(k_pool, v_pool, q.shape, H, D)
    if quant:
        for name in ("k_scale", "v_scale"):
            t = tensors[name]
            if (t.dtype not in SCALE_DTYPES or t.dtype != k_scale.dtype
                    or t.shape != k_pool.shape[:3]):
                raise ValueError(f"{name} must be one of {SCALE_DTYPES} "
                                 f"{tuple(k_pool.shape[:3])} (both scales "
                                 f"of one dtype), got {t.dtype} "
                                 f"{tuple(t.shape)}")
    if kv_lens.shape != (B,) or q_starts.shape != (B,) \
            or q_lens.shape != (B,):
        raise ValueError(f"kv_lens/q_starts/q_lens must be [{B}]")
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
    scale_dtype = k_scale.dtype if quant else None
    lib_name, entry, _ = _lib(k_pool.dtype, scale_dtype)
    fn = _entry(lib_name, entry, 11, 8)
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
    LAUNCHES[kernel_name(k_pool.dtype, split, scale_dtype)] += 1
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
    if _resolve_tier(tier, q) == "kernel":
        return ragged_attention_cuda(q, k_pool, v_pool, page_table, kv_lens,
                                     q_starts, q_lens, sm_scale=sm_scale,
                                     max_q_len=max_q_len, k_scale=k_scale,
                                     v_scale=v_scale, split_pages=split_pages)
    return ragged_attention_ref(q, k_pool, v_pool, page_table, kv_lens,
                                q_starts, q_lens, sm_scale=sm_scale,
                                k_scale=k_scale, v_scale=v_scale)


# ------------------------------------------------ decode and mixed tiers


def mixed_attention_ref(q, k_pool, v_pool, page_table, seq_lens, q_lens,
                        sm_scale: Optional[float] = None):
    """Plain PyTorch mixed attention, float32: ``mixed_attention_lax``
    step for step. Gathers every slot's whole table ``[B, S, H, D]`` (S =
    pages_per_seq * page) and attends ``q [B, T, H, D]``: row t of slot
    b at position ``seq_lens[b] - q_lens[b] + t`` sees key positions
    ``<=`` its own and ``< seq_lens[b]``; padding rows attend the whole
    context; a slot with ``seq_len == 0`` outputs zeros."""
    B, T, H, D = q.shape
    S = page_table.shape[1] * k_pool.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    pages = page_table.long()
    k = k_pool[pages].reshape(B, S, H, D)
    v = v_pool[pages].reshape(B, S, H, D)
    logits = torch.einsum("bthd,bshd->bhts", q, k) * scale
    pos = torch.arange(S, device=q.device)
    q_pos = ((seq_lens - q_lens)[:, None]
             + torch.arange(T, device=q.device)[None, :])         # [B, T]
    mask = ((pos[None, None, :] <= q_pos[:, :, None])
            & (pos[None, None, :] < seq_lens[:, None, None]))     # [B,T,S]
    logits = torch.where(mask[:, None], logits,
                         torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(m <= NEG_INF / 2, torch.zeros_like(probs), probs)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def paged_attention_ref(q, k_pool, v_pool, page_table, seq_lens,
                        sm_scale: Optional[float] = None):
    """Plain PyTorch decode attention, float32: the plain version of
    ``paged_attention_lax``. One query per slot, ``q [B, H, D]``, seeing
    key positions ``< seq_lens[b]``: :func:`mixed_attention_ref` with one
    valid row per slot (its causal bound ``<= seq_len - 1`` is the same
    mask)."""
    ones = torch.ones_like(seq_lens)
    return mixed_attention_ref(q[:, None], k_pool, v_pool, page_table,
                               seq_lens, ones, sm_scale=sm_scale)[:, 0]


def _check_table(page_table, seq_lens, B: int) -> None:
    if page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(f"page_table must be [{B}, pages_per_seq], got "
                         f"{tuple(page_table.shape)}")
    if seq_lens.shape != (B,):
        raise ValueError(f"seq_lens must be [{B}], got "
                         f"{tuple(seq_lens.shape)}")


def _check_float_pools(k_pool, v_pool) -> None:
    if k_pool.dtype != torch.float32 or v_pool.dtype != torch.float32:
        raise ValueError(f"the per-tier kernels take float32 pools, got "
                         f"{k_pool.dtype}/{v_pool.dtype}")


def paged_attention_cuda(q, k_pool, v_pool, page_table, seq_lens,
                         sm_scale: Optional[float] = None):
    """Launch the decode kernel (``csrc/paged_attention.cu``) on the
    current stream: ``q [B, H, D]`` float32, float32 pools, int32
    ``page_table [B, pages_per_seq]`` and ``seq_lens [B]``. Raises on
    CPU tensors, on dtypes, layouts or shapes the kernel does not take,
    and when the launch is refused."""
    B, H, D = q.shape
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "page_table": page_table, "seq_lens": seq_lens}
    _check_inputs("paged attention", q, tensors, ("page_table", "seq_lens"))
    _check_float_pools(k_pool, v_pool)
    _check_pools(k_pool, v_pool, q.shape, H, D)
    _check_table(page_table, seq_lens, B)
    out = torch.empty_like(q)
    if B == 0:
        return out
    scale = float(sm_scale if sm_scale is not None else 1.0 / math.sqrt(D))
    fn = _entry("paged_attention", "paged_attention_f32", 6, 5)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(), B,
             H, D, k_pool.shape[1], page_table.shape[1], scale,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES[PAGED_KERNEL] += 1
    return out


# the mixed kernel's key blocks: 64 positions of whole pages
_MIXED_KEY_BLOCK = 64


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def mixed_plan(B: int, T: int, H: int, page_size: int, pages_per_seq: int,
               n_sm: int, split_blocks: Optional[int] = None):
    """The mixed kernel's schedule, decided on the host from the grid:
    ``(tile_rows, split_blocks, n_split)``. A block owns ``tile_rows``
    query rows of one (slot, head): 8 for ``T <= 8`` (verify), else 64.
    When those tiles would leave SMs idle (fewer than ``n_sm``), each
    row's key blocks (64 positions of whole pages) are split into
    ``n_split`` chunks of ``split_blocks`` blocks, about two blocks per
    SM in all, merged in fixed order by a second pass. ``split_blocks``
    forces the split (0: unsplit)."""
    tile_rows = 8 if T <= 8 else 64
    n_kb = -(-pages_per_seq // (_MIXED_KEY_BLOCK // page_size))
    if split_blocks is None:
        tiles = -(-T // tile_rows) * H * B
        want = -(-2 * n_sm // tiles) if tiles < n_sm else 1
        split_blocks = -(-n_kb // want)
    split_blocks = int(split_blocks)
    if not 0 < split_blocks < n_kb:
        return tile_rows, 0, 1
    return tile_rows, split_blocks, -(-n_kb // split_blocks)


def mixed_attention_cuda(q, k_pool, v_pool, page_table, seq_lens, q_lens,
                         sm_scale: Optional[float] = None,
                         split_blocks: Optional[int] = None):
    """Launch the mixed kernel (``csrc/mixed_attention.cu``) on the
    current stream: ``q [B, T, H, D]`` float32, float32 pools, int32
    ``page_table [B, pages_per_seq]``, ``seq_lens [B]`` and ``q_lens
    [B]``. Every row is written, padding rows included. The split of
    the key walk is :func:`mixed_plan`'s (``split_blocks`` forces it; 0
    runs unsplit). Raises on CPU tensors, on dtypes, layouts or shapes
    the kernel does not take, and when the launch is refused."""
    B, T, H, D = q.shape
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "page_table": page_table, "seq_lens": seq_lens,
               "q_lens": q_lens}
    _check_inputs("mixed attention", q, tensors,
                  ("page_table", "seq_lens", "q_lens"))
    _check_float_pools(k_pool, v_pool)
    _check_pools(k_pool, v_pool, q.shape, H, D)
    _check_table(page_table, seq_lens, B)
    if q_lens.shape != (B,):
        raise ValueError(f"q_lens must be [{B}], got {tuple(q_lens.shape)}")
    out = torch.empty_like(q)
    if B == 0 or T == 0:
        return out
    page_size, pps = k_pool.shape[1], page_table.shape[1]
    tile_rows, split, n_split = mixed_plan(
        B, T, H, page_size, pps, _sm_count(q.device.index or 0),
        split_blocks)
    part_ml = part_acc = None
    if n_split > 1:
        part_ml = torch.empty(B, T, H, n_split, 2, dtype=torch.float32,
                              device=q.device)
        part_acc = torch.empty(B, T, H, n_split, D, dtype=torch.float32,
                               device=q.device)
    scale = float(sm_scale if sm_scale is not None else 1.0 / math.sqrt(D))
    fn = _entry("mixed_attention", "mixed_attention_f32", 9, 9)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             page_table.data_ptr(), seq_lens.data_ptr(), q_lens.data_ptr(),
             out.data_ptr(), 0 if part_ml is None else part_ml.data_ptr(),
             0 if part_acc is None else part_acc.data_ptr(), B, T, H, D,
             page_size, pps, tile_rows, split, n_split, scale,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mixed attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES[MIXED_KERNEL] += 1
    return out


def _resolve_tier(tier: str, q) -> str:
    if tier == "auto":
        return "kernel" if q.is_cuda else "ref"
    if tier not in ("kernel", "ref"):
        raise ValueError(f"tier={tier!r} not in ('auto', 'kernel', 'ref')")
    return tier


def paged_attention(q, k_pool, v_pool, page_table, seq_lens,
                    sm_scale: Optional[float] = None, tier: str = "auto"):
    """Decode attention over the paged pool, one query per slot.
    ``tier``: ``"kernel"`` (the CUDA decode kernel; raises on CPU
    tensors), ``"ref"`` (:func:`paged_attention_ref`) or ``"auto"``
    (the kernel for CUDA tensors, the plain version for CPU tensors)."""
    if _resolve_tier(tier, q) == "kernel":
        return paged_attention_cuda(q, k_pool, v_pool, page_table, seq_lens,
                                    sm_scale=sm_scale)
    return paged_attention_ref(q, k_pool, v_pool, page_table, seq_lens,
                               sm_scale=sm_scale)


def mixed_attention(q, k_pool, v_pool, page_table, seq_lens, q_lens,
                    sm_scale: Optional[float] = None, tier: str = "auto"):
    """Mixed attention over the paged pool: a ``[T, H, D]`` query block
    per slot with ``q_lens`` valid rows (the chunk-prefill shape).
    ``tier`` as in :func:`paged_attention`, with the mixed kernel and
    :func:`mixed_attention_ref`."""
    if _resolve_tier(tier, q) == "kernel":
        return mixed_attention_cuda(q, k_pool, v_pool, page_table, seq_lens,
                                    q_lens, sm_scale=sm_scale)
    return mixed_attention_ref(q, k_pool, v_pool, page_table, seq_lens,
                               q_lens, sm_scale=sm_scale)


def verify_attention(q, k_pool, v_pool, page_table, seq_lens, q_lens,
                     sm_scale: Optional[float] = None, tier: str = "auto"):
    """Speculative-decode verify attention: per slot the pending token
    and its drafts (``q_lens[b] = 1 + drafts``) attend causally through
    the page table. The mixed shape exactly, so it delegates to
    :func:`mixed_attention`: one kernel serves chunk prefill and
    verification."""
    return mixed_attention(q, k_pool, v_pool, page_table, seq_lens, q_lens,
                           sm_scale=sm_scale, tier=tier)
