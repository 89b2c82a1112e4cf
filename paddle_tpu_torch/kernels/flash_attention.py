"""Flash attention: tiled online-softmax attention, forward and backward.

Counterpart of ``paddle_tpu/kernels/flash_attention.py``. The forward
returns ``o`` and the per-row logsumexp ``lse``; the backward
recomputes the probabilities from ``lse`` (flash-attention's
recomputation scheme, residuals ``q, k, v, o, lse``, ``delta =
rowsum(dO * O)``). Causal masking is bottom-right aligned: query i
attends key j when ``j <= i + (Sk - Sq)``, as in ``sdpa_reference``;
a query that sees no key outputs exact zeros.

Two tiers, one function each way:

- the hand-written CUDA kernels that replace the JAX package's Pallas
  ``_fwd_kernel``, ``_bwd_dkdv_kernel`` and ``_bwd_dq_kernel``:
  :func:`flash_fwd_cuda`, :func:`flash_bwd_dkdv_cuda`,
  :func:`flash_bwd_dq_cuda`. float32 (on the TF32 tensor cores in
  3xTF32, float32-accurate products whatever PyTorch's TF32 flags say:
  ``csrc/flash_fwd_f32.cu`` forward, ``csrc/flash_bwd_f32.cu`` dK/dV
  and dQ, both on ``csrc/flash_f32_tiles.cuh`` and ``csrc/tf32x3.cuh``),
  bf16 or float16 (tensor cores, float32 sums: one source each way,
  ``csrc/flash_fwd_16.cuh`` forward and ``csrc/flash_bwd_16.cuh`` dK/dV
  and dQ, built once per type as ``flash_{fwd,bwd}_{bf16,f16}.cu``),
  head_dim 64 or 128, CUDA tensors only; anything else raises. float16
  has no wider exponent to spare: under a loss scale ``dS`` and the
  gradients may reach inf where the JAX kernel's do, and ``GradScaler``
  skips such a step.
- their plain PyTorch versions :func:`flash_fwd_ref`,
  :func:`flash_bwd_dkdv_ref`, :func:`flash_bwd_dq_ref` (and
  :func:`flash_bwd_ref` for the whole backward): what the CPU runs and
  what the kernels are held against on the card. They keep the
  kernels' rounding points (``p`` cast to the dtype of v or dO, ``dS``
  to the dtype of q or k, float32 sums) over the whole row at once.

:func:`flash_attention_bhsd` / :func:`flash_attention_bshd` are the
public entries. They call the ``torch.library`` op
``paddle_tpu_torch::flash_fwd`` (:func:`flash_fwd_op`), whose registered
autograd (the role of the JAX ``custom_vjp``) forms ``delta`` and calls
``paddle_tpu_torch::flash_bwd_dkdv`` and ``::flash_bwd_dq``. Under
``tier="auto"`` each op launches its kernel for CUDA tensors and takes
the plain version for CPU tensors, never falling back from one to the
other; ``"ref"`` takes the plain versions on any device and ``"kernel"``
insists on the kernels. Each op has a fake implementation, so
``torch.export`` and the static recorder trace through it on tensors
that hold no data.
"""
from __future__ import annotations

import collections
import ctypes
import math
from typing import Optional

import torch

__all__ = ["NEG_INF", "LAUNCHES", "KERNEL_NAMES", "flash_fwd_ref",
           "flash_bwd_dkdv_ref", "flash_bwd_dq_ref", "flash_bwd_ref",
           "flash_fwd_cuda", "flash_bwd_dkdv_cuda", "flash_bwd_dq_cuda",
           "bwd_delta", "flash_fwd_op", "flash_bwd_dkdv_op",
           "flash_bwd_dq_op", "flash_attention_bhsd", "flash_attention_bshd"]

NEG_INF = -1e30

# kernel launches by kernel name: each wrapper adds one where it launches
# its kernel and nowhere else (reset with LAUNCHES.clear())
LAUNCHES: "collections.Counter[str]" = collections.Counter()
KERNEL_NAMES = ("flash_attention_fwd", "flash_attention_bwd_dkdv",
                "flash_attention_bwd_dq")

_HEAD_DIMS = (64, 128)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
           torch.float16: "f16"}
# the library (csrc/<name>.cu) that holds each C entry
_LIBRARY = {"flash_fwd_f32": "flash_fwd_f32",
            "flash_fwd_bf16": "flash_fwd_bf16",
            "flash_fwd_f16": "flash_fwd_f16",
            "flash_bwd_dkdv_bf16": "flash_bwd_bf16",
            "flash_bwd_dq_bf16": "flash_bwd_bf16",
            "flash_bwd_dkdv_f16": "flash_bwd_f16",
            "flash_bwd_dq_f16": "flash_bwd_f16",
            "flash_bwd_dkdv_f32": "flash_bwd_f32",
            "flash_bwd_dq_f32": "flash_bwd_f32"}
_TIERS = ("auto", "kernel", "ref")


def _check_divisible(Sq, Sk, block_q, block_k):
    if Sq % block_q or Sk % block_k:
        raise ValueError(
            f"flash attention requires seq lengths divisible by block sizes: "
            f"Sq={Sq} % block_q={block_q}, Sk={Sk} % block_k={block_k}")


def _causal_mask(Sq: int, Sk: int, device) -> torch.Tensor:
    """``[Sq, Sk]`` bool, True where query i may attend key j: ``j <= i
    + (Sk - Sq)`` (bottom-right aligned). The kernels skip key tiles past
    a query tile's last visible key, the rule of the JAX package's
    ``_causal_skip``, and apply this mask inside the tiles they walk."""
    i = torch.arange(Sq, device=device)[:, None]
    j = torch.arange(Sk, device=device)[None, :]
    return j <= i + (Sk - Sq)


# ------------------------------------------------------------ plain tier


def _probs(q, k, sm_scale, causal, lse=None):
    """``(s, mask)`` with ``s`` the float32 scaled scores, masked entries
    at NEG_INF; with ``lse`` given, ``p = exp(s - lse)`` with masked
    entries zeroed (a fully masked row has ``lse = NEG_INF``, so ``s -
    lse`` alone would give 1 there) in place of ``s``."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    mask = _causal_mask(q.shape[2], k.shape[2], q.device) if causal else None
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    if lse is None:
        return s, mask
    p = torch.exp(s - lse)
    return (p if mask is None else p.masked_fill(~mask, 0.0)), mask


def flash_fwd_ref(q, k, v, sm_scale: float, causal: bool):
    """Plain version of the forward kernel on ``[B, H, S, D]`` tensors:
    returns ``o`` in q's dtype and ``lse`` float32 ``[B, H, Sq, 1]``."""
    s, mask = _probs(q, k, sm_scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l_safe
    return o.to(q.dtype), m + torch.log(l_safe)


def bwd_delta(o, do):
    """``delta = rowsum(dO * O)`` in float32, ``[B, H, Sq, 1]``: formed
    outside the kernels, as the JAX package leaves it to XLA."""
    return torch.sum(do.float() * o.float(), dim=-1, keepdim=True)


def flash_bwd_dkdv_ref(q, k, v, do, lse, delta, sm_scale: float,
                       causal: bool):
    """Plain version of the dK/dV kernel: ``(dk, dv)``."""
    p, _ = _probs(q, k, sm_scale, causal, lse)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta) * sm_scale
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_ref(q, k, v, do, lse, delta, sm_scale: float,
                     causal: bool):
    """Plain version of the dQ kernel: ``dq``."""
    p, _ = _probs(q, k, sm_scale, causal, lse)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta) * sm_scale
    return torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)


def flash_bwd_ref(q, k, v, o, lse, do, sm_scale: float, causal: bool):
    """The whole plain backward: ``(dq, dk, dv)``."""
    delta = bwd_delta(o, do)
    dk, dv = flash_bwd_dkdv_ref(q, k, v, do, lse, delta, sm_scale, causal)
    dq = flash_bwd_dq_ref(q, k, v, do, lse, delta, sm_scale, causal)
    return dq, dk, dv


# ------------------------------------------------------------ CUDA tier


def _entry(kernel: str, dtype: torch.dtype):
    from ._build import load

    name = f"flash_{kernel}_{_SUFFIX[dtype]}"
    fn = getattr(load(_LIBRARY[name]), name)
    if fn.argtypes is None:
        n_ptr = {"fwd": 5, "bwd_dkdv": 8, "bwd_dq": 7}[kernel]
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_void_p]
                       + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_cuda(q, k, v, do=None):
    """Shapes ``q [B, H, Sq, D]``, ``k, v [B, H, Sk, D]`` (and ``do``
    like q), one CUDA device, one dtype the kernels take, head dim
    contiguous. Returns ``(B, H, Sq, Sk, D)``."""
    tensors = {"q": q, "k": k, "v": v}
    if do is not None:
        tensors["do"] = do
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"the flash attention kernels need CUDA "
                             f"tensors; {name} is on {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be [B, H, S, D] with a "
                             f"contiguous head dim")
    if q.dtype not in _SUFFIX:
        raise ValueError(f"the flash attention kernels take {list(_SUFFIX)}, "
                         f"got {q.dtype}")
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if k.shape != (B, H, Sk, D) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)} as [B, H, Sk, D]")
    if do is not None and do.shape != q.shape:
        raise ValueError("do must be shaped like q")
    if D not in _HEAD_DIMS:
        raise ValueError(f"the flash attention kernels take head_dim in "
                         f"{_HEAD_DIMS}, got {D}")
    if not (0 < B <= 65535 and 0 < H <= 65535 and Sq > 0 and Sk > 0):
        raise ValueError(f"shape {(B, H, Sq, Sk)} out of the kernels' range")
    return B, H, Sq, Sk, D


def _strides(*tensors):
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _empty_like_layout(x):
    """An empty ``[B, H, S, D]`` tensor laid out in memory as ``x`` is:
    ``[B, S, H, D]`` memory seen through ``transpose(1, 2)`` when x is
    such a view (the bshd entry's inputs), else contiguous."""
    B, H, S, D = x.shape
    if x.stride(1) < x.stride(2):
        return x.new_empty(B, S, H, D).transpose(1, 2)
    return x.new_empty(B, H, S, D)


def _check_row_stats(q, **stats):
    """``lse`` / ``delta``: contiguous float32 ``[B, H, Sq, 1]`` on q's
    device."""
    want = tuple(q.shape[:3]) + (1,)
    for name, t in stats.items():
        if (t.dtype != torch.float32 or tuple(t.shape) != want
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be a contiguous float32 tensor "
                             f"{list(want)} on {q.device}")


def _launch(name, fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def flash_fwd_cuda(q, k, v, sm_scale: float, causal: bool):
    """Launch the forward kernel on the current stream: ``(o, lse)``,
    ``o`` laid out as q, ``lse`` float32 ``[B, H, Sq, 1]``."""
    B, H, Sq, Sk, D = _check_cuda(q, k, v)
    o = _empty_like_layout(q)
    lse = torch.empty(B, H, Sq, 1, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _launch("flash_attention_fwd", _entry("fwd", q.dtype), q.data_ptr(),
            k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            _strides(q, k, v, o), B, H, Sq, Sk, D, float(sm_scale),
            int(bool(causal)), stream)
    return o, lse


def flash_bwd_dkdv_cuda(q, k, v, do, lse, delta, sm_scale: float,
                        causal: bool):
    """Launch the dK/dV kernel on the current stream: ``(dk, dv)``."""
    B, H, Sq, Sk, D = _check_cuda(q, k, v, do=do)
    _check_row_stats(q, lse=lse, delta=delta)
    dk, dv = _empty_like_layout(k), _empty_like_layout(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _launch("flash_attention_bwd_dkdv", _entry("bwd_dkdv", q.dtype),
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _strides(q, k, v, do, dk, dv), B, H, Sq, Sk, D, float(sm_scale),
            int(bool(causal)), stream)
    return dk, dv


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, sm_scale: float,
                      causal: bool):
    """Launch the dQ kernel on the current stream: ``dq``."""
    B, H, Sq, Sk, D = _check_cuda(q, k, v, do=do)
    _check_row_stats(q, lse=lse, delta=delta)
    dq = _empty_like_layout(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _launch("flash_attention_bwd_dq", _entry("bwd_dq", q.dtype),
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            _strides(q, k, v, do, dq), B, H, Sq, Sk, D, float(sm_scale),
            int(bool(causal)), stream)
    return dq


# --------------------------------------------------------------- public


def _use_kernel(tier: str, q) -> bool:
    if tier not in _TIERS:
        raise ValueError(f"tier={tier!r} not in {_TIERS}")
    return tier == "kernel" or (tier == "auto" and q.is_cuda)


# The three kernels as ``torch.library`` ops (namespace
# ``paddle_tpu_torch``), the one route of every flash call: eager
# training, ``generate``, ``jit.to_static`` (inside a CUDA graph), a
# ``jit.load``-ed layer and a static program. Each op picks its tier from
# the tensors it is given at run time (``_use_kernel``), so a program
# exported or recorded on one device runs the kernels on the card and
# the plain versions on the CPU. Each has a fake implementation that
# gives the shapes (``torch.export``, the static recorder's shape
# inference), and the forward carries the backward through
# ``register_autograd``.


@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 sm_scale: float, causal: bool, tier: str
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)``: the forward kernel for CUDA tensors under ``tier``
    ``"auto"`` or ``"kernel"``, else its plain version."""
    if _use_kernel(tier, q):
        return flash_fwd_cuda(q, k, v, sm_scale, causal)
    return flash_fwd_ref(q, k, v, sm_scale, causal)


@flash_fwd_op.register_fake
def _(q, k, v, sm_scale, causal, tier):
    return _empty_like_layout(q), q.new_empty(
        tuple(q.shape[:3]) + (1,), dtype=torch.float32)


@torch.library.custom_op("paddle_tpu_torch::flash_bwd_dkdv", mutates_args=())
def flash_bwd_dkdv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, lse: torch.Tensor,
                      delta: torch.Tensor, sm_scale: float, causal: bool,
                      tier: str) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)``: the dK/dV kernel or its plain version."""
    if _use_kernel(tier, q):
        return flash_bwd_dkdv_cuda(q, k, v, do, lse, delta, sm_scale, causal)
    return flash_bwd_dkdv_ref(q, k, v, do, lse, delta, sm_scale, causal)


@flash_bwd_dkdv_op.register_fake
def _(q, k, v, do, lse, delta, sm_scale, causal, tier):
    return _empty_like_layout(k), _empty_like_layout(v)


@torch.library.custom_op("paddle_tpu_torch::flash_bwd_dq", mutates_args=())
def flash_bwd_dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                    sm_scale: float, causal: bool, tier: str) -> torch.Tensor:
    """``dq``: the dQ kernel or its plain version."""
    if _use_kernel(tier, q):
        return flash_bwd_dq_cuda(q, k, v, do, lse, delta, sm_scale, causal)
    return flash_bwd_dq_ref(q, k, v, do, lse, delta, sm_scale, causal)


@flash_bwd_dq_op.register_fake
def _(q, k, v, do, lse, delta, sm_scale, causal, tier):
    return _empty_like_layout(q)


def _fwd_setup(ctx, inputs, output):
    q, k, v, sm_scale, causal, tier = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.sm_scale, ctx.causal, ctx.tier = sm_scale, causal, tier
    ctx.mark_non_differentiable(lse)


def _fwd_backward(ctx, do, _dlse):
    """``delta = rowsum(dO * O)``, then the dK/dV and dQ ops. A caller
    that differentiates the backward (``create_graph=True``, so grad
    mode is on here) gets it as a graph of PyTorch ops instead: the
    kernels' backward ops have no derivative of their own."""
    q, k, v, o, lse = ctx.saved_tensors
    if torch.is_grad_enabled():
        return _differentiable_backward(ctx, q, k, v, do)
    if do.stride(-1) != 1:        # e.g. the expanded grad of a sum()
        do = do.contiguous()
    delta = bwd_delta(o, do)
    args = (q, k, v, do, lse, delta, ctx.sm_scale, ctx.causal, ctx.tier)
    dk, dv = flash_bwd_dkdv_op(*args)
    dq = flash_bwd_dq_op(*args)
    return dq, dk, dv, None, None, None


def _differentiable_backward(ctx, q, k, v, do):
    """``(dq, dk, dv)`` of the plain forward recomputed from the saved
    inputs, with its graph kept, so it is differentiable to any order
    in q, k, v and dO (``incubate.autograd``'s ``jvp`` and ``Hessian``).
    The forward and every first-order backward stay on the kernels."""
    ins = [t if t.requires_grad else t.detach().requires_grad_()
           for t in (q, k, v)]
    o, _ = flash_fwd_ref(*ins, ctx.sm_scale, ctx.causal)
    return (*torch.autograd.grad(o, ins, do, create_graph=True),
            None, None, None)


torch.library.register_autograd("paddle_tpu_torch::flash_fwd", _fwd_backward,
                                setup_context=_fwd_setup)


def flash_attention_bhsd(q, k, v, causal: bool = False,
                         sm_scale: Optional[float] = None, block_q: int = 128,
                         block_k: int = 128, tier: str = "auto"):
    """Flash attention on ``[batch, heads, seq, head_dim]`` tensors.
    ``Sq`` and ``Sk`` must divide by ``min(block_q, Sq)`` and
    ``min(block_k, Sk)`` (the JAX package's tiling rule; the kernels tile
    by 64 inside). ``tier``: ``"auto"`` (the kernels for CUDA tensors,
    the plain versions for CPU tensors), ``"kernel"`` or ``"ref"``."""
    Sq, Sk = q.shape[2], k.shape[2]
    _check_divisible(Sq, Sk, min(int(block_q), Sq), min(int(block_k), Sk))
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if tier not in _TIERS:
        raise ValueError(f"tier={tier!r} not in {_TIERS}")
    return flash_fwd_op(q, k, v, float(sm_scale), bool(causal), tier)[0]


def flash_attention_bshd(q, k, v, causal: bool = False,
                         sm_scale: Optional[float] = None, block_q: int = 128,
                         block_k: int = 128, tier: str = "auto"):
    """Flash attention on Paddle-layout ``[batch, seq, heads, head_dim]``.
    The kernels read the transposed views in place (no copy) and write
    the output and the gradients in ``[B, S, H, D]`` memory."""
    o = flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=causal,
                             sm_scale=sm_scale, block_q=block_q,
                             block_k=block_k, tier=tier)
    return o.transpose(1, 2)
