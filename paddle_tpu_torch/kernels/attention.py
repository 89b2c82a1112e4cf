"""Attention cores on Paddle's ``[batch, seq, heads, head_dim]`` layout.

Counterpart of ``paddle_tpu/kernels/attention.py``:

- :func:`sdpa_reference`: plain softmax attention, float32 scores;
- :func:`causal_sdpa_chunked`: causal attention over query chunks that
  skips the score blocks above the diagonal, with the JAX version's
  rounding points (scores stored in the input dtype for bf16);
- :func:`sdpa_array`: the dispatcher.

Dispatch. The JAX package sends causal self-attention at training
shapes to the chunked XLA form and keeps its Pallas flash kernel as a
long-context memory guard on a TPU only, an order measured on the TPU.
Here every flash-eligible shape (no mask, no dropout, head_dim 64 or
128, both lengths divisible by ``min(128, S)``) goes to
:func:`~paddle_tpu_torch.kernels.flash_attention.flash_attention_bshd`,
causal or not: the hand-written kernels on the card, their plain
versions on the CPU. Other shapes keep the JAX order: chunked where it
applies, else :func:`sdpa_reference`. A failed kernel raises; nothing
falls back. Attention-probability dropout (``dropout_p > 0``) keeps the
attention off the flash and chunked routes, as in the JAX package:
``sdpa_array`` draws one key from the threefry generator (unless given
one) and ``sdpa_reference`` drops float32 probabilities through the
dropout kernel (``kernels/dropout.py``), dividing the kept ones by ``1 -
p`` before the product with v.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..core import random as _rng
from ..core.dtypes import at_least_f32
from .dropout import dropout as _dropout
from .flash_attention import NEG_INF, _causal_mask, flash_attention_bshd

__all__ = ["sdpa_reference", "causal_sdpa_chunked", "sdpa_array"]


def sdpa_reference(q, k, v, mask=None, is_causal: bool = False,
                   dropout_p: float = 0.0, key=None,
                   sm_scale: Optional[float] = None):
    """Plain softmax attention with float32 scores (float64 for float64
    inputs). A query row whose
    scores are all masked (causal with ``Sq > Sk``) outputs zeros. A
    boolean ``mask`` keeps True entries; a float mask is added. With
    ``dropout_p > 0`` and a ``key`` the probabilities are dropped
    (``bernoulli(key, 1 - p, [B, H, Sq, Sk])``, kept ones divided by ``1
    - p``) before the product with v."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    logits = torch.matmul(at_least_f32(qt),
                          at_least_f32(kt).transpose(-1, -2)) * scale
    if is_causal:
        logits = logits.masked_fill(~_causal_mask(Sq, Sk, q.device), NEG_INF)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, NEG_INF)
        else:
            logits = logits + mask.to(logits.dtype)
    probs = torch.softmax(logits, dim=-1)
    fully_masked = logits.amax(dim=-1, keepdim=True) <= -1e29
    probs = probs.masked_fill(fully_masked, 0.0)
    if dropout_p > 0.0 and key is not None:
        probs = _dropout(probs, key, dropout_p)
    out = torch.matmul(at_least_f32(probs.to(vt.dtype)), at_least_f32(vt))
    return out.transpose(1, 2).to(q.dtype)


def _scores(qi, kj, ldtype):
    """``qi kj^T`` summed in float32 and stored in ``ldtype``."""
    return torch.matmul(qi.float(), kj.float().transpose(-1, -2)).to(ldtype)


def causal_sdpa_chunked(q, k, v, sm_scale: Optional[float] = None,
                        chunk: int = 256,
                        low_precision_scores: Optional[bool] = None):
    """Causal self-attention over query chunks: chunk i attends keys
    ``[:(i + 1) * chunk]``, the prefix blocks unmasked and the diagonal
    block masked, merged with a two-piece softmax over the shared max.
    ``low_precision_scores`` (default: for bf16/fp16 inputs) stores the
    scores in the input dtype; the softmax runs in float32."""
    B, S, H, D = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    if low_precision_scores is None:
        low_precision_scores = q.dtype in (torch.bfloat16, torch.float16)
    ldtype = q.dtype if low_precision_scores else torch.float32
    qt = q.transpose(1, 2) * torch.tensor(scale, dtype=q.dtype)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    diag = torch.ones(chunk, chunk, dtype=torch.bool, device=q.device).tril()
    # float32's lowest value (in bf16 it rounds to -inf, as in the JAX form)
    fill = torch.tensor(torch.finfo(torch.float32).min).to(ldtype)
    outs = []
    for i in range(S // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        qi = qt[:, :, sl]
        dlf = torch.where(diag, _scores(qi, kt[:, :, sl], ldtype),
                          fill.to(q.device)).float()
        if i == 0:
            probs = torch.softmax(dlf, dim=-1)
            outs.append(torch.matmul(probs.to(vt.dtype), vt[:, :, :chunk]))
            continue
        plf = _scores(qi, kt[:, :, :i * chunk], ldtype).float()
        m = torch.maximum(plf.amax(-1, keepdim=True), dlf.amax(-1, keepdim=True))
        e1 = torch.exp(plf - m)
        e2 = torch.exp(dlf - m)
        denom = e1.sum(-1, keepdim=True) + e2.sum(-1, keepdim=True)
        outs.append(torch.matmul((e1 / denom).to(vt.dtype), vt[:, :, :i * chunk])
                    + torch.matmul((e2 / denom).to(vt.dtype), vt[:, :, sl]))
    return torch.cat(outs, dim=2).transpose(1, 2).to(q.dtype)


def _causal_chunk_for(S: int) -> int:
    """The JAX package's chunk rule: about 16 chunks, at least 256."""
    return max(256, S // 16)


def _flash_eligible(q, k, mask, dropout_p: float) -> bool:
    if mask is not None or dropout_p > 0.0:
        return False
    Sq, D = q.shape[1], q.shape[3]
    Sk = k.shape[1]
    return (D in (64, 128) and Sq > 0 and Sk > 0
            and Sq % min(128, Sq) == 0 and Sk % min(128, Sk) == 0)


def sdpa_array(q, k, v, mask=None, is_causal: bool = False,
               dropout_p: float = 0.0, sm_scale: Optional[float] = None,
               key=None, tier: str = "auto"):
    """The attention dispatcher (see the module docstring). ``tier``
    reaches the flash route only: ``"ref"`` runs the flash kernels'
    plain versions on any device, ``"kernel"`` insists on the kernels."""
    if _flash_eligible(q, k, mask, dropout_p):
        return flash_attention_bshd(q, k, v, causal=is_causal,
                                    sm_scale=sm_scale, tier=tier)
    S = q.shape[1]
    chunk = _causal_chunk_for(S)
    if (is_causal and mask is None and dropout_p == 0.0 and S == k.shape[1]
            and S % chunk == 0 and S >= 2 * chunk):
        return causal_sdpa_chunked(q, k, v, sm_scale=sm_scale, chunk=chunk)
    if dropout_p > 0.0 and key is None:
        key = _rng.next_key()
    return sdpa_reference(q, k, v, mask=mask, is_causal=is_causal,
                          dropout_p=dropout_p, key=key, sm_scale=sm_scale)
