"""Decoder-only LM forward for the serving engine.

Counterpart of ``paddle_tpu/inference/llm/model.py``: a standard
pre-LN GPT block stack (learned positional embeddings, tied output
head) over a parameter dict with the JAX package's names and layouts,
including the head-major packed ``wqkv [d, 3, H*D]``. The serving path
is :func:`lm_ragged_step` — one mixed step over a flat ragged token
block, single device, float32 activations — which writes each layer's
new K/V into the paged pools IN PLACE (JAX returns new pools; here the
step owns the engine's pools and updates them where they lie). With
quantized KV pages the codes and their scales are written in place the
same way; with weight-only int8 every serving matmul weight is an
``@q``/``@s`` pair dequantized in front of its matmul (:func:`_w`), and
with the int8 weight matmul (``weight_matmul="int8"``) the codes are
stored transposed (``@qt``) and each activation row is quantized and
multiplied int8 x int8 instead, through the kernels of
``kernels/int8.py`` (:func:`_int8_dot`).

The per-tier graphs the unified step replaced, and which remain the
reference for it: :func:`lm_prefill` (dense causal prefill,
``sdpa_reference``), :func:`lm_chunk_prefill` (one chunk of one
sequence through the mixed attention kernel), :func:`lm_decode` (one
token per slot through the decode kernel) and :func:`lm_verify` (the
pending token plus drafts per slot through the mixed kernel). They
take the JAX functions' arguments, write the pools in place and return
the logits alone; like the JAX graphs they serve float32 pools only
(weight-only int8 works through :func:`_w`, and ``weight_matmul="int8"``
through :func:`_int8_dot`).

Numerics follow the reference: LayerNorm with population variance and
eps 1e-5, the tanh-approximate GELU (``jax.nn.gelu``'s default),
positions clamped to ``max_seq_len - 1``, logits through the tied
embedding.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...device import resolve_device
from ...kernels.attention import sdpa_reference
from ...kernels.int8 import dequantize, int8_matmul, quantize_rows
from ...kernels.paged_attention import (mixed_attention, paged_attention,
                                        ragged_attention, verify_attention)
from .kv_cache import (block_page_indices, chunk_page_indices, page_offsets,
                       ragged_page_indices)
from .quant import QuantConfig, quantize_kv, quantize_lm_weights, \
    quantized_weight_names

__all__ = ["ModelSpec", "TorchLM", "init_lm_params", "params_from_jax",
           "lm_prefill", "lm_chunk_prefill", "lm_decode", "lm_verify",
           "lm_ragged_step", "resolve_carry_tokens", "step_carry"]


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    vocab: int
    d_model: int
    num_layers: int
    num_heads: int
    head_dim: int
    max_seq_len: int


def _param_shapes(spec: ModelSpec) -> Dict[str, tuple]:
    hd = spec.num_heads * spec.head_dim
    shapes = {"embed": (spec.vocab, spec.d_model),
              "pos": (spec.max_seq_len, spec.d_model)}
    for l in range(spec.num_layers):
        shapes.update({
            f"l{l}.ln1_g": (spec.d_model,), f"l{l}.ln1_b": (spec.d_model,),
            f"l{l}.wqkv": (spec.d_model, 3, hd),
            f"l{l}.wo": (hd, spec.d_model),
            f"l{l}.ln2_g": (spec.d_model,), f"l{l}.ln2_b": (spec.d_model,),
            f"l{l}.wfc": (spec.d_model, 4 * spec.d_model),
            f"l{l}.wproj": (4 * spec.d_model, spec.d_model),
        })
    shapes.update({"lnf_g": (spec.d_model,), "lnf_b": (spec.d_model,)})
    return shapes


def init_lm_params(spec: ModelSpec, seed: int = 0,
                   device=None) -> Dict[str, torch.Tensor]:
    """Seeded random float32 parameters with the reference's names,
    shapes and scales (LayerNorm gains 1, biases 0, weights N(0, 0.02)),
    drawn from a ``torch.Generator`` on ``device``. The values differ
    from ``JaxLM``'s (threefry); to serve the reference's exact weights
    carry them across with :func:`params_from_jax`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = {}
    for name, shape in sorted(_param_shapes(spec).items()):
        if name.endswith("_g"):
            params[name] = torch.ones(shape, device=dev)
        elif name.endswith("_b"):
            params[name] = torch.zeros(shape, device=dev)
        else:
            params[name] = 0.02 * torch.randn(shape, generator=gen,
                                              device=dev)
    return params


def params_from_jax(np_params: Mapping[str, np.ndarray],
                    device=None) -> Dict[str, torch.Tensor]:
    """The reference's parameters (``JaxLM.params`` as numpy arrays,
    same names and layouts) as tensors on ``device``, each in its own
    dtype: float32 weights stay float32, and the int8 ``@q`` codes and
    float32 ``@s`` scales of ``JaxLM.quantize_weights()`` stay int8 and
    float32."""
    dev = resolve_device(device)
    return {name: torch.from_numpy(np.array(arr)).to(dev)
            for name, arr in np_params.items()}


def _ln(x, g, b):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * g + b


def _w(p, name):
    """A matmul weight from either parameter layout: the float
    ``name`` entry, or the weight-only int8 pair ``name@q``/``name@s``
    (per-output-channel codes and scales) dequantized here, in front of
    the matmul."""
    if name in p:
        return p[name]
    return dequantize(p[name + "@q"], p[name + "@s"])


def _int8_dot(x, w_qt, w_s):
    """The int8 weight matmul (``weight_matmul="int8"``; JAX
    ``model._int8_dot``): each row of ``x [..., K]`` quantized by its
    absmax (:func:`quantize_rows`), multiplied int8 x int8 with int32
    sums and rescaled once, ``acc * x_scale * w_scale``
    (:func:`int8_matmul`): the kernels on the card, their plain
    versions on the CPU. ``w_qt [N, K]`` is the codes' transposed
    layout (:meth:`TorchLM.with_int8_matmul_layout`); the keepdims scale
    ``w_s [1, ...]`` gives the output's trailing axes (``[1, 3, H*D]``
    for the packed ``wqkv``, N of them flattened)."""
    K = x.shape[-1]
    xq, xs = quantize_rows(x.reshape(-1, K).contiguous())
    out = int8_matmul(xq, xs, w_qt, w_s.reshape(-1))
    return out.reshape(tuple(x.shape[:-1]) + tuple(w_s.shape[1:]))


def _wdot(p, name, x, wm="off"):
    """``x @ weight`` from either parameter layout. Float parameters and
    ``wm == "off"`` compute the expressions of :func:`_w` exactly;
    ``wm == "int8"`` on an ``@qt``/``@s`` pair takes :func:`_int8_dot`."""
    if wm == "int8" and name not in p:
        return _int8_dot(x, p[name + "@qt"], p[name + "@s"])
    return x @ _w(p, name)


def _qkv(p, l, h, wm="off"):
    """``h [..., d] -> (q, k, v)`` each ``[..., H*D]`` through the
    head-major packed ``wqkv [d, 3, H*D]``: one contraction over
    ``d_model``."""
    name = f"l{l}.wqkv"
    if wm == "int8" and name not in p:
        qkv = _int8_dot(h, p[name + "@qt"], p[name + "@s"])
    else:
        qkv = torch.einsum("...d,dch->...ch", h, _w(p, name))
    return qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]


def _mlp(p, l, x, wm="off"):
    h = F.gelu(_wdot(p, f"l{l}.wfc", x, wm), approximate="tanh")
    return _wdot(p, f"l{l}.wproj", h, wm)


def _scatter(pool, pages, offs, values):
    """``pool[pages, offs] = values`` in place; 1-byte float8 pools are
    written through a byte view."""
    if pool.dtype == torch.float8_e4m3fn:
        pool, values = pool.view(torch.uint8), values.view(torch.uint8)
    pool.index_put_((pages, offs), values)


def _block(p, l, x, attend, wm="off"):
    """One pre-LN block: ``attend(q, k, v)`` (each ``[..., H*D]``)
    scatters this layer's K/V and returns the attention ``[..., H*D]``;
    ``wm`` is the weight-matmul mode of its four projections."""
    h = _ln(x, p[f"l{l}.ln1_g"], p[f"l{l}.ln1_b"])
    x = x + _wdot(p, f"l{l}.wo", attend(*_qkv(p, l, h, wm)), wm)
    return x + _mlp(p, l, _ln(x, p[f"l{l}.ln2_g"], p[f"l{l}.ln2_b"]), wm)


def _logits(p, x):
    return _ln(x, p["lnf_g"], p["lnf_b"]) @ p["embed"].T


def _float_pools(k_pool, v_pool) -> None:
    if k_pool.dtype != torch.float32 or v_pool.dtype != torch.float32:
        raise ValueError(f"the per-tier graphs serve float32 pools (the JAX "
                         f"ones have no KV quantization); got "
                         f"{k_pool.dtype}/{v_pool.dtype}")


def lm_prefill(params, spec: ModelSpec, tokens, weight_matmul: str = "off"):
    """Dense prefill. tokens ``[B, S]`` -> (logits ``[B, S, V]``, k
    ``[L, B, S, H, D]``, v ``[L, B, S, H, D]``), causal attention through
    ``sdpa_reference`` as in the JAX graph."""
    B, S = tokens.shape
    H, D = spec.num_heads, spec.head_dim
    x = (params["embed"][tokens.long()]
         + params["pos"][torch.arange(S, device=tokens.device)][None])
    ks, vs = [], []

    def attend(q, k, v):
        k, v = k.reshape(B, S, H, D), v.reshape(B, S, H, D)
        ks.append(k)
        vs.append(v)
        return sdpa_reference(q.reshape(B, S, H, D), k, v,
                              is_causal=True).reshape(B, S, H * D)

    for l in range(spec.num_layers):
        x = _block(params, l, x, attend, weight_matmul)
    return _logits(params, x), torch.stack(ks), torch.stack(vs)


def lm_chunk_prefill(params, spec: ModelSpec, tokens, start, chunk_len,
                     k_pool, v_pool, page_row, attn_tier="auto",
                     weight_matmul: str = "off"):
    """Prefill one CHUNK of one sequence through the paged pools.

    tokens ``[C]`` (zero-padded chunk), ``start`` (the chunk's first
    position == tokens already resident), ``chunk_len`` (valid tokens),
    ``page_row [pages_per_seq]``. Each layer writes the chunk's K/V into
    ``k_pool``/``v_pool`` ``[L, P, page, H, D]`` IN PLACE (padding rows
    to the garbage page, positions clamped) and attends the chunk's
    queries causally over all ``start + chunk_len`` resident tokens with
    :func:`mixed_attention`. Returns logits ``[C, V]``; rows ``>=
    chunk_len`` carry no meaning."""
    _float_pools(k_pool, v_pool)
    wm = weight_matmul
    C = tokens.shape[0]
    H, D = spec.num_heads, spec.head_dim
    dev = tokens.device
    pos = torch.clamp(start + torch.arange(C, device=dev),
                      max=spec.max_seq_len - 1)
    pages, offs = chunk_page_indices(page_row, start, chunk_len, C,
                                     k_pool.shape[2])
    pages = pages.long()
    seq_lens = torch.as_tensor(start + chunk_len, device=dev).reshape(1).to(
        torch.int32)
    q_lens = torch.as_tensor(chunk_len, device=dev).reshape(1).to(
        torch.int32)
    table = page_row[None].contiguous()
    x = params["embed"][tokens.long()] + params["pos"][pos]
    for l in range(spec.num_layers):
        def attend(q, k, v):
            k_pool[l].index_put_((pages, offs), k.reshape(C, H, D))
            v_pool[l].index_put_((pages, offs), v.reshape(C, H, D))
            return mixed_attention(q.reshape(1, C, H, D).contiguous(),
                                   k_pool[l], v_pool[l], table, seq_lens,
                                   q_lens, tier=attn_tier).reshape(C, H * D)
        x = _block(params, l, x, attend, wm)
    return _logits(params, x)


def lm_decode(params, spec: ModelSpec, tokens, positions, k_pool, v_pool,
              page_table, attn_tier="auto", weight_matmul: str = "off"):
    """One decode step for all slots.

    tokens ``[B]`` (each slot's last sampled token), positions ``[B]``
    (its position == the resident length), pools ``[L, P, page, H, D]``.
    Each layer writes the new K/V IN PLACE at ``page_offsets`` (no
    garbage routing, as in the JAX graph) and attends through the page
    table over ``positions + 1`` tokens with :func:`paged_attention`.
    Returns logits ``[B, V]``."""
    _float_pools(k_pool, v_pool)
    wm = weight_matmul
    B = tokens.shape[0]
    H, D = spec.num_heads, spec.head_dim
    pages, offs = page_offsets(page_table, positions, k_pool.shape[2])
    pages = pages.long()
    seq_incl = (positions + 1).to(torch.int32)
    x = params["embed"][tokens.long()] + params["pos"][positions.long()]
    for l in range(spec.num_layers):
        def attend(q, k, v):
            k_pool[l].index_put_((pages, offs), k.reshape(B, H, D))
            v_pool[l].index_put_((pages, offs), v.reshape(B, H, D))
            return paged_attention(q.reshape(B, H, D).contiguous(),
                                   k_pool[l], v_pool[l], page_table,
                                   seq_incl, tier=attn_tier).reshape(
                                       B, H * D)
        x = _block(params, l, x, attend, wm)
    return _logits(params, x)


def lm_verify(params, spec: ModelSpec, tokens, starts, q_lens, k_pool,
              v_pool, page_table, attn_tier="auto",
              weight_matmul: str = "off"):
    """Multi-token VERIFY step for speculative decoding.

    tokens ``[B, T]``: per slot the pending token then up to T-1 drafts
    (rows ``>= q_lens[b]`` are padding); starts ``[B]``: the position of
    row 0 (the resident length, ``lm_decode``'s positions); q_lens
    ``[B]``: 1 + drafts (0 masks the slot's writes). Each layer writes
    every valid row's K/V IN PLACE at ``starts[b] + t`` (speculatively:
    the engine rolls rejected tails back with ``PagedKVCache.truncate``;
    padding to the garbage page) and attends the block through the page
    table with :func:`verify_attention`. Returns logits ``[B, T, V]``:
    row t of slot b is the distribution of the token at position
    ``starts[b] + t + 1``."""
    _float_pools(k_pool, v_pool)
    wm = weight_matmul
    B, T = tokens.shape
    H, D = spec.num_heads, spec.head_dim
    pages, offs = block_page_indices(page_table, starts, q_lens, T,
                                     k_pool.shape[2])
    pages = pages.long()
    dev = tokens.device
    pos = torch.clamp(starts.long()[:, None]
                      + torch.arange(T, device=dev)[None, :],
                      max=spec.max_seq_len - 1)
    seq_incl = (starts + q_lens).to(torch.int32)
    q_lens = q_lens.to(torch.int32)
    x = params["embed"][tokens.long()] + params["pos"][pos]
    for l in range(spec.num_layers):
        def attend(q, k, v):
            k_pool[l].index_put_((pages, offs), k.reshape(B, T, H, D))
            v_pool[l].index_put_((pages, offs), v.reshape(B, T, H, D))
            return verify_attention(q.reshape(B, T, H, D).contiguous(),
                                    k_pool[l], v_pool[l], page_table,
                                    seq_incl, q_lens,
                                    tier=attn_tier).reshape(B, T, H * D)
        x = _block(params, l, x, attend, wm)
    return _logits(params, x)


def resolve_carry_tokens(tokens, tok_src, carry):
    """The step's input tokens against the device-resident carry: flat
    positions with ``tok_src[i] >= 0`` take ``carry[tok_src[i]]`` (the
    slot's last sampled token, never round-tripped through the host)
    instead of ``tokens[i]``. ``tok_src == -1`` everywhere (the serial
    engine) returns ``tokens``."""
    src = torch.clamp(tok_src, 0, carry.shape[0] - 1).long()
    return torch.where(tok_src >= 0, carry[src], tokens)


def step_carry(toks, q_starts, q_lens, carry_in):
    """The next step's carry: slots that sampled this step (``q_lens >
    0``) take their row's LAST sampled token (``toks[q_starts + q_lens
    - 1]``); idle slots keep their previous entry."""
    last = torch.clamp(q_starts + q_lens - 1, 0, toks.shape[0] - 1).long()
    return torch.where(q_lens > 0, toks[last], carry_in).to(torch.int32)


def lm_ragged_step(params, spec: ModelSpec, tokens, q_starts, q_lens,
                   kv_lens, k_pool, v_pool, page_table, attn_tier="auto",
                   max_q_len: Optional[int] = None, k_scale=None,
                   v_scale=None, quant: Optional[QuantConfig] = None,
                   kv_split_pages: int = 0):
    """ONE mixed step for the whole engine, single device, float32
    activations.

    tokens [N]: a flat ragged token block — row b (slot b of
    ``page_table``) owns flat positions ``q_starts[b] .. q_starts[b] +
    q_lens[b])``: a prefill-chunk row carries its chunk, a decode row
    its one pending token, an idle slot has ``q_lens[b] == 0``.
    ``kv_lens [B]`` are POST-step resident lengths. Each layer scatters
    every valid token's K/V into its row's pages of ``k_pool``/
    ``v_pool`` ``[L, P, page, H, D]`` IN PLACE (padding tokens route to
    the garbage page) BEFORE attending the whole flat block through the
    page table in one :func:`ragged_attention` dispatch. ``max_q_len``
    (the largest ``q_lens`` entry, known on the host) only sizes the
    kernel's grid. Returns logits ``[N, V]``: row t's logits are the
    distribution of the token after global position ``kv_lens[b] -
    q_lens[b] + t``; padding rows carry no meaning.

    ``quant`` with ``kv_active`` (and the scale pools ``k_scale``/
    ``v_scale`` ``[L, P, page, H]`` beside 1-byte code pools) quantizes
    every token's K/V at write time — per-(position, head) codes into
    the pools, scales into the scale pools, both in place — and the
    attention dequantizes inside the kernel. ``kv_split_pages`` is the
    kernels' KV-split schedule (see :func:`ragged_attention`); it does
    not change what the step computes."""
    N = tokens.shape[0]
    H, D = spec.num_heads, spec.head_dim
    kv_quant = (quant.kv if quant is not None and quant.kv_active
                else None)
    wm = quant.weight_matmul if quant is not None else "off"
    if (kv_quant is None) != (k_scale is None):
        raise ValueError("scale pools go with a quant config whose kv mode "
                         "is on, and only with one")
    pages, offs, pos, _ = ragged_page_indices(
        page_table, q_starts, q_lens, kv_lens, N, k_pool.shape[2])
    pages, offs = pages.long(), offs.long()
    emb_pos = torch.clamp(pos, max=spec.max_seq_len - 1).long()
    x = params["embed"][tokens.long()] + params["pos"][emb_pos]
    for l in range(spec.num_layers):
        def attend(q, k, v):
            k, v = k.reshape(N, H, D), v.reshape(N, H, D)
            # every padding token writes the garbage page: duplicate
            # indices keep an arbitrary one of their values, which is
            # harmless because page 0 is never inside any row's kv_len
            scales = {}
            if kv_quant is not None:
                k, k_s = quantize_kv(k, kv_quant, quant.scale_dtype)
                v, v_s = quantize_kv(v, kv_quant, quant.scale_dtype)
                k_scale[l].index_put_((pages, offs), k_s)
                v_scale[l].index_put_((pages, offs), v_s)
                scales = dict(k_scale=k_scale[l], v_scale=v_scale[l])
            _scatter(k_pool[l], pages, offs, k)
            _scatter(v_pool[l], pages, offs, v)
            return ragged_attention(
                q.reshape(N, H, D).contiguous(), k_pool[l], v_pool[l],
                page_table, kv_lens, q_starts, q_lens, tier=attn_tier,
                max_q_len=max_q_len, split_pages=kv_split_pages,
                **scales).reshape(N, H * D)
        x = _block(params, l, x, attend, wm)
    return _logits(params, x)


class TorchLM:
    """Bundle of (spec, params, device) the engine serves; the
    counterpart of ``JaxLM``."""

    def __init__(self, spec: ModelSpec, params: Dict[str, torch.Tensor],
                 device=None):
        self.spec = spec
        self.device = resolve_device(device)
        self.params = {name: t.to(self.device) for name, t in params.items()}

    def with_int8_matmul_layout(self) -> "TorchLM":
        """The int8 weight matmul's layout (a new ``TorchLM`` sharing
        this one's other tensors; this one untouched): each ``@q`` code
        tensor ``[K, ...]`` replaced by its transpose ``@qt [N, K]`` (K
        contiguous, what the kernel's B operand loads), so that the
        card holds one copy of the codes. A model in this layout serves
        only ``weight_matmul="int8"``. Idempotent; a float model is
        returned as it is."""
        names = [n for n in quantized_weight_names(self.spec)
                 if n + "@q" in self.params]
        if not names:
            return self
        params = dict(self.params)
        for n in names:
            q = params.pop(n + "@q")
            params[n + "@qt"] = q.reshape(q.shape[0], -1).t().contiguous()
        return TorchLM(self.spec, params, device=self.device)

    def quantize_weights(self) -> "TorchLM":
        """Weight-only int8 (a new ``TorchLM``; this one untouched):
        every serving matmul weight re-stored as per-output-channel int8
        codes and float32 scales (:func:`quant.quantize_lm_weights`).
        Idempotent."""
        if any(n + "@q" in self.params or n + "@qt" in self.params
               for n in quantized_weight_names(self.spec)):
            return self
        return TorchLM(self.spec, quantize_lm_weights(self.params,
                                                      self.spec),
                       device=self.device)

    @classmethod
    def tiny(cls, vocab=128, d_model=32, num_layers=2, num_heads=2,
             head_dim=16, max_seq_len=256, seed=0, device=None) -> "TorchLM":
        """``JaxLM.tiny``'s signature, plus ``device``; the weights are
        seeded from a ``torch.Generator`` (see :func:`init_lm_params`)."""
        spec = ModelSpec(vocab=vocab, d_model=d_model, num_layers=num_layers,
                         num_heads=num_heads, head_dim=head_dim,
                         max_seq_len=max_seq_len)
        return cls(spec, init_lm_params(spec, seed=seed, device=device),
                   device=device)
