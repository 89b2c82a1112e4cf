"""GPT (decoder-only transformer) for training on one GPU.

Counterpart of ``paddle_tpu/text/gpt.py``: the same config, module tree
and parameter names (``gpt.h.0.attn.qkv.weight`` ...; Paddle's ``[in,
out]`` linear weights), the fused and unfused forward, the tied-embedding
logits and the streamed (chunked) LM loss. Attention goes through
``sdpa_array``, which sends every flash-eligible shape to the
hand-written flash kernels on the card.

Dropout (``hidden_dropout_prob`` after the embeddings and each residual
branch, ``attention_probs_dropout_prob`` on the attention probabilities)
draws from the threefry generator and runs the dropout kernel on the
card; in training it keeps the model off the fused stack, as in the JAX
package (``_can_fuse``). ``use_recompute`` replays the forward's dropout
keys in its recompute. Incremental decode: ``caches`` (per-layer ``(k,
v)`` concatenated, or ``(kbuf, vbuf, length)`` static buffers with a
write cursor) and ``generate`` (greedy or top-k / top-p sampling keyed
as the JAX ``_scan_generate_core``; here an eager loop of one-token
steps over the static buffers).

Not ported (each raises ``NotImplementedError``): tensor parallelism
(``use_mp``), sequence parallelism other than ``sp_mode`` ``"hint"`` /
``None`` / ``"none"`` (which have no effect on one device).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..amp.auto_cast import amp_cast, autocast_suspended
from ..core import threefry
from ..device import resolve_device
from ..kernels.fused_transformer import checkpoint_keys, fused_block_stack_flat
from ..nn import Dropout, Embedding, LayerNorm, Linear
from ..nn.functional import (cross_entropy, gelu,
                             scaled_dot_product_attention, softmax)

__all__ = ["GPTConfig", "GPTAttention", "GPTMLP", "GPTBlock",
           "GPTEmbeddings", "GPTModel", "GPTForCausalLM",
           "gpt_params_from_jax"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    use_mp: bool = False
    use_recompute: bool = False
    recompute_policy: Optional[str] = None
    tie_word_embeddings: bool = True
    sp_mode: Optional[str] = "hint"
    fused_stack: bool = True
    # the JAX stack's static unroll; the port's stack is always a loop
    fused_stack_unroll: bool = False
    loss_chunks: int = 1
    # attention tier of the flash route: "auto" (kernels on the card,
    # plain versions on the CPU), "kernel" or "ref" (the plain versions
    # on any device, what the card's kernel route is held against)
    attn_tier: str = "auto"

    @staticmethod
    def gpt2_small():
        return GPTConfig(hidden_size=768, num_hidden_layers=12,
                         num_attention_heads=12, intermediate_size=3072)

    @staticmethod
    def gpt3_1p3b():
        return GPTConfig(hidden_size=2048, num_hidden_layers=24,
                         num_attention_heads=32, intermediate_size=8192,
                         max_position_embeddings=2048)

    @staticmethod
    def tiny():
        return GPTConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                         num_attention_heads=4, intermediate_size=128,
                         max_position_embeddings=128)


class GPTAttention(torch.nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.num_heads = cfg.num_attention_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.qkv = Linear(cfg.hidden_size, 3 * cfg.hidden_size, device=device)
        self.out_proj = Linear(cfg.hidden_size, cfg.hidden_size,
                               device=device)
        self.dropout_p = cfg.attention_probs_dropout_prob
        self.attn_tier = cfg.attn_tier

    @staticmethod
    def _static_cache_attention(q, k, v, cache):
        """The preallocated KV cache: ``cache = (kbuf, vbuf, length)``,
        buffers ``[B, L, H, D]`` and ``length`` the tokens written
        before this call. Writes k and v at the cursor (in the buffers'
        dtype), attends query i to keys ``j <= length + i`` (the rest
        masked with float32's lowest value) and returns ``(out, (kbuf,
        vbuf, length + S))``; the buffers are written in place."""
        kbuf, vbuf, length = cache
        n = int(length)
        S = q.shape[1]
        with torch.no_grad():
            kbuf[:, n:n + S] = k.to(kbuf.dtype)
            vbuf[:, n:n + S] = v.to(vbuf.dtype)
            D = q.shape[-1]
            scale = torch.tensor(1.0 / np.sqrt(D), dtype=q.dtype)
            qt = q.transpose(1, 2) * scale.to(q.device)
            kt = kbuf.transpose(1, 2).to(q.dtype)
            vt = vbuf.transpose(1, 2).to(q.dtype)
            logits = torch.matmul(qt.float(), kt.float().transpose(-1, -2))
            L = kbuf.shape[1]
            j = torch.arange(L, device=q.device)[None, :]
            i = torch.arange(S, device=q.device)[:, None]
            logits = logits.masked_fill(~(j <= n + i),
                                        torch.finfo(torch.float32).min)
            probs = torch.softmax(logits, dim=-1)
            out = torch.matmul(probs.to(vt.dtype), vt)
        return out.transpose(1, 2).to(q.dtype), (kbuf, vbuf, n + S)

    def forward(self, x, cache=None):
        B, S, H = x.shape
        qkv = self.qkv(x).reshape(B, S, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.unbind(dim=2)
        if cache is not None and len(cache) == 3:
            out, new_cache = self._static_cache_attention(q, k, v, cache)
            return self.out_proj(out.reshape(B, S, H)), new_cache
        if cache is not None:
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
        out = scaled_dot_product_attention(
            q, k, v, is_causal=True, dropout_p=self.dropout_p,
            training=self.training, tier=self.attn_tier)
        out = self.out_proj(out.reshape(B, S, H))
        if cache is not None:
            return out, (k, v)
        return out


class GPTMLP(torch.nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.fc_in = Linear(cfg.hidden_size, cfg.intermediate_size,
                            device=device)
        self.fc_out = Linear(cfg.intermediate_size, cfg.hidden_size,
                             device=device)

    def forward(self, x):
        return self.fc_out(gelu(self.fc_in(x), approximate=True))


class GPTBlock(torch.nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.ln_1 = LayerNorm(cfg.hidden_size, device=device)
        self.attn = GPTAttention(cfg, device)
        self.ln_2 = LayerNorm(cfg.hidden_size, device=device)
        self.mlp = GPTMLP(cfg, device)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        self._use_recompute = cfg.use_recompute

    def _body(self, x):
        x = x + self.dropout(self.attn(self.ln_1(x)))
        return x + self.dropout(self.mlp(self.ln_2(x)))

    def forward(self, x, cache=None):
        if cache is not None:           # incremental decode
            a, new_cache = self.attn(self.ln_1(x), cache=cache)
            x = x + self.dropout(a)
            x = x + self.dropout(self.mlp(self.ln_2(x)))
            return x, new_cache
        if self._use_recompute and self.training:
            return checkpoint_keys(self._body, x)
        return self._body(x)


class GPTEmbeddings(torch.nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size,
                                         device=device)
        self.position_embeddings = Embedding(cfg.max_position_embeddings,
                                             cfg.hidden_size, device=device)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, position_offset=0):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device) \
            + position_offset
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        return self.dropout(x)


# block params in the order the fused stack reads them
_BLOCK_PARAMS = ("ln_1.weight", "ln_1.bias", "attn.qkv.weight",
                 "attn.qkv.bias", "attn.out_proj.weight", "attn.out_proj.bias",
                 "ln_2.weight", "ln_2.bias", "mlp.fc_in.weight",
                 "mlp.fc_in.bias", "mlp.fc_out.weight", "mlp.fc_out.bias")


class GPTModel(torch.nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.config = cfg
        self.embeddings = GPTEmbeddings(cfg, device)
        self.h = torch.nn.ModuleList([GPTBlock(cfg, device)
                                      for _ in range(cfg.num_hidden_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, device=device)

    def _can_fuse(self) -> bool:
        """The fused stack runs when the blocks are plain layers: no
        cache and dropout off (p == 0 or eval), as the JAX package's."""
        cfg = self.config
        if not cfg.fused_stack or len(self.h) == 0:
            return False
        return not (self.training and (cfg.hidden_dropout_prob > 0.0 or
                                       cfg.attention_probs_dropout_prob
                                       > 0.0))

    def _fused_forward(self, x):
        """The stack as the JAX package's one ``fused_block_stack`` op:
        under ``amp.auto_cast`` its inputs take the op's cast (gray under
        O1: none) and nothing inside casts."""
        cfg = self.config
        flat = [b.get_parameter(name) for b in self.h for name in _BLOCK_PARAMS]
        x, *flat = amp_cast("fused_block_stack", x, *flat)
        with autocast_suspended():
            return fused_block_stack_flat(
                x, *flat, num_layers=len(self.h),
                num_heads=cfg.num_attention_heads, causal=True,
                epsilon=self.h[0].ln_1._epsilon,
                remat=cfg.recompute_policy or cfg.use_recompute,
                attn_tier=cfg.attn_tier)

    def forward(self, input_ids, caches=None, position_offset=0):
        x = self.embeddings(input_ids, position_offset=position_offset)
        if caches is not None:          # incremental decode
            if len(caches) != len(self.h):
                raise ValueError(f"got {len(caches)} caches for "
                                 f"{len(self.h)} layers")
            new_caches = []
            for block, cache in zip(self.h, caches):
                x, nc = block(x, cache=cache)
                new_caches.append(nc)
            return self.ln_f(x), new_caches
        if self._can_fuse():
            return self.ln_f(self._fused_forward(x))
        for block in self.h:
            x = block(x)
        return self.ln_f(x)


class GPTForCausalLM(torch.nn.Module):
    """The GPT LM. Built on ``device`` (default ``cuda``; ``"cpu"`` runs
    the plain PyTorch path) with random weights from ``seed`` (Paddle's
    initializers: Xavier-normal linears and tables, zero biases, unit
    LayerNorm); :func:`gpt_params_from_jax` loads the JAX model's."""

    def __init__(self, cfg: GPTConfig, device=None, seed: int = 0):
        super().__init__()
        if cfg.use_mp:
            raise NotImplementedError("tensor-parallel GPT (use_mp) is not "
                                      "ported (queued with the mesh slice)")
        if cfg.sp_mode not in ("hint", None, "none"):
            raise NotImplementedError(f"sequence parallelism sp_mode="
                                      f"{cfg.sp_mode!r} is not ported")
        dev = resolve_device(device)
        self.config = cfg
        self.gpt = GPTModel(cfg, dev)
        self.lm_head = (None if cfg.tie_word_embeddings else
                        Linear(cfg.hidden_size, cfg.vocab_size,
                               bias_attr=False, device=dev))
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        for m in self.modules():
            if isinstance(m, (Linear, Embedding)):
                m.reset_parameters(gen)

    def forward(self, input_ids):
        return self._logits(self.gpt(input_ids))

    def _logits(self, h):
        if self.lm_head is not None:
            return self.lm_head(h)
        h, w = amp_cast("matmul", h,
                        self.gpt.embeddings.word_embeddings.weight)
        return torch.matmul(h, w.t())

    def _decode_core(self, input_ids, caches, position_offset):
        """One decode step: the stack over ``input_ids`` against the
        static caches; the last position's logits and the new caches."""
        h, new_caches = self.gpt(input_ids, caches=caches,
                                 position_offset=position_offset)
        return self._logits(h[:, -1:, :]), new_caches

    @staticmethod
    def _pick_device(logits, do_sample, top_k, top_p, temperature, key):
        """The next token of each row of ``logits [B, V]`` on the device
        (the JAX ``_pick_jnp``): argmax, or temperature, top-k and top-p
        masking and ``categorical`` under ``key`` (noise over the whole
        ``[B, V]``)."""
        lf = logits.float()
        if not do_sample:
            return torch.argmax(lf, dim=-1).to(torch.int32)
        lf = torch.div(lf, torch.full_like(lf, max(float(temperature),
                                                   1e-6)))
        V = lf.shape[-1]
        k = min(int(top_k), V) if top_k else 0
        neg_inf = torch.tensor(float("-inf"), device=lf.device)
        if k and k > 0:
            kth = torch.topk(lf, k, dim=-1)[0][..., -1:]
            lf = torch.where(lf < kth, neg_inf, lf)
        if top_p < 1.0:
            sorted_l = torch.sort(lf, dim=-1, descending=True)[0]
            probs = softmax(sorted_l, axis=-1)
            csum = torch.cumsum(probs, dim=-1)
            keep_sorted = csum - probs < top_p    # the top one always kept
            cutoff = keep_sorted.sum(dim=-1, keepdim=True)
            kth = torch.gather(sorted_l, -1, cutoff - 1)
            lf = torch.where(lf < kth, neg_inf, lf)
        return threefry.categorical(threefry.as_key(key, lf.device),
                                    lf).to(torch.int32)

    @torch.no_grad()
    def _generate_core(self, input_ids, key, *, max_new_tokens, do_sample,
                       top_k, top_p, temperature, eos_token_id, final_len):
        """Prefill, then one-token steps over static ``[B, final_len, H,
        D]`` float32 caches: at step t the key is split (``key, sub =
        split(key)``), the token picked with ``sub`` from the last
        logits, and (but for the last) fed back at position t. Returns
        the new tokens ``[B, max_new_tokens]`` (int32)."""
        cfg = self.config
        B = input_ids.shape[0]
        nh = cfg.num_attention_heads
        hd = cfg.hidden_size // nh
        dev = input_ids.device
        caches = [(torch.zeros(B, final_len, nh, hd, device=dev),
                   torch.zeros(B, final_len, nh, hd, device=dev), 0)
                  for _ in range(cfg.num_hidden_layers)]
        logits, caches = self._decode_core(input_ids, caches, 0)
        finished = torch.zeros(B, dtype=torch.bool, device=dev)
        P = input_ids.shape[1]
        toks = []
        for t in range(P, P + max_new_tokens):
            key, sub = threefry.split(key)
            nxt = self._pick_device(logits[:, 0, :], do_sample, top_k, top_p,
                                    temperature, sub)
            if eos_token_id is not None:
                nxt = torch.where(finished, torch.full_like(
                    nxt, eos_token_id), nxt)
                finished = finished | (nxt == eos_token_id)
            toks.append(nxt)
            if t + 1 < P + max_new_tokens:
                logits, caches = self._decode_core(nxt[:, None].long(),
                                                   caches, t)
        return torch.stack(toks, dim=1)

    def generate(self, input_ids, max_new_tokens=20, max_length=None,
                 do_sample=False, top_k=0, top_p=1.0, temperature=1.0,
                 eos_token_id=None, seed=None):
        """Autoregressive decode with preallocated KV caches (the JAX
        ``generate``): greedy by default, top-k / top-p with
        ``do_sample=True``, keyed from ``PRNGKey(seed)`` (a random seed
        drawn with numpy when None). Returns the prompt and the new
        tokens, ``[B, P + T]`` int64 on the prompt's device; with
        ``eos_token_id`` every row emits eos after its first one, and
        the tokens end once every row has emitted it."""
        cfg = self.config
        if max_length is not None:
            max_new_tokens = max_length - input_ids.shape[1]
            if max_new_tokens <= 0:
                raise ValueError(
                    f"max_length={max_length} <= prompt length "
                    f"{input_ids.shape[1]}")
        final_len = input_ids.shape[1] + max_new_tokens
        if final_len > cfg.max_position_embeddings:
            raise ValueError(
                f"generation would reach position {final_len} but "
                f"max_position_embeddings={cfg.max_position_embeddings} "
                "(position lookups would silently clamp)")
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31 - 1))
        was_training = self.training
        self.eval()
        try:
            new = self._generate_core(
                input_ids.long(), threefry.prng_key(seed),
                max_new_tokens=max_new_tokens, do_sample=do_sample,
                top_k=top_k, top_p=top_p, temperature=temperature,
                eos_token_id=eos_token_id, final_len=final_len)
        finally:
            if was_training:
                self.train()
        tokens = torch.cat([input_ids.long(), new.long()], dim=1)
        if eos_token_id is not None:
            # cut once every row has emitted eos (the early break of a
            # host loop, applied after the fact, as the JAX package does)
            P = input_ids.shape[1]
            hit = (tokens[:, P:] == eos_token_id).cpu().numpy()
            if hit.any(axis=1).all():
                cut = int(hit.argmax(axis=1).max()) + 1
                tokens = tokens[:, :P + cut]
        return tokens

    @staticmethod
    def _pick(logits, do_sample, top_k, top_p, temperature, rng):
        """The host twin of :meth:`_pick_device` on numpy ``logits [B,
        V]`` with a numpy ``rng`` (the JAX package's ``_pick``)."""
        if not do_sample:
            return logits.argmax(-1).astype(np.int64)
        logits = logits / max(temperature, 1e-6)
        top_k = min(top_k, logits.shape[-1]) if top_k else 0
        if top_k and top_k > 0:
            kth = np.partition(logits, -top_k, axis=-1)[:, -top_k][:, None]
            logits = np.where(logits < kth, -np.inf, logits)
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        if top_p < 1.0:
            order = np.argsort(-probs, axis=-1)
            sorted_p = np.take_along_axis(probs, order, axis=-1)
            csum = np.cumsum(sorted_p, axis=-1)
            keep_sorted = csum - sorted_p < top_p  # always keep the top one
            keep = np.zeros_like(probs, bool)
            np.put_along_axis(keep, order, keep_sorted, axis=-1)
            probs = np.where(keep, probs, 0.0)
            probs /= probs.sum(-1, keepdims=True)
        return np.stack([rng.choice(probs.shape[-1], p=probs[b])
                         for b in range(probs.shape[0])]).astype(np.int64)

    def loss(self, input_ids, labels):
        chunks = int(self.config.loss_chunks)
        if chunks > 1:
            return self._chunked_loss(input_ids, labels, chunks)
        logits = self(input_ids)
        B, S, V = logits.shape
        return cross_entropy(logits.reshape(B * S, V), labels.reshape(B * S))

    def _chunked_loss(self, input_ids, labels, chunks: int):
        """Streamed LM loss: the head matmul and the cross-entropy run
        over ``chunks`` row chunks, so the ``[B*S, V]`` logits are never
        whole in memory (see :class:`_ChunkedSoftmaxCE`)."""
        h = self.gpt(input_ids)
        B, S, H = h.shape
        n = B * S
        if n % chunks:
            raise ValueError(f"loss_chunks={chunks} must divide B*S={n}")
        if self.lm_head is not None:
            wm = self.lm_head.weight                               # [H, V]
        else:
            wm = self.gpt.embeddings.word_embeddings.weight.t()    # [H, V]
        return _ChunkedSoftmaxCE.apply(h.reshape(n, H), wm,
                                       labels.reshape(n), chunks)


def _mm_f32(a, b):
    """``a @ b`` returned in float32 with the products summed in float32:
    the JAX ``einsum(..., preferred_element_type=float32)``. float32
    inputs take a plain matmul; low-precision inputs on CUDA a GEMM with
    a float32 output, elsewhere the same arithmetic on float32 copies."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


class _ChunkedSoftmaxCE(torch.autograd.Function):
    """Mean softmax cross-entropy of ``h [n, H] @ wm [H, V]`` against
    ``y [n]`` (rows labelled -100 are ignored), streamed over row chunks
    with the JAX ``custom_vjp``'s rounding points: chunk logits in the
    store dtype (bf16 for bf16 ``h``, else float32), the logsumexp in
    float32, probabilities saved in the store dtype for the backward
    (no recompute of the logits matmul). The backward forms ``dl = (p -
    onehot) * g / count`` in float32, casts it to the store dtype before
    its two matmuls, and sums ``dW`` over the chunks in float32."""

    IGNORE = -100

    @staticmethod
    def forward(ctx, h, wm, y, chunks):
        n, H = h.shape
        store = h.dtype if h.dtype in (torch.bfloat16, torch.float16) \
            else torch.float32
        hc = h.reshape(chunks, n // chunks, H)
        yc = y.reshape(chunks, n // chunks)
        valid = yc != _ChunkedSoftmaxCE.IGNORE
        count = valid.sum().clamp(min=1)
        safe = torch.where(valid, yc, torch.zeros_like(yc)).long()
        probs = torch.empty(chunks, n // chunks, wm.shape[1], dtype=store,
                            device=h.device)
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for c in range(chunks):
            logits = torch.matmul(hc[c], wm).to(store)
            mf = logits.amax(dim=-1, keepdim=True).float()
            lf = logits.float()
            lse = mf[:, 0] + torch.log(torch.exp(lf - mf).sum(dim=-1))
            picked = logits.gather(1, safe[c][:, None])[:, 0].float()
            total = total + torch.where(valid[c], lse - picked,
                                        torch.zeros_like(lse)).sum()
            probs[c] = torch.exp(lf - lse[:, None]).to(store)
        ctx.save_for_backward(hc, wm, safe, valid, probs, count)
        return total / count.float()

    @staticmethod
    def backward(ctx, g):
        hc, wm, safe, valid, probs, count = ctx.saved_tensors
        chunks, rows, H = hc.shape
        scale = (g / count.float()).float()
        dw = torch.zeros(wm.shape, dtype=torch.float32, device=wm.device)
        dh = torch.empty_like(hc)
        for c in range(chunks):
            row_scale = torch.where(valid[c], scale, torch.zeros_like(scale))
            dl = probs[c].float()
            dl.scatter_add_(1, safe[c][:, None],
                            -valid[c].float()[:, None])   # p - onehot(y)
            dl = (dl * row_scale[:, None]).to(probs.dtype)
            dh[c] = torch.matmul(dl, wm.t()).to(hc.dtype)
            dw += _mm_f32(hc[c].t(), dl)
        return dh.reshape(chunks * rows, H), dw.to(wm.dtype), None, None


def gpt_params_from_jax(arrays: Dict[str, np.ndarray], model: GPTForCausalLM
                        ) -> GPTForCausalLM:
    """Load the JAX model's parameters into ``model`` in place and return
    it. ``arrays`` maps the JAX model's ``named_parameters()`` names to
    numpy arrays (bf16 arrays as numpy's ``bfloat16`` extension type);
    the names and layouts are the port's own (Paddle's ``[in, out]``
    linear weights on both sides), so no array is transposed, and each
    keeps its dtype. Raises on a missing, extra or misshapen name."""
    params = dict(model.named_parameters())
    if set(arrays) != set(params):
        raise KeyError(f"names differ: missing {sorted(set(params) - set(arrays))}"
                       f", extra {sorted(set(arrays) - set(params))}")
    with torch.no_grad():
        for name, p in params.items():
            arr = np.asarray(arrays[name])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {arr.shape}, the model's "
                                 f"{tuple(p.shape)}")
            if arr.dtype.name == "bfloat16":
                t = torch.from_numpy(arr.view(np.uint16).copy()).view(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(arr))
            p.data = t.to(p.device)
    return model
