"""GPT (decoder-only transformer) for training on one GPU.

Counterpart of ``paddle_tpu/text/gpt.py``: the same config, module tree
and parameter names (``gpt.h.0.attn.qkv.weight`` ...; Paddle's ``[in,
out]`` linear weights), the fused and unfused forward, the tied-embedding
logits and the streamed (chunked) LM loss. Attention goes through
``sdpa_array``, which sends every flash-eligible shape to the
hand-written flash kernels on the card.

Not ported (each raises ``NotImplementedError``): tensor parallelism
(``use_mp``), sequence parallelism other than ``sp_mode`` ``"hint"`` /
``None`` / ``"none"`` (which have no effect on one device), dropout in
training, the selective recompute policies, and the incremental-decode
paths (``caches``, the static KV cache, ``generate``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..kernels.attention import sdpa_array
from ..kernels.fused_transformer import fused_block_stack_flat
from ..nn import Embedding, LayerNorm, Linear
from ..nn.functional import cross_entropy, gelu

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


def _no_cache(cache):
    if cache is not None:
        raise NotImplementedError("the incremental-decode cache paths of the "
                                  "GPT model are not ported (queued)")


class GPTAttention(torch.nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.num_heads = cfg.num_attention_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.qkv = Linear(cfg.hidden_size, 3 * cfg.hidden_size, device=device)
        self.out_proj = Linear(cfg.hidden_size, cfg.hidden_size,
                               device=device)
        self.attn_tier = cfg.attn_tier

    def forward(self, x, cache=None):
        _no_cache(cache)
        B, S, H = x.shape
        qkv = self.qkv(x).reshape(B, S, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.unbind(dim=2)
        out = sdpa_array(q, k, v, is_causal=True, tier=self.attn_tier)
        return self.out_proj(out.reshape(B, S, H))


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
        self._use_recompute = cfg.use_recompute

    def _body(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))

    def forward(self, x, cache=None):
        _no_cache(cache)
        if self._use_recompute and self.training:
            return checkpoint(self._body, x, use_reentrant=False)
        return self._body(x)


class GPTEmbeddings(torch.nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size,
                                         device=device)
        self.position_embeddings = Embedding(cfg.max_position_embeddings,
                                             cfg.hidden_size, device=device)

    def forward(self, input_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        return self.word_embeddings(input_ids) + self.position_embeddings(pos)


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

    def _fused_forward(self, x):
        cfg = self.config
        flat = [b.get_parameter(name) for b in self.h for name in _BLOCK_PARAMS]
        return fused_block_stack_flat(
            x, *flat, num_layers=len(self.h),
            num_heads=cfg.num_attention_heads, causal=True,
            epsilon=self.h[0].ln_1._epsilon,
            remat=cfg.recompute_policy or cfg.use_recompute,
            attn_tier=cfg.attn_tier)

    def forward(self, input_ids, caches=None):
        _no_cache(caches)
        cfg = self.config
        if self.training and (cfg.hidden_dropout_prob > 0.0
                              or cfg.attention_probs_dropout_prob > 0.0):
            raise NotImplementedError(
                "dropout in training needs the port's threefry stream "
                "(queued); set hidden_dropout_prob and "
                "attention_probs_dropout_prob to 0 or call eval()")
        x = self.embeddings(input_ids)
        if cfg.fused_stack and len(self.h) > 0:
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
        return torch.matmul(h, self.gpt.embeddings.word_embeddings.weight.t())

    def generate(self, *args, **kwargs):
        raise NotImplementedError("GPTForCausalLM.generate is not ported "
                                  "(queued with the incremental-decode "
                                  "paths)")

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
