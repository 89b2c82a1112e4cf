"""The Transformer stack (counterpart of
``paddle_tpu/nn/layer/transformer.py``): ``MultiHeadAttention`` with its
``Cache`` / ``StaticCache`` / ``gen_cache``, the encoder and decoder
layers and stacks, and ``Transformer``.

The attention core is the port's ``nn.functional.
scaled_dot_product_attention`` on ``[B, S, H, D]``, which routes through
``kernels/attention.py``'s dispatcher: without a mask and without
dropout (eval, or ``dropout=0``) to the flash kernels (the float32
forward kernel for float32), with attention dropout to the plain route
with the dropout kernel, as the JAX package's ``sdpa_array`` decides.
An incremental decode (``Cache``, one query against the grown keys)
and the cross-attention take the flash route too.

A reference quirk kept on purpose: ``gen_cache(key, value,
type=StaticCache)`` stores the *q* projection of ``key`` as ``k`` and
its *k* projection as ``v`` (JAX ``transformer.py:56-57``);
``forward`` never reads a ``StaticCache``'s tensors (ROADMAP queue C).
"""
from __future__ import annotations

import collections
import copy

import torch

from .. import functional as F
from .common import Dropout, LayerList, Linear
from .layers import Layer
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


class MultiHeadAttention(Layer):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.head_dim = embed_dim // num_heads
        assert self.head_dim * num_heads == embed_dim
        self.dropout = dropout
        self.need_weights = need_weights
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, weight_attr,
                             bias_attr)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, weight_attr,
                             bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _heads(self, t, B):
        return t.reshape(B, -1, self.num_heads, self.head_dim)

    def _prepare_qkv(self, query, key, value, cache=None):
        B = query.shape[0]
        q = self._heads(self.q_proj(query), B)
        k = self._heads(self.k_proj(key), B)
        v = self._heads(self.v_proj(value), B)
        if isinstance(cache, self.Cache):
            k = torch.cat([cache.k, k], dim=1)
            v = torch.cat([cache.v, v], dim=1)
            cache = self.Cache(k, v)
        return q, k, v, cache

    def gen_cache(self, key, value=None, type=None):  # noqa: A002
        """An empty ``Cache`` ``[B, 0, H, D]`` to grow step by step, or
        with ``type=StaticCache`` the JAX package's static cache (its
        quirk: the q and k projections of ``key``)."""
        if type == MultiHeadAttention.StaticCache:
            q, k, _, _ = self._prepare_qkv(key, key,
                                           key if value is None else value)
            return self.StaticCache(q, k)
        empty = torch.zeros([key.shape[0], 0, self.num_heads,
                             self.head_dim], dtype=key.dtype,
                            device=key.device)
        return self.Cache(empty, empty.clone())

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        q, k, v, cache = self._prepare_qkv(query, key, value, cache)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training)
        out = self.out_proj(out.reshape(out.shape[0], -1, self.embed_dim))
        return out if cache is None else (out, cache)


def _activation(name):
    return getattr(F, name)


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self._act = activation

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(_activation(self._act)(
            self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    """``num_layers`` copies of ``encoder_layer`` (the first is the
    layer given, the rest deep copies), then ``norm``."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [
            copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output, new_caches = src, []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, c = mod(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self._act = activation

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incr_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                             cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(_activation(self._act)(
            self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incr_cache,))

    def gen_cache(self, memory):
        return (self.self_attn.gen_cache(memory),)


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([decoder_layer] + [
            copy.deepcopy(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output, new_caches = tgt, []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, c = mod(output, memory, tgt_mask, memory_mask,
                                cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        return [layer.gen_cache(memory) for layer in self.layers]


class Transformer(Layer):
    """The encoder-decoder Transformer; the defaults are the base model
    of Vaswani et al. 2017 (6 + 6 layers, d_model 512, 8 heads,
    feed-forward 2048, dropout 0.1, ReLU, post-norm)."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            self.encoder = TransformerEncoder(
                enc, num_encoder_layers,
                LayerNorm(d_model) if normalize_before else None)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            self.decoder = TransformerDecoder(
                dec, num_decoder_layers,
                LayerNorm(d_model) if normalize_before else None)
        self.d_model, self.nhead = d_model, nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length):
        """``[length, length]`` float32: 0 on and below the diagonal,
        -1e9 above it, on the current device."""
        from ...core.device import current_device
        from ...core.tensor import as_tensor

        keep = torch.ones((length, length), dtype=torch.bool,
                          device=current_device()).tril()
        return as_tensor(torch.where(
            keep, torch.zeros((), device=keep.device),
            torch.full((), -1e9, device=keep.device)).to(torch.float32))
