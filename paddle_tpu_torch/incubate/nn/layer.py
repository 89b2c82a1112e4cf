"""The fused layers of ``paddle.incubate.nn`` (counterpart of
``paddle_tpu/incubate/nn/layer.py``): parameters under the JAX
package's names and shapes, forwards through ``functional.py``."""
from __future__ import annotations

from ...kernels.fused_transformer import fused_block_stack
from ...nn.initializer import Constant
from ...nn.layer.layers import Layer
from . import functional as FF

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer", "FusedMultiTransformer",
           "FusedLinear", "FusedBiasDropoutResidualLayerNorm"]


def _ones(layer, shape):
    return layer.create_parameter(shape, default_initializer=Constant(1.0))


class FusedLinear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, transpose_weight=False, name=None):
        super().__init__()
        shape = ([out_features, in_features] if transpose_weight
                 else [in_features, out_features])
        self.weight = self.create_parameter(shape, attr=weight_attr)
        self.bias = (self.create_parameter([out_features], attr=bias_attr,
                                           is_bias=True)
                     if bias_attr is not False else None)
        self._transpose = transpose_weight

    def forward(self, x):
        return FF.fused_linear(x, self.weight, self.bias, self._transpose)


class FusedMultiHeadAttention(Layer):
    """The pre- or post-LN self-attention block (a separate key or value
    raises: self-attention only, as in the JAX package)."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, name=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("num_heads must divide embed_dim")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.normalize_before = normalize_before
        self._dropout = dropout_rate
        self._attn_dropout = attn_dropout_rate
        self._epsilon = epsilon
        mk = self.create_parameter
        self.qkv_weight = mk([embed_dim, 3 * embed_dim])
        self.qkv_bias = mk([3 * embed_dim], is_bias=True)
        self.linear_weight = mk([embed_dim, embed_dim])
        self.linear_bias = mk([embed_dim], is_bias=True)
        self.pre_ln_scale = _ones(self, [embed_dim])
        self.pre_ln_bias = mk([embed_dim], is_bias=True)
        self.ln_scale = _ones(self, [embed_dim])
        self.ln_bias = mk([embed_dim], is_bias=True)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        if (key is not None and key is not query) or \
                (value is not None and value is not query):
            raise NotImplementedError(
                "FusedMultiHeadAttention here is self-attention only "
                "(qkv from query) — cross-attention key/value are not "
                "supported; use nn.MultiHeadAttention")
        return FF.fused_multi_head_attention(
            query, self.qkv_weight, self.linear_weight, cache_kv=cache,
            pre_layer_norm=self.normalize_before,
            pre_ln_scale=self.pre_ln_scale, pre_ln_bias=self.pre_ln_bias,
            ln_scale=self.ln_scale, ln_bias=self.ln_bias,
            pre_ln_epsilon=self._epsilon, qkv_bias=self.qkv_bias,
            linear_bias=self.linear_bias, attn_mask=attn_mask,
            dropout_rate=self._dropout,
            attn_dropout_rate=self._attn_dropout,
            ln_epsilon=self._epsilon, training=self.training,
            num_heads=self.num_heads)


class FusedFeedForward(Layer):
    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None, ln2_bias_attr=None,
                 nranks=1, ring_id=-1, name=None):
        super().__init__()
        self.normalize_before = normalize_before
        self._dropout = dropout_rate
        self._act_dropout = (act_dropout_rate if act_dropout_rate is not None
                             else dropout_rate)
        self._activation = activation
        self._epsilon = epsilon
        mk = self.create_parameter
        self.linear1_weight = mk([d_model, dim_feedforward])
        self.linear1_bias = mk([dim_feedforward], is_bias=True)
        self.linear2_weight = mk([dim_feedforward, d_model])
        self.linear2_bias = mk([d_model], is_bias=True)
        self.ln1_scale = _ones(self, [d_model])
        self.ln1_bias = mk([d_model], is_bias=True)
        self.ln2_scale = _ones(self, [d_model])
        self.ln2_bias = mk([d_model], is_bias=True)

    def forward(self, src, cache=None):
        return FF.fused_feedforward(
            src, self.linear1_weight, self.linear2_weight,
            linear1_bias=self.linear1_bias, linear2_bias=self.linear2_bias,
            ln1_scale=self.ln1_scale, ln1_bias=self.ln1_bias,
            ln2_scale=self.ln2_scale, ln2_bias=self.ln2_bias,
            dropout1_rate=self._act_dropout, dropout2_rate=self._dropout,
            activation=self._activation, ln1_epsilon=self._epsilon,
            ln2_epsilon=self._epsilon,
            pre_layer_norm=self.normalize_before, training=self.training)


class FusedTransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False, name=None):
        super().__init__()
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=(attn_dropout_rate if attn_dropout_rate
                               is not None else dropout_rate),
            normalize_before=normalize_before)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before)

    def forward(self, src, src_mask=None, cache=None):
        return self.ffn(self.fused_attn(src, attn_mask=src_mask, cache=cache))


class FusedMultiTransformer(Layer):
    """The pre-LN causal decoder stack as one call: ``[L, ...]`` stacked
    parameters (``qkv_w [L, E, 3E]``), inference form."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu",
                 normalize_before=True, ln_scale_attrs=None,
                 ln_bias_attrs=None, num_layers=-1, epsilon=1e-5, name=None):
        super().__init__()
        if not normalize_before:
            raise NotImplementedError("FusedMultiTransformer is pre-LN")
        if activation not in ("gelu",):
            raise NotImplementedError("fused stack uses gelu")
        if dropout_rate != 0.0:
            raise NotImplementedError(
                "fused stack requires dropout_rate=0.0 (reference runs it "
                "at inference where dropout is off)")
        if num_layers < 1:
            raise ValueError("num_layers must be >= 1")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self._epsilon = epsilon
        L, E, F = num_layers, embed_dim, dim_feedforward
        mk = self.create_parameter
        self.ln1_g = _ones(self, [L, E])
        self.ln1_b = mk([L, E], is_bias=True)
        self.qkv_w = mk([L, E, 3 * E])
        self.qkv_b = mk([L, 3 * E], is_bias=True)
        self.out_w = mk([L, E, E])
        self.out_b = mk([L, E], is_bias=True)
        self.ln2_g = _ones(self, [L, E])
        self.ln2_b = mk([L, E], is_bias=True)
        self.fc1_w = mk([L, E, F])
        self.fc1_b = mk([L, F], is_bias=True)
        self.fc2_w = mk([L, F, E])
        self.fc2_b = mk([L, E], is_bias=True)

    def forward(self, src, attn_mask=None, caches=None, time_step=None):
        if attn_mask is not None or caches is not None or \
                time_step is not None:
            raise NotImplementedError(
                "FusedMultiTransformer here runs full causal attention; "
                "attn_mask/caches/time_step (incremental decode) are not "
                "supported — use the unfused GPT blocks for generation")
        return fused_block_stack(
            src, self.ln1_g, self.ln1_b, self.qkv_w, self.qkv_b, self.out_w,
            self.out_b, self.ln2_g, self.ln2_b, self.fc1_w, self.fc1_b,
            self.fc2_w, self.fc2_b, num_heads=self.num_heads, causal=True,
            epsilon=self._epsilon)


class FusedBiasDropoutResidualLayerNorm(Layer):
    """Layer form of ``fused_bias_dropout_residual_layer_norm``."""

    def __init__(self, embed_dim, dropout_rate=0.5, weight_attr=None,
                 bias_attr=None, epsilon=1e-5, name=None):
        super().__init__()
        self.linear_bias = self.create_parameter([embed_dim], is_bias=True)
        self.ln_scale = _ones(self, [embed_dim])
        self.ln_bias = self.create_parameter([embed_dim], is_bias=True)
        self.dropout_rate = dropout_rate
        self.epsilon = epsilon

    def forward(self, x, residual):
        return FF.fused_bias_dropout_residual_layer_norm(
            x, residual, bias=self.linear_bias, ln_scale=self.ln_scale,
            ln_bias=self.ln_bias, dropout_rate=self.dropout_rate,
            ln_epsilon=self.epsilon, training=self.training)
