"""The fused functionals of ``paddle.incubate.nn.functional``
(counterpart of ``paddle_tpu/incubate/nn/functional.py``).

Each is the JAX package's composition in the port's ops: LayerNorm in
float32, linears and products through ``ops.matmul`` / ``F.linear``,
dropout through the dropout kernel (threefry keys, as the JAX package
draws them), attention through ``kernels/attention.py``'s ``sdpa_array``
(non-causal): with a mask or attention dropout in training it takes the
plain float32 route with the dropout kernel on the probabilities, else
the flash kernels where the shape allows, the JAX package's routing.
``fused_multi_transformer`` is ``kernels/fused_transformer.py``'s
pre-LN causal block stack (tanh GELU) over the per-layer parameters
stacked on a leading axis, the inference form: it raises where the JAX
one raises (a cache, post-LN, a mask, another activation, dropout,
``trans_qkvw=False``).

``qkv_weight`` comes in the reference layout ``[3, heads, head_dim,
embed]`` or as ``[embed, 3 embed]`` (then ``num_heads`` is needed).
"""
from __future__ import annotations

import torch

from ...core.tensor import to_tensor_arg
from ...kernels.fused_transformer import fused_block_stack
from ...nn import functional as F
from ...ops.math import matmul

__all__ = ["fused_multi_head_attention", "fused_feedforward",
           "fused_bias_dropout_residual_layer_norm", "fused_linear",
           "fused_matmul_bias", "fused_multi_transformer"]


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    """``x @ weight + bias`` (``weight`` ``[out, in]`` with
    ``transpose_weight``)."""
    weight = to_tensor_arg(weight)
    return F.linear(x, weight.t() if transpose_weight else weight, bias)


fused_matmul_bias = fused_linear


def fused_bias_dropout_residual_layer_norm(
        x, residual, bias=None, ln_scale=None, ln_bias=None,
        dropout_rate=0.5, ln_epsilon=1e-5, training=True,
        mode="upscale_in_train", name=None):
    """``LayerNorm(residual + dropout(x + bias))``."""
    y = x if bias is None else x + bias
    if dropout_rate > 0.0 and training:
        y = F.dropout(y, p=dropout_rate, training=training, mode=mode)
    y = residual + y
    return F.layer_norm(y, [y.shape[-1]], ln_scale, ln_bias, ln_epsilon)


def _ln(x, on, scale, bias, eps):
    return F.layer_norm(x, [x.shape[-1]], scale, bias, eps) if on else x


def fused_multi_head_attention(
        x, qkv_weight, linear_weight, pre_layer_norm=False,
        pre_ln_scale=None, pre_ln_bias=None, ln_scale=None, ln_bias=None,
        pre_ln_epsilon=1e-5, qkv_bias=None, linear_bias=None,
        cache_kv=None, attn_mask=None, dropout_rate=0.5,
        attn_dropout_rate=0.5, ln_epsilon=1e-5, training=True,
        mode="upscale_in_train", ring_id=-1, add_residual=True,
        num_heads=None, name=None):
    """Self-attention block: (pre-LN), the packed QKV product,
    attention, the output product, dropout, the residual, (post-LN)."""
    if cache_kv is not None:
        raise NotImplementedError(
            "cache_kv (incremental decode) is not supported by the fused "
            "attention here — use the model-level kv-cache path")
    x = to_tensor_arg(x)
    B, S, E = x.shape
    w = to_tensor_arg(qkv_weight)
    if w.dim() == 4:        # [3, H, D, E] reference layout -> [E, 3HD]
        _, nh, hd, e2 = w.shape
        w = w.reshape(3 * nh * hd, e2).t()
    else:
        nh = num_heads
        if nh is None:
            raise ValueError("num_heads required with 2-D qkv_weight")
    h = _ln(x, pre_layer_norm, pre_ln_scale, pre_ln_bias, pre_ln_epsilon)
    qkv = matmul(h, w)
    if qkv_bias is not None:
        qkv = qkv + to_tensor_arg(qkv_bias).reshape(-1)
    q, k, v = qkv.reshape(B, S, 3, nh, E // nh).unbind(2)
    att = F.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask, dropout_p=attn_dropout_rate,
        is_causal=False, training=training)
    out = matmul(att.reshape(B, S, E), to_tensor_arg(linear_weight))
    if linear_bias is not None:
        out = out + to_tensor_arg(linear_bias)
    if dropout_rate > 0.0 and training:
        out = F.dropout(out, p=dropout_rate, training=training, mode=mode)
    if add_residual:
        out = x + out
    return _ln(out, not pre_layer_norm, ln_scale, ln_bias, ln_epsilon)


def fused_feedforward(
        x, linear1_weight, linear2_weight, linear1_bias=None,
        linear2_bias=None, ln1_scale=None, ln1_bias=None, ln2_scale=None,
        ln2_bias=None, dropout1_rate=0.5, dropout2_rate=0.5,
        activation="relu", ln1_epsilon=1e-5, ln2_epsilon=1e-5,
        pre_layer_norm=False, training=True, mode="upscale_in_train",
        ring_id=-1, add_residual=True, name=None):
    """(pre-LN), linear1, activation, dropout1, linear2, dropout2, the
    residual, (post-LN)."""
    x = to_tensor_arg(x)
    h = _ln(x, pre_layer_norm, ln1_scale, ln1_bias, ln1_epsilon)
    h = getattr(F, activation)(F.linear(h, to_tensor_arg(linear1_weight),
                                        linear1_bias))
    if dropout1_rate > 0.0 and training:
        h = F.dropout(h, p=dropout1_rate, training=training, mode=mode)
    h = F.linear(h, to_tensor_arg(linear2_weight), linear2_bias)
    if dropout2_rate > 0.0 and training:
        h = F.dropout(h, p=dropout2_rate, training=training, mode=mode)
    out = x + h if add_residual else h
    return _ln(out, not pre_layer_norm, ln2_scale, ln2_bias, ln2_epsilon)


def _check_stack(pre_layer_norm, attn_mask, activation, dropout_rate):
    """The JAX package's refusals for the fused stack."""
    if not pre_layer_norm:
        raise NotImplementedError("post-LN stack variant")
    if attn_mask is not None:
        raise NotImplementedError(
            "fused_multi_transformer: the fused stack is causal-only; an "
            "explicit attn_mask needs the per-layer fused_attention path")
    if activation != "gelu":
        raise NotImplementedError(
            f"fused_multi_transformer: activation={activation!r} (the "
            "fused stack hard-codes gelu, the CUDA op's serving config)")
    if dropout_rate not in (0, 0.0):
        raise NotImplementedError(
            "fused_multi_transformer: dropout_rate != 0 (inference form "
            "only; train with the GPT model / fused_block_stack)")


def fused_multi_transformer(
        x, ln_scales, ln_biases, qkv_weights, qkv_biases, linear_weights,
        linear_biases, ffn_ln_scales, ffn_ln_biases, ffn1_weights,
        ffn1_biases, ffn2_weights, ffn2_biases, pre_layer_norm=True,
        epsilon=1e-5, cache_kvs=None, time_step=None, attn_mask=None,
        dropout_rate=0.0, activation="gelu", training=False,
        mode="upscale_in_train", trans_qkvw=True, ring_id=-1, name=None):
    """The whole pre-LN decoder stack (causal); per-layer parameter
    lists, the QKV weights ``[3, heads, head_dim, H]``."""
    if cache_kvs is not None or time_step is not None:
        raise NotImplementedError(
            "kv-cache decode: use the GPT model's cached generate path")
    _check_stack(pre_layer_norm, attn_mask, activation, dropout_rate)
    if not trans_qkvw:
        raise NotImplementedError(
            "fused_multi_transformer: trans_qkvw=False qkv layout")
    x = to_tensor_arg(x)

    def qkv_flat(w):        # [3, nh, hd, H] -> [H, 3 nh hd]
        w = to_tensor_arg(w)
        return w.permute(3, 0, 1, 2).reshape(w.shape[3], -1) \
            if w.dim() == 4 else w

    if qkv_weights[0].dim() != 4:
        raise ValueError("pass 4-D qkv weights [3, nh, hd, H] (the "
                         "reference layout) so num_heads is known")

    def stack(ts, fn=to_tensor_arg):
        return torch.stack([fn(t) for t in ts])

    groups = [stack(ln_scales), stack(ln_biases),
              stack(qkv_weights, qkv_flat),
              stack(qkv_biases, lambda b: to_tensor_arg(b).reshape(-1)),
              stack(linear_weights), stack(linear_biases),
              stack(ffn_ln_scales), stack(ffn_ln_biases),
              stack(ffn1_weights), stack(ffn1_biases),
              stack(ffn2_weights), stack(ffn2_biases)]
    return fused_block_stack(x, *groups, num_heads=qkv_weights[0].shape[1],
                             causal=True, epsilon=epsilon)
