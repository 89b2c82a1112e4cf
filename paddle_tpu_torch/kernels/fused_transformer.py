"""The pre-LN GPT block stack as one function over per-layer params.

Counterpart of ``paddle_tpu/kernels/fused_transformer.py``. There the
stack is a ``lax.scan`` (or a static unroll) so XLA compiles one block;
PyTorch runs eagerly, so here both entries are a plain loop over the
layers. The numerics are the unfused ``GPTBlock``'s: float32 LayerNorm
cast back to the input dtype, tanh GELU and the ``sdpa_array``
attention dispatcher.
"""
from __future__ import annotations

from torch.utils.checkpoint import checkpoint

from ..nn.functional import gelu, layer_norm, linear
from .attention import sdpa_array

__all__ = ["fused_block_stack", "fused_block_stack_flat"]

_N_PARAMS = 12       # params of one block, in the order _block_body reads


def _ln(x, g, b, eps):
    """float32 mean and population variance, ``rsqrt(var + eps)``, scale
    and shift in float32, cast back to x's dtype."""
    return layer_norm(x, x.shape[-1], g, b, eps)


def _block_body(num_heads: int, causal: bool, epsilon: float, remat,
                attn_tier: str = "auto"):
    """One pre-LN GPT block ``body(h, params) -> h``. ``remat``: False
    (save everything) or True (recompute the block in the backward,
    ``torch.utils.checkpoint``). The JAX package's selective policies
    (``"dots"``, ``"names:..."``, ``"dots+names:..."``) are not ported."""
    if isinstance(remat, str):
        raise NotImplementedError(
            f"remat policy {remat!r}: only False and True are ported; the "
            "selective policies are queued")

    def body(h, p):
        B, S, H = h.shape
        D = H // num_heads
        (l1g, l1b, qw, qb, ow, ob, l2g, l2b, f1w, f1b, f2w, f2b) = p
        a_in = _ln(h, l1g, l1b, epsilon)
        qkv = linear(a_in, qw, qb).reshape(B, S, 3, num_heads, D)
        att = sdpa_array(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                         is_causal=causal, tier=attn_tier)
        h = h + linear(att.reshape(B, S, H), ow, ob)
        m_in = _ln(h, l2g, l2b, epsilon)
        m = gelu(linear(m_in, f1w, f1b), approximate=True)
        return h + linear(m, f2w, f2b)

    if not remat:
        return body
    return lambda h, p: checkpoint(lambda x, *q: body(x, q), h, *p,
                                   use_reentrant=False)


def fused_block_stack_flat(x, *params, num_layers: int, num_heads: int,
                           causal: bool = True, epsilon: float = 1e-5,
                           remat=False, attn_tier: str = "auto"):
    """``num_layers`` pre-LN blocks over ``x [B, S, H]``; ``params`` is
    ``num_layers`` consecutive groups of the 12 block params (ln1 g/b,
    qkv w/b, out w/b, ln2 g/b, fc1 w/b, fc2 w/b), layer-major."""
    if len(params) != _N_PARAMS * num_layers:
        raise ValueError(f"expected {_N_PARAMS * num_layers} params, got "
                         f"{len(params)}")
    body = _block_body(num_heads, causal, epsilon, remat, attn_tier)
    for i in range(num_layers):
        x = body(x, params[_N_PARAMS * i:_N_PARAMS * (i + 1)])
    return x


def fused_block_stack(x, ln1_g, ln1_b, qkv_w, qkv_b, out_w, out_b,
                      ln2_g, ln2_b, fc1_w, fc1_b, fc2_w, fc2_b, *,
                      num_heads: int, causal: bool = True,
                      epsilon: float = 1e-5, remat=False,
                      attn_tier: str = "auto"):
    """The same stack over params stacked on a leading layer axis (e.g.
    ``qkv_w [L, H, 3H]``)."""
    stacked = (ln1_g, ln1_b, qkv_w, qkv_b, out_w, out_b,
               ln2_g, ln2_b, fc1_w, fc1_b, fc2_w, fc2_b)
    body = _block_body(num_heads, causal, epsilon, remat, attn_tier)
    for i in range(ln1_g.shape[0]):
        x = body(x, tuple(p[i] for p in stacked))
    return x
