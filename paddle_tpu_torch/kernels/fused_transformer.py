"""The pre-LN GPT block stack as one function over per-layer params.

Counterpart of ``paddle_tpu/kernels/fused_transformer.py``. There the
stack is a ``lax.scan`` (or a static unroll) so XLA compiles one block;
PyTorch runs eagerly, so here both entries are a plain loop over the
layers. The numerics are the unfused ``GPTBlock``'s: float32 LayerNorm
cast back to the input dtype, tanh GELU and the ``sdpa_array``
attention dispatcher.

Rematerialization (``remat``), the JAX package's policies on
``torch.utils.checkpoint``:

- ``False``: save everything; ``True`` (or any other truthy value but
  the strings below): recompute the whole block in the backward;
- ``"dots"``: save the outputs of the non-batched matrix products (the
  block's linears: ``aten.mm`` / ``aten.addmm``), recompute the rest
  (LayerNorm, GELU, the attention);
- ``"names:a,b"``: save only the named intermediates, recompute the rest
  from the block's input. Names: ``qkv`` (the packed QKV linear),
  ``attn`` (the attention's output), ``proj`` (the output linear),
  ``mlp1`` (the GELU output), ``mlp2`` (the second MLP linear);
- ``"dots+names:..."``: both.

The selective forms are selective activation checkpointing: a policy
that marks every op of a saved kind or inside a saved name's region
``MUST_SAVE`` and the rest ``PREFER_RECOMPUTE``. A named region holds
its op(s) alone, except ``attn``, which holds the whole attention call
(the flash route's kernels recompute into their saved buffers; the
plain route saves its score tensors too). Every form replays in its
recompute the dropout keys its forward drew (:func:`checkpoint_keys`).
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils.checkpoint import checkpoint

from ..core import random as _rng
from ..nn.functional import gelu, layer_norm, linear
from .attention import sdpa_array

__all__ = ["fused_block_stack", "fused_block_stack_flat", "checkpoint_keys",
           "REMAT_NAMES"]

REMAT_NAMES = ("qkv", "attn", "proj", "mlp1", "mlp2")
_state = threading.local()


@contextlib.contextmanager
def _named(name: str):
    """Ops inside belong to the named intermediate ``name``."""
    prev = getattr(_state, "name", None)
    _state.name = name
    try:
        yield
    finally:
        _state.name = prev


def checkpoint_keys(fn, *args, context_fn=None):
    """``torch.utils.checkpoint`` (non-reentrant) of ``fn(*args)`` whose
    recompute draws the random keys the forward drew, in order, and
    moves no generator (a ``jax.checkpoint`` replays its traced keys)."""
    keys: list = []
    calls = [0]

    def run(*a):
        calls[0] += 1
        scope = _rng.record_keys(keys) if calls[0] == 1 \
            else _rng.replay_keys(keys)
        with scope:
            return fn(*a)

    extra = {} if context_fn is None else {"context_fn": context_fn}
    return checkpoint(run, *args, use_reentrant=False, **extra)


def _parse_remat(remat):
    """``(dots, names)`` of a selective policy, or None for full or no
    remat."""
    if remat == "dots":
        return True, ()
    if isinstance(remat, str) and remat.startswith("dots+names:"):
        return True, tuple(n.strip() for n in remat[11:].split(",")
                           if n.strip())
    if isinstance(remat, str) and remat.startswith("names:"):
        return False, tuple(n.strip() for n in remat[6:].split(",")
                            if n.strip())
    return None


def _selective_context(dots: bool, names):
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    unknown = set(names) - set(REMAT_NAMES)
    if unknown:
        raise ValueError(f"remat names {sorted(unknown)} not in "
                         f"{REMAT_NAMES}")
    matmuls = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}
    saved = frozenset(names)

    def policy(ctx, op, *args, **kwargs):
        if getattr(_state, "name", None) in saved or (dots and op in matmuls):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return lambda: create_selective_checkpoint_contexts(policy)

_N_PARAMS = 12       # params of one block, in the order _block_body reads


def _ln(x, g, b, eps):
    """float32 mean and population variance, ``rsqrt(var + eps)``, scale
    and shift in float32, cast back to x's dtype."""
    return layer_norm(x, x.shape[-1], g, b, eps)


def _block_body(num_heads: int, causal: bool, epsilon: float, remat,
                attn_tier: str = "auto"):
    """One pre-LN GPT block ``body(h, params) -> h`` under the ``remat``
    policy (see the module docstring)."""

    def body(h, p):
        B, S, H = h.shape
        D = H // num_heads
        (l1g, l1b, qw, qb, ow, ob, l2g, l2b, f1w, f1b, f2w, f2b) = p
        a_in = _ln(h, l1g, l1b, epsilon)
        with _named("qkv"):
            qkv = linear(a_in, qw, qb)
        qkv = qkv.reshape(B, S, 3, num_heads, D)
        with _named("attn"):
            att = sdpa_array(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                             is_causal=causal, tier=attn_tier)
        with _named("proj"):
            proj = linear(att.reshape(B, S, H), ow, ob)
        h = h + proj
        m_in = _ln(h, l2g, l2b, epsilon)
        f1 = linear(m_in, f1w, f1b)
        with _named("mlp1"):
            m = gelu(f1, approximate=True)
        with _named("mlp2"):
            out = linear(m, f2w, f2b)
        return h + out

    if not remat:
        return body
    selective = _parse_remat(remat)
    context_fn = None if selective is None else _selective_context(*selective)
    return lambda h, p: checkpoint_keys(lambda x, *q: body(x, q), h, *p,
                                        context_fn=context_fn)


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
