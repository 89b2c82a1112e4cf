"""The port's ragged paged attention against the JAX reference.

``paddle_tpu_torch.kernels.paged_attention.ragged_attention_ref`` (the
plain PyTorch version the CPU runs and the CUDA kernel is held against
on the card) is compared directly with ``ragged_attention_lax`` and
with the Pallas tier in interpret mode, on ragged mixes of chunk,
decode, verify-shaped, idle and padding rows, at the JAX package's own
tolerance for its Pallas tier (rtol = atol = 2e-5, float32).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.kernels.paged_attention import (  # noqa: E402
    ragged_attention_lax, ragged_attention_pallas, ragged_rows as jax_rows)
from paddle_tpu_torch.kernels import paged_attention as pa  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

H, D, PAGE = 2, 16, 8
TOL = 2e-5


def _mix(seed, kinds, pages_per_seq=4, n_pool_pages=32, chunk=8, drafts=3,
         pad=5):
    """A ragged mix: per slot a (q_len, kv_len) drawn from its kind —
    'decode' (1), 'chunk' (chunk), 'verify' (1 + drafts), 'idle' (0) —
    distinct real pages per slot (page 0 stays the garbage page), and
    ``pad`` flat padding tokens after the last row."""
    rng = np.random.default_rng(seed)
    q_lens, kv_lens = [], []
    for kind in kinds:
        ql = {"decode": 1, "chunk": chunk, "verify": 1 + drafts,
              "idle": 0}[kind]
        kv = 0 if ql == 0 else int(rng.integers(ql, pages_per_seq * PAGE))
        q_lens.append(ql)
        kv_lens.append(max(kv, ql))
    free = list(range(1, n_pool_pages))
    rng.shuffle(free)
    pt = np.array([[free.pop() for _ in range(pages_per_seq)]
                   for _ in kinds], np.int32)
    q_starts = np.cumsum([0] + q_lens[:-1]).astype(np.int32)
    n = int(sum(q_lens)) + pad
    k = rng.normal(size=(n_pool_pages, PAGE, H, D)).astype(np.float32)
    v = rng.normal(size=(n_pool_pages, PAGE, H, D)).astype(np.float32)
    q = rng.normal(size=(n, H, D)).astype(np.float32)
    return (q, k, v, pt, np.asarray(kv_lens, np.int32), q_starts,
            np.asarray(q_lens, np.int32))


MIXES = [
    ["decode", "chunk", "verify", "decode", "idle", "verify"],
    ["chunk", "decode", "verify", "idle", "decode"],
    ["idle", "chunk", "chunk", "decode"],
    ["decode", "decode", "decode", "decode"],
    ["verify", "idle", "idle", "chunk"],
]


def _torch(args):
    return [torch.from_numpy(a) for a in args]


def _jax(args):
    return [jnp.asarray(a) for a in args]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kinds", MIXES, ids=lambda k: "-".join(k))
def test_ref_matches_lax(seed, kinds):
    args = _mix(seed, kinds)
    want = np.asarray(ragged_attention_lax(*_jax(args)))
    got = pa.ragged_attention_ref(*_torch(args)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("seed", range(2))
def test_ref_matches_pallas_interpret(seed):
    args = _mix(seed, MIXES[1])
    want = np.asarray(ragged_attention_pallas(*_jax(args), interpret=True))
    got = pa.ragged_attention_ref(*_torch(args)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("sm_scale", [None, 0.5])
def test_ref_matches_lax_with_scale(sm_scale):
    args = _mix(7, MIXES[0])
    want = np.asarray(ragged_attention_lax(*_jax(args), sm_scale=sm_scale))
    got = pa.ragged_attention_ref(*_torch(args), sm_scale=sm_scale).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_padding_and_idle_rows_output_exact_zero():
    q, k, v, pt, kv, qs, ql = _mix(3, MIXES[0], pad=7)
    out = pa.ragged_attention(*_torch((q, k, v, pt, kv, qs, ql))).numpy()
    n_used = int(ql.sum())
    assert out.shape == q.shape
    assert (out[n_used:] == 0.0).all()
    assert np.abs(out[:n_used]).max() > 0.0


@pytest.mark.parametrize("seed", range(3))
def test_ragged_rows_match(seed):
    _, _, _, _, kv, qs, ql = _mix(seed, MIXES[seed])
    width = int(ql.sum()) + 5
    want = jax_rows(jnp.asarray(qs), jnp.asarray(ql), jnp.asarray(kv), width)
    got = pa.ragged_rows(torch.from_numpy(qs), torch.from_numpy(ql),
                         torch.from_numpy(kv), width)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_auto_tier_takes_the_plain_version_on_cpu():
    args = _torch(_mix(4, MIXES[2]))
    auto = pa.ragged_attention(*args)
    ref = pa.ragged_attention(*args, tier="ref")
    assert torch.equal(auto, ref)
    assert pa.LAUNCHES["ragged_attention"] == 0


def test_kernel_tier_refuses_cpu_tensors():
    args = _torch(_mix(5, MIXES[2]))
    with pytest.raises(ValueError, match="CUDA tensors"):
        pa.ragged_attention(*args, tier="kernel")
    with pytest.raises(ValueError, match="tier="):
        pa.ragged_attention(*args, tier="pallas")
