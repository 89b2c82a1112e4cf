"""The port's decode and mixed paged attention against the JAX package.

The same seeded numpy inputs go through the JAX function and the
port's plain version:

- ``paged_attention_ref`` against ``paged_attention_lax`` and the Pallas
  ``paged_attention_pallas`` in interpret mode, rtol = atol = 2e-5 (the
  JAX package's own tolerance for its Pallas tier); a slot at
  ``seq_len == 0`` outputs exact zeros;
- ``mixed_attention_ref`` against ``mixed_attention_lax`` on every row,
  padding rows included (they attend the whole context), and against
  the Pallas interpret run, at 2e-5;
- the mixed shape at T = 1 is decode;
- the dispatchers on the CPU: ``auto`` takes the plain version and
  launches nothing, ``kernel`` refuses CPU tensors;
- ``mixed_plan``, the mixed kernel's schedule decided on the host:
  its tile rows and whether (and how) it splits the key walk.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.kernels.paged_attention import (  # noqa: E402
    mixed_attention_lax, mixed_attention_pallas, paged_attention_lax,
    paged_attention_pallas)
from paddle_tpu_torch.kernels import paged_attention as pa  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TOL = 2e-5
H, D, PAGE, PPS = 2, 16, 8, 4


def _inputs(seed, B, T):
    """Pools with distinct real pages per slot (page 0 stays the garbage
    page), a query block, and per-slot lengths: one slot at seq_len 0,
    one full, the rest random; q_lens from 0 to T."""
    rng = np.random.default_rng(seed)
    n_pages = B * PPS + 1
    k = rng.normal(size=(n_pages, PAGE, H, D)).astype(np.float32)
    v = rng.normal(size=(n_pages, PAGE, H, D)).astype(np.float32)
    pt = (rng.permutation(n_pages - 1) + 1)[:B * PPS].reshape(B, PPS)
    seq = rng.integers(1, PPS * PAGE + 1, size=B)
    seq[0], seq[-1] = 0, PPS * PAGE
    q_lens = np.minimum(rng.integers(0, T + 1, size=B), seq)
    q_lens[-1] = T
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    return (q, k, v, pt.astype(np.int32), seq.astype(np.int32),
            q_lens.astype(np.int32))


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("seed", range(3))
def test_paged_ref_matches_lax_and_pallas(seed):
    q, k, v, pt, seq, _ = _inputs(seed, B=5, T=1)
    q = q[:, 0]
    got = pa.paged_attention_ref(*_torch(q, k, v, pt, seq)).numpy()
    lax = np.asarray(paged_attention_lax(*_jax(q, k, v, pt, seq)))
    pallas = np.asarray(paged_attention_pallas(*_jax(q, k, v, pt, seq),
                                               interpret=True))
    np.testing.assert_allclose(got, lax, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)
    assert (got[0] == 0).all()                 # seq_len 0: exact zeros
    assert np.abs(got[1:]).max() > 0


@pytest.mark.parametrize("seed,T", [(0, 5), (1, 3), (2, 8)])
def test_mixed_ref_matches_lax_on_every_row(seed, T):
    q, k, v, pt, seq, ql = _inputs(seed, B=4, T=T)
    got = pa.mixed_attention_ref(*_torch(q, k, v, pt, seq, ql)).numpy()
    lax = np.asarray(mixed_attention_lax(*_jax(q, k, v, pt, seq, ql)))
    np.testing.assert_allclose(got, lax, rtol=TOL, atol=TOL)
    assert (got[0] == 0).all()
    # padding rows of a live slot attend the whole context: not zeros
    b = next(b for b in range(1, 4) if ql[b] < T and seq[b] > 0)
    assert np.abs(got[b, ql[b]:]).max() > 0


@pytest.mark.parametrize("seed,T", [(3, 5), (4, 2)])
def test_mixed_ref_matches_pallas_interpret(seed, T):
    q, k, v, pt, seq, ql = _inputs(seed, B=4, T=T)
    got = pa.mixed_attention_ref(*_torch(q, k, v, pt, seq, ql)).numpy()
    pallas = np.asarray(mixed_attention_pallas(
        *_jax(q, k, v, pt, seq, ql), interpret=True))
    for b in range(q.shape[0]):
        np.testing.assert_allclose(got[b, :ql[b]], pallas[b, :ql[b]],
                                   rtol=TOL, atol=TOL)
    # the Pallas kernel agrees on padding rows too
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)


def test_mixed_at_one_row_is_decode():
    q, k, v, pt, seq, _ = _inputs(5, B=5, T=1)
    ones = np.ones_like(seq)
    mixed = pa.mixed_attention_ref(*_torch(q, k, v, pt, seq, ones))
    decode = pa.paged_attention_ref(*_torch(q[:, 0], k, v, pt, seq))
    assert torch.equal(mixed[:, 0], decode)
    lax = np.asarray(paged_attention_lax(*_jax(q[:, 0], k, v, pt, seq)))
    np.testing.assert_allclose(mixed[:, 0].numpy(), lax, rtol=TOL, atol=TOL)


def test_verify_delegates_to_mixed():
    args = _torch(*_inputs(6, B=3, T=4))
    assert torch.equal(pa.verify_attention(*args),
                       pa.mixed_attention(*args, tier="ref"))


def test_dispatchers_on_cpu():
    q, k, v, pt, seq, ql = _torch(*_inputs(7, B=3, T=4))
    before = dict(pa.LAUNCHES)
    assert torch.equal(pa.mixed_attention(q, k, v, pt, seq, ql),
                       pa.mixed_attention_ref(q, k, v, pt, seq, ql))
    dq = q[:, 0].contiguous()
    assert torch.equal(pa.paged_attention(dq, k, v, pt, seq),
                       pa.paged_attention_ref(dq, k, v, pt, seq))
    assert dict(pa.LAUNCHES) == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        pa.mixed_attention(q, k, v, pt, seq, ql, tier="kernel")
    with pytest.raises(ValueError, match="CUDA tensors"):
        pa.verify_attention(q, k, v, pt, seq, ql, tier="kernel")
    with pytest.raises(ValueError, match="CUDA tensors"):
        pa.paged_attention(dq, k, v, pt, seq, tier="kernel")
    with pytest.raises(ValueError, match="tier="):
        pa.paged_attention(dq, k, v, pt, seq, tier="pallas")


@pytest.mark.parametrize("args,want", [
    ((1, 512, 12, 16, 64, 132), (64, 6, 3)),     # the chunk: 96 tiles
    ((8, 5, 12, 16, 64, 132), (8, 6, 3)),        # verify: 96 (slot, head)
    ((8, 5, 12, 32, 32, 132), (8, 6, 3)),        # 2 pages a key block
    ((16, 64, 12, 16, 64, 132), (64, 0, 1)),     # 192 tiles fill the card
    ((1, 512, 12, 16, 4, 132), (64, 0, 1)),      # one key block: no split
    ((2, 8, 1, 8, 32, 132), (8, 1, 4))])         # 8-page key blocks
def test_mixed_plan_splits_only_a_grid_that_leaves_sms_idle(args, want):
    """The mixed kernel's schedule, decided on the host: 8-row tiles up
    to T = 8, 64-row tiles above; a grid of fewer tiles than SMs splits
    each row's key blocks into chunks (about two blocks per SM)."""
    assert pa.mixed_plan(*args) == want


def test_mixed_plan_forced_split():
    assert pa.mixed_plan(8, 5, 12, 16, 64, 132, split_blocks=0) == (8, 0, 1)
    assert pa.mixed_plan(8, 5, 12, 16, 64, 132, split_blocks=5) == (8, 5, 4)
    assert pa.mixed_plan(8, 5, 12, 16, 64, 132, split_blocks=16) == (8, 0, 1)
