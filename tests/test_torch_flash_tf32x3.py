"""The float32 flash kernels' arithmetic, 3xTF32, emulated on the CPU.

The card's float32 forward and dK/dV and dQ kernels
(``csrc/flash_fwd_f32.cu``, ``csrc/flash_bwd_f32.cu``, both on
``csrc/flash_f32_tiles.cuh`` and ``csrc/tf32x3.cuh``) run every product
on the TF32 tensor cores: each
float32 operand x is split into ``big``, x rounded to tf32's 10-bit
mantissa (to nearest, ties away from zero), and ``small = x - big``,
which the tensor core reads truncated to tf32; each ``mma.sync.m16n8k8``
k-step of 8 adds ``a_small b_big``, then ``a_big b_small``, then ``a_big
b_big`` to the tile's float32 sum, which is added to the output's sum
once per walked tile.
The kernels cannot run here; this module runs the same arithmetic in
PyTorch, step by step:

- the fragment layouts of ``m16n8k8`` (tf32) as tables, the kernels'
  A-from-accumulator register order ``{c0, c2, c1, c3}`` (P and dS stay
  in registers) and the rows their B fragments read in the same step
  (``2t``, ``2t + 1``): the key (query) order of both sides is derived
  from the tables and must agree, or the gradients are wrong;
- the whole backward (S, P, dP, dS, dV, dK, dQ) with every product split
  and summed in that order, held within 1e-4 (the card's tolerance for
  the gradients) of a float64 version of the plain arithmetic
  (``chip_smoke.flash_bwd_f64``) and of the plain float32 versions;
- one TF32 product instead of three is at least 100 times further from
  float64, which is why the kernels pay for three;
- the whole forward: S = Q K^T in 3xTF32, the online softmax in the log2
  domain over walked key tiles of 32 (x = s * (scale log2(e)) rounded to
  float32, p = 2^(x - m), each thread's share of the row sum over its
  columns 2t and 2t + 1, ``alpha`` = 2^(m_old - m_new)), each tile's P V
  summed from zero with P in ``c_to_a``'s register order against
  ``load_b_perm``'s V rows, and O = O alpha + tile in float32; held
  within 2e-5 of float64 and of the JAX package's float32 flash forward
  (its Pallas kernel in interpret mode), with rows that see no key at o
  = 0 and lse = NEG_INF, and wrong where the key orders disagree.

Inputs come from numpy with a seed; lse and delta are the plain float32
forward's, given to every side alike.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import chip_smoke as cs  # noqa: E402
from paddle_tpu.kernels import flash_attention as jfa  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as fa  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
GRAD_TOL = 1e-4
FWD_TOL = 2e-5
# the walked tiles at head_dim 64: 32 queries (dK/dV), 32 keys (dQ and
# the forward, which walks 32-key tiles at head_dim 128 too)
WALK_TILE = 32

# m16n8k8 tf32 fragments: for lane l, g = l // 4 and t = l % 4
_LANE = torch.arange(32)
G, T = _LANE // 4, _LANE % 4
A_ROW, A_COL = (G, G + 8, G, G + 8), (T, T, T + 4, T + 4)
B_K = (T, T + 4)
C_ROW, C_COL = (G, G, G + 8, G + 8), (2 * T, 2 * T + 1, 2 * T, 2 * T + 1)
# flash_bwd_f32.cu c_to_a: A register r holds accumulator register
# A_FROM_C[r]; load_b_perm: B register i reads row B_ROW_READ[i] of the
# step's 8 rows
A_FROM_C = (0, 2, 1, 3)
B_ROW_READ = (2 * T, 2 * T + 1)


def _order(pairs):
    """k -> the score column (or tile row) that the fragment puts at
    reduction index k, from (k per lane, source per lane) pairs; each k
    must come from one source."""
    order = [None] * 8
    for ks, src in pairs:
        for k, v in zip(ks.tolist(), src.tolist()):
            assert order[k] in (None, v), f"k {k}: {order[k]} and {v}"
            order[k] = v
    return order


def a_order(a_from_c=A_FROM_C):
    """The score column at each A column of a step's fragment built from
    the accumulators of one score n-tile; the accumulator rows must be
    the A rows."""
    for r, c in enumerate(a_from_c):
        assert torch.equal(A_ROW[r], C_ROW[c])
    return _order([(A_COL[r], C_COL[c]) for r, c in enumerate(a_from_c)])


def b_order(rows=B_ROW_READ):
    """The tile row at each B row (reduction index) of a step."""
    return _order(list(zip(B_K, rows)))


def tf32(x):
    """float32 rounded to tf32 (10-bit mantissa), to nearest with ties
    away from zero, through the int32 view (``cvt.rna.tf32.f32``'s
    rounding, the 13 low bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def truncate(x):
    """What the tensor core reads of a float32 operand: the 13 low bits
    dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x):
    """The kernels' ``tf32x3::split`` as the tensor core sees it."""
    big = tf32(x)
    return big, truncate(x - big)


def mma(a, b, terms=3, a_cols=None, b_rows=None, tile=None):
    """``a @ b`` (float32, ``[..., M, K] @ [..., K, N]``) as the kernels
    sum it: k-steps of 8 in order, each adding the step's tf32 products
    to a float32 sum (exact products, the step's sum rounded once), with
    ``terms`` 3 (a_small b_big, a_big b_small, a_big b_big) or 1 (big
    only). ``a_cols`` / ``b_rows``: the step's 8 reduction indices as the
    A and B fragments place them. ``tile``: the reduction is cut into
    walked tiles of that many, each summed from zero and added to the
    total in float32."""
    K = a.shape[-1]
    assert K % 8 == 0 and b.shape[-2] == K
    a_cols = list(range(8)) if a_cols is None else a_cols
    b_rows = list(range(8)) if b_rows is None else b_rows
    tile = K if tile is None else tile
    total = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for t0 in range(0, K, tile):
        acc = torch.zeros_like(total)
        for j in range(t0, min(K, t0 + tile), 8):
            ab, as_ = split(a[..., [j + c for c in a_cols]])
            bb, bs = split(b[..., [j + r for r in b_rows], :])
            pairs = (((as_, bb), (ab, bs), (ab, bb)) if terms == 3
                     else ((ab, bb),))
            for x, y in pairs:
                acc = (acc.double() + x.double() @ y.double()).float()
        total = total + acc
    return total


def _probs(s, lse, scale, causal, transposed):
    """p = 2^(s scale log2(e) - lse log2(e)) as the kernels form it (one
    fused multiply-add, then exp2), zeroed where masked; ``s`` is S^T
    (keys x queries) when ``transposed``."""
    nl = (-lse * LOG2E).float()
    if transposed:
        nl = nl.transpose(-1, -2)
    p = torch.exp2((s.double() * float(np.float32(scale * LOG2E))
                    + nl.double()).float())
    if causal:
        sq, sk = lse.shape[-2], (s.shape[-2] if transposed else s.shape[-1])
        mask = fa._causal_mask(sq, sk, s.device)
        p = p.masked_fill(~(mask.T if transposed else mask), 0.0)
    return p


def emulated_bwd(q, k, v, do, lse, delta, scale, causal, terms=3,
                 a_from_c=A_FROM_C, rows=B_ROW_READ):
    """``(dq, dk, dv)`` of the dK/dV and dQ kernels, every product as
    ``mma``; P and dS enter their second products in the fragments' key
    (query) order."""
    ao, bo = a_order(a_from_c), b_order(rows)
    tr = lambda x: x.transpose(-1, -2)  # noqa: E731
    # dK/dV: S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q
    pt = _probs(mma(k, tr(q), terms), lse, scale, causal, True)
    dst = pt * (mma(v, tr(do), terms) - tr(delta)) * scale
    dv = mma(pt, do, terms, ao, bo, WALK_TILE)
    dk = mma(dst, q, terms, ao, bo, WALK_TILE)
    # dQ: S = Q K^T, dP = dO V^T, dQ += dS K
    p = _probs(mma(q, tr(k), terms), lse, scale, causal, False)
    ds = p * (mma(do, tr(v), terms) - delta) * scale
    dq = mma(ds, k, terms, ao, bo, WALK_TILE)
    return dq, dk, dv


def _inputs(B, H, Sq, Sk, D, causal, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, S, D))
                                    .astype(np.float32))
                   for S in (Sq, Sk, Sk, Sq))
    scale = 1.0 / math.sqrt(D)
    o, lse = fa.flash_fwd_ref(q, k, v, scale, causal)
    return q, k, v, do, lse, fa.bwd_delta(o, do), scale


def _max_err(got, want):
    return max((g.double() - w).abs().max().item() for g, w in zip(got, want))


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                    # one tf32 step above 1
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0 + 2.0 ** -12, 3.0],
                     dtype=torch.float32)
    want = torch.tensor([1.0, one, -one, 1.0, 1.0, 3.0])
    assert torch.equal(tf32(x), want)
    x = torch.tensor([1.0 / 3.0, -7.123456789, 1e-3])
    big, small = split(x)
    err = (big.double() + small.double() - x.double()).abs() / x.abs()
    assert (err < 2.0 ** -21).all()
    assert torch.equal(tf32(big), big)


def test_fragment_orders_agree():
    """The kernels' A fragment of P (dS) and the rows their B fragment
    reads put the same key (query) at every reduction index: (0, 2, 4,
    6, 1, 3, 5, 7). The accumulators in their own order are no A
    fragment: their rows (g, g, g + 8, g + 8) are not A's."""
    assert a_order() == b_order() == [0, 2, 4, 6, 1, 3, 5, 7]
    with pytest.raises(AssertionError):
        a_order((0, 1, 2, 3))


# (B, H, Sq, Sk, D, causal): causal and full, Sq < Sk, head_dim 128
SHAPES = [(1, 2, 96, 96, 64, True), (1, 2, 96, 96, 64, False),
          (1, 2, 64, 128, 64, True), (1, 2, 96, 96, 128, True)]


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal", SHAPES)
def test_emulated_kernels_match_float64(B, H, Sq, Sk, D, causal):
    q, k, v, do, lse, delta, scale = _inputs(B, H, Sq, Sk, D, causal,
                                             seed=Sq + Sk + D + causal)
    got = emulated_bwd(q, k, v, do, lse, delta, scale, causal)
    want = cs.flash_bwd_f64(q, k, v, do, lse, delta, scale, causal)
    plain = (fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, scale, causal),
             *fa.flash_bwd_dkdv_ref(q, k, v, do, lse, delta, scale, causal))
    for name, g, w, r in zip(("dq", "dk", "dv"), got, want, plain):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        torch.testing.assert_close(g.double(), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL, msg=name)
        torch.testing.assert_close(g, r, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   msg=name)
    # float64 agrees with the plain float32 versions as closely
    assert _max_err(plain, want) < GRAD_TOL


def test_one_tf32_product_is_a_hundred_times_worse():
    """Against float64, one TF32 product per step errs at least 100
    times more than three: the kernels need the 3xTF32 split to keep
    the gradients within 1e-4."""
    q, k, v, do, lse, delta, scale = _inputs(1, 2, 96, 96, 64, True, seed=7)
    want = cs.flash_bwd_f64(q, k, v, do, lse, delta, scale, True)
    err3 = _max_err(emulated_bwd(q, k, v, do, lse, delta, scale, True), want)
    err1 = _max_err(emulated_bwd(q, k, v, do, lse, delta, scale, True,
                                 terms=1), want)
    assert err3 < GRAD_TOL
    assert err1 >= 100 * err3, (err1, err3)


def test_mismatched_fragment_order_gives_wrong_gradients():
    """If the B fragments read the step's rows in their natural order
    (t, t + 4) while P and dS keep the {c0, c2, c1, c3} register order,
    dV, dK and dQ pair wrong keys with wrong queries: far outside 1e-4."""
    q, k, v, do, lse, delta, scale = _inputs(1, 2, 64, 64, 64, False,
                                             seed=3)
    want = cs.flash_bwd_f64(q, k, v, do, lse, delta, scale, False)
    got = emulated_bwd(q, k, v, do, lse, delta, scale, False,
                       rows=B_K)
    assert _max_err(got, want) > 100 * GRAD_TOL


def emulated_fwd(q, k, v, scale, causal, a_from_c=A_FROM_C,
                 rows=B_ROW_READ):
    """``(o, lse)`` of the forward kernel, ``lse`` ``[B, H, Sq, 1]``:
    S = Q K^T as ``mma``; per walked tile of WALK_TILE keys (keys past Sk
    read as 0 and are masked) the log2-domain online softmax, each
    thread's share of the row sum kept apart (thread t of a row holds the
    tile's columns 8 n + 2t and 8 n + 2t + 1, summed in that order) and
    reduced once at the end as the two shuffles do; P V summed from zero
    over the tile with P entering in the fragments' key order; O = O
    alpha + tile in float32."""
    f32 = lambda x: np.float32(x)  # noqa: E731
    ao, bo = a_order(a_from_c), b_order(rows)
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    n_keys = -(-Sk // WALK_TILE) * WALK_TILE
    pad = (0, 0, 0, n_keys - Sk)
    kp, vp = (torch.nn.functional.pad(t, pad) for t in (k, v))
    s = mma(q, kp.transpose(-1, -2))
    x = s * float(f32(f32(scale) * f32(LOG2E)))
    i = torch.arange(Sq)[:, None]
    j = torch.arange(n_keys)[None, :]
    seen = (j < Sk) & ((j <= i + (Sk - Sq)) if causal else True)
    x = x.masked_fill(~seen, -math.inf)
    m = torch.full((B, H, Sq, 1), -math.inf)
    share = torch.zeros(B, H, Sq, 4)               # thread t's share of l
    o = torch.zeros(B, H, Sq, D)
    cols = torch.arange(4)
    for k0 in range(0, n_keys, WALK_TILE):
        xt = x[..., k0:k0 + WALK_TILE]
        m_new = torch.maximum(m, xt.amax(dim=-1, keepdim=True))
        m_use = torch.where(m_new == -math.inf, torch.zeros_like(m_new),
                            m_new)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(xt - m_use)
        part = torch.zeros(B, H, Sq, 4)
        for n in range(WALK_TILE // 8):
            for e in range(2):
                part = part + p[..., n * 8 + 2 * cols + e]
        share = share * alpha + part
        tile = mma(p, vp[..., k0:k0 + WALK_TILE, :], 3, ao, bo)
        o = o * alpha + tile
        m = m_new
    l = (share[..., 0:1] + share[..., 1:2]) + (share[..., 2:3]
                                               + share[..., 3:4])
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    lse = torch.where(l == 0, torch.full_like(l, float(f32(fa.NEG_INF))),
                      m * float(f32(LN2)) + torch.log(l_safe))
    return o / l_safe, lse


def _fwd_inputs(B, H, Sq, Sk, D, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, H, S, D))
                             .astype(np.float32)) for S in (Sq, Sk, Sk)]


def _check_fwd(got, want, Sq, Sk, causal):
    """``(o, lse)`` float32, finite, within FWD_TOL of ``want``; rows that
    see no key at o = 0 and lse = NEG_INF."""
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        torch.testing.assert_close(g.double(), w.double(), rtol=FWD_TOL,
                                   atol=FWD_TOL)
    if causal and Sq > Sk:
        assert got[0][:, :, :Sq - Sk].abs().max().item() == 0.0
        assert (got[1][:, :, :Sq - Sk] == np.float32(fa.NEG_INF)).all()


# (B, H, Sq, Sk, D, causal) the JAX kernel takes (lengths divisible by
# its blocks): causal Sq < Sk and Sq > Sk (the first Sq - Sk rows see no
# key), head_dim 128 full
JAX_FWD_SHAPES = [(1, 2, 64, 128, 64, True), (1, 2, 128, 64, 64, True),
                  (1, 2, 128, 128, 128, False)]


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal", JAX_FWD_SHAPES)
def test_emulated_forward_matches_float64_and_jax(B, H, Sq, Sk, D, causal):
    q, k, v = _fwd_inputs(B, H, Sq, Sk, D, seed=Sq + 2 * Sk + D)
    scale = 1.0 / math.sqrt(D)
    got = emulated_fwd(q, k, v, scale, causal)
    _check_fwd(got, cs.flash_fwd_f64(q, k, v, scale, causal), Sq, Sk,
               causal)
    jo, jlse = jfa._flash_fwd(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                              scale, causal, 128, 128)
    _check_fwd(got, (torch.from_numpy(np.array(jo)),
                     torch.from_numpy(np.array(jlse))), Sq, Sk, causal)


# lengths that are not whole tiles (32 keys, 128 or 32 rows a block)
PARTIAL_FWD_SHAPES = [(1, 2, 96, 96, 64, True), (2, 1, 63, 200, 64, True),
                      (1, 2, 200, 63, 128, True), (1, 2, 65, 65, 128, False),
                      (1, 2, 1, 33, 64, True), (1, 1, 40, 1, 64, True)]


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal", PARTIAL_FWD_SHAPES)
def test_emulated_forward_at_partial_tiles(B, H, Sq, Sk, D, causal):
    q, k, v = _fwd_inputs(B, H, Sq, Sk, D, seed=Sq * 3 + Sk + D)
    scale = 1.0 / math.sqrt(D)
    _check_fwd(emulated_fwd(q, k, v, scale, causal),
               cs.flash_fwd_f64(q, k, v, scale, causal), Sq, Sk, causal)


def test_forward_mismatched_key_order_gives_wrong_o():
    """If V's B fragment read the step's rows in their natural order (t,
    t + 4) while P keeps the {c0, c2, c1, c3} register order, o pairs
    probabilities with the wrong keys' values: far outside 2e-5."""
    q, k, v = _fwd_inputs(1, 2, 64, 64, 64, seed=5)
    want = cs.flash_fwd_f64(q, k, v, 0.125, False)[0]
    good = emulated_fwd(q, k, v, 0.125, False)[0]
    bad = emulated_fwd(q, k, v, 0.125, False, rows=B_K)[0]
    assert (good.double() - want).abs().max().item() < FWD_TOL
    assert (bad.double() - want).abs().max().item() > 100 * FWD_TOL
