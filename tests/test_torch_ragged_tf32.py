"""The ragged paged-attention kernels' arithmetic, emulated on the CPU.

The card's ragged kernels (``csrc/ragged_attention.cuh``, one library
per page type) send a row of more than one query through a tensor-core
tile and a one-query (decode) row through a float32 bandwidth walk:

- the tile: q scaled by ``sm_scale * log2(e)`` and split once into tf32
  big and small halves; key tiles of 32 or 64 positions (the kernels'
  launch lines) gathered through the page table; S = Q K^T and O += P V on ``mma.sync.m16n8k8`` (tf32),
  each walked tile's P V summed from zero and added to O in float32,
  the online softmax in the log2 domain with each thread's share of the
  row sum kept apart until the end.
  - float32 pages: 3xTF32 (``a_small b_big + a_big b_small + a_big
    b_big`` a k-step);
  - int8 / e4m3 pages: the codes are exact in tf32 and the scales
    factor out, ``s_j = kscale_j (q . code_j)`` and ``O = sum_j (p_j
    vscale_j) code_j``: two products a k-step (``a_small c + a_big c``).
    K's codes are read four a lane per 16 columns and q's columns are
    permuted to match (the kernel's ``prep_q``); the k-steps' columns
    are derived here from both fragment layouts and must agree;
- the decode walk: float32 FMAs on warps striding the pages (a warp for
  every four pages a block walks, at most eight), one online-softmax
  update a page, the warps merged in fixed order; with the KV split,
  chunks of ``split_pages`` pages merged in chunk order.

The kernels cannot run here; this module runs the same arithmetic in
PyTorch at a small size (2-3 heads, head_dim 32 and 64, 16-position
pages; rows of one query, a 40-token chunk and a prefix hit, an idle
row and padding), with inputs from numpy and a seed, and holds it within
2e-5 of JAX's ``ragged_attention_lax`` and of ``ragged_attention_pallas``
in interpret mode. It also shows why the kernels pay for their products:
every int8 code and every finite e4m3 value is exact in tf32 (and
bf16), and one tf32 product instead of two (codes) or three (float32)
is at least 100 times further from float64.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.inference.llm.quant import (  # noqa: E402
    quantize_kv as jax_quantize_kv)
from paddle_tpu.kernels.paged_attention import (  # noqa: E402
    ragged_attention_lax, ragged_attention_lax_split,
    ragged_attention_pallas)
from paddle_tpu_torch.kernels import paged_attention as pa  # noqa: E402
from test_torch_flash_tf32x3 import (  # noqa: E402
    a_order, b_order, split, tf32, truncate)
from test_torch_quant import codes_torch  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

LOG2E = 1.4426950408889634
TOL = 2e-5
PAGE = 16
BQ = 128                  # the tile's query rows (D 64)
# the tile's walked keys by (padded head dim, code pages): launch_tile_dp
TILE_KEYS = {(32, False): 32, (64, False): 64, (128, False): 32,
             (32, True): 64, (64, True): 64, (128, True): 32}
# the decode walk's warps: one for every PAGES_PER_WARP pages a block
# walks (the table's width, or a split's chunk), at most MAX_WARPS
PAGES_PER_WARP, MAX_WARPS = 4, 8
KEY_ORDER = a_order()     # P's key order in a key-step (c_to_a)
assert KEY_ORDER == b_order()

# m16n8k8 fragments, lane l: g = l // 4, t = l % 4
_LANE = np.arange(32)
G, T = _LANE // 4, _LANE % 4


def q_perm_col(c):
    """``prep_q``'s column for element c (0..15) of a 16-column block."""
    return 8 * ((c & 3) >> 1) + 4 * (c & 1) + (c >> 2)


def code_steps(dp):
    """The head-dim column at each reduction index (0..7) of every k-step
    of the code tile's S = Q K^T, from both sides: the A fragment reads
    q's permuted plane at column 8 kk + (t, t + 4) (``load_a``); the B
    fragment of lane (g, t) reads codes 16 kp + 4 t .. + 3 of a K row
    and gives code 2 s + e to k-step 2 kp + s as reduction index t + 4 e
    (``scores_codes``). Both must name the same column."""
    inverse = {}
    for d in range(dp):
        kp, c = divmod(d, 16)
        inverse[16 * kp + q_perm_col(c)] = d
    steps_a, steps_b = [], []
    for kk in range(dp // 8):
        a_side = [None] * 8
        for t in range(4):
            a_side[t] = inverse[8 * kk + t]
            a_side[t + 4] = inverse[8 * kk + t + 4]
        b_side = [None] * 8
        kp, s = divmod(kk, 2)
        for t in T[:4].tolist():
            for e in range(2):
                b_side[t + 4 * e] = 16 * kp + 4 * t + 2 * s + e
        steps_a.append(a_side)
        steps_b.append(b_side)
    return steps_a, steps_b


def v_columns(dp):
    """Head-dim column of output tile nd, column n, in the code tile's
    P V (``pv_codes``): lane (g, t) reads V codes (dp / 8) g .. + dp / 8 of
    a row, one for each output tile, so column n of tile nd is (dp / 8) n
    + nd."""
    ndt = dp // 8
    return [[ndt * n + nd for n in range(8)] for nd in range(ndt)]


def mma_steps(a, b, steps, terms):
    """``a [..., M, K] @ b [..., K, N]`` as the tensor cores sum it: one
    k-step after another (``steps``: the reduction indices of each), each
    adding its tf32 products to a float32 sum (exact products, the sum
    rounded once a product). ``terms``: the products of a step as pairs
    of (a part, b part) names: ``("small", "big")`` is a_small b_big;
    ``"exact"`` takes the operand as it is (a code)."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for idx in steps:
        ab, as_ = split(a[..., idx])
        bb, bs = split(b[..., idx, :])
        parts = {"big": (ab, bb), "small": (as_, bs),
                 "exact": (a[..., idx], b[..., idx, :])}
        for ta, tb in terms:
            x, y = parts[ta][0], parts[tb][1]
            acc = (acc.double() + x.double() @ y.double()).float()
    return acc


FLOAT_TERMS = (("small", "big"), ("big", "small"), ("big", "big"))
CODE_TERMS = (("small", "exact"), ("big", "exact"))
ONE_TERM = {"float": (("big", "big"),), "code": (("big", "exact"),)}


def _pages(pool, scale, pages):
    """``pool[pages]`` [n, page, H, D] as float32 values (codes as they
    are), with the scales [n, page, H] (None for float pools)."""
    if scale is None:
        return pool[pages], None
    codes = pool.view(torch.uint8)[pages].view(pool.dtype) \
        if pool.dtype == torch.float8_e4m3fn else pool[pages]
    return codes.to(torch.float32), scale[pages]


def _row_keys(k_pool, v_pool, k_scale, v_scale, page_table, b, n_keys):
    """Row b's first n_keys key positions: K, V [n_keys, H, D] (float32
    values or codes) and their scales [n_keys, H] (None for float)."""
    pages = page_table[b].long()
    k, ks = _pages(k_pool, k_scale, pages)
    v, vs = _pages(v_pool, v_scale, pages)
    flat = lambda x: None if x is None else x.reshape(  # noqa: E731
        (-1,) + x.shape[2:])[:n_keys]
    return flat(k), flat(v), flat(ks), flat(vs)


def emulated_tile(qr, k, v, ks, vs, pos0, cap, terms):
    """One (row, head) tile of the tensor-core kernel: ``qr [n, D]`` the
    tile's queries (already scaled to the log2 domain), key values (or
    codes) ``k, v [n_keys, D]``, scales ``ks, vs [n_keys]`` (None for
    float32 pages). Returns ``[n, D]``."""
    n, D = qr.shape
    quant = ks is not None
    dp = 32 if D <= 32 else 64 if D <= 64 else 128
    pad = lambda x, r: torch.nn.functional.pad(  # noqa: E731
        x, (0, dp - D, 0, r - x.shape[0]))
    n_keys = k.shape[0]
    BK = TILE_KEYS[(dp, quant)]
    n_tiles = -(-n_keys // BK)
    qp = pad(qr, n)
    steps = (code_steps(dp)[0] if quant
             else [list(range(8 * kk, 8 * kk + 8)) for kk in range(dp // 8)])
    lim = torch.clamp(pos0 + torch.arange(n) + 1, max=cap)[:, None]
    m = torch.full((n, 1), -math.inf)
    share = torch.zeros(n, 4)                # thread t's share of l
    o = torch.zeros(n, dp)
    cols = torch.arange(4)
    for j in range(n_tiles):
        k0 = j * BK
        kt = pad(k[k0:k0 + BK], BK)
        vt = pad(v[k0:k0 + BK], BK)
        s = mma_steps(qp, kt.T, steps, terms)
        if quant:
            s = s * torch.nn.functional.pad(ks[k0:k0 + BK],
                                            (0, BK - len(ks[k0:k0 + BK])))
        key = k0 + torch.arange(BK)[None, :]
        x = s.masked_fill(key >= lim, -math.inf)
        m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        m_use = torch.where(m_new == -math.inf, torch.zeros_like(m_new),
                            m_new)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(x - m_use)
        part = torch.zeros(n, 4)
        for nt in range(BK // 8):
            for e in range(2):
                part = part + p[:, nt * 8 + 2 * cols + e]
        share = share * alpha + part
        if quant:
            p = p * torch.nn.functional.pad(vs[k0:k0 + BK],
                                            (0, BK - len(vs[k0:k0 + BK])))
        kv_steps = [[8 * jj + r for r in KEY_ORDER] for jj in range(BK // 8)]
        tile = mma_steps(p, vt, kv_steps, terms)
        o = o * alpha + tile
        m = m_new
    l = (share[:, 0:1] + share[:, 1:2]) + (share[:, 2:3] + share[:, 3:4])
    out = torch.where(l == 0, torch.zeros_like(o), o / l)
    return out[:, :D]


def _walk_state(q, k, v, ks, vs, pages, lim):
    """One warp's walk of the decode kernel over ``pages`` (page indices
    of the row, in order): float32 throughout, one online-softmax update
    a page. Returns (m, l, acc [D])."""
    m = torch.tensor(-math.inf)
    l = torch.tensor(0.0)
    acc = torch.zeros(q.shape[-1])
    for p in pages:
        keys = torch.arange(p * PAGE, min((p + 1) * PAGE, k.shape[0]))
        s = (k[keys] @ q).float()
        if ks is not None:
            s = s * ks[keys]
        s = s.masked_fill(keys >= lim, -math.inf)
        m_new = torch.maximum(m, s.max())
        m_use = 0.0 if m_new == -math.inf else m_new
        alpha = torch.exp2(m - m_use)
        pr = torch.exp2(s - m_use)
        l = l * alpha + pr.sum()
        pv = pr if vs is None else pr * vs[keys]
        acc = acc * alpha + pv @ v[keys]
        m = m_new
    return m, l, acc


def _merge(states):
    """The warps' (or chunks') states merged in order."""
    m = torch.tensor(-math.inf)
    l = torch.tensor(0.0)
    acc = torch.zeros_like(states[0][2]) if states else None
    for mc, lc, ac in states:
        m_new = torch.maximum(m, mc)
        mu = 0.0 if m_new == -math.inf else m_new
        alpha, beta = torch.exp2(m - mu), torch.exp2(mc - mu)
        l = l * alpha + lc * beta
        acc = acc * alpha + ac * beta
        m = m_new
    return m, l, acc


def emulated_decode(q, k, v, ks, vs, lim, split_pages, pages_per_seq):
    """One (row, head) of the decode walk for a one-query row: the
    visible pages (first into chunks of ``split_pages`` with the KV split)
    split over the block's warps, merged in fixed order."""
    n_pages = -(-k.shape[0] // PAGE)
    chunks = ([list(range(c, min(c + split_pages, n_pages)))
               for c in range(0, n_pages, split_pages)]
              if split_pages else [list(range(n_pages))])
    n_warps = min(MAX_WARPS, -(-(split_pages or pages_per_seq)
                               // PAGES_PER_WARP))
    parts = []
    for chunk in chunks:
        warps = [_walk_state(q, k, v, ks, vs, chunk[w::n_warps], lim)
                 for w in range(n_warps)]
        parts.append(_merge(warps))
    if not parts:
        return torch.zeros_like(q)
    _, l, acc = _merge(parts)
    return torch.zeros_like(q) if l == 0 else acc / l


def emulated_ragged(q, k_pool, v_pool, page_table, kv_lens, q_starts,
                    q_lens, k_scale=None, v_scale=None, split_pages=0,
                    terms=None):
    """The ragged kernels' output ``[N, H, D]`` (padding 0) on the CPU:
    rows of more than one query through ``emulated_tile`` in tiles of
    BQ, one-query rows through ``emulated_decode``."""
    N, H, D = q.shape
    quant = k_scale is not None
    terms = terms or (CODE_TERMS if quant else FLOAT_TERMS)
    pps = page_table.shape[1]
    scale = np.float32(np.float32(1.0 / math.sqrt(D)) * np.float32(LOG2E))
    out = torch.zeros_like(q)
    for b, (qs, ql, kv) in enumerate(zip(q_starts.tolist(), q_lens.tolist(),
                                         kv_lens.tolist())):
        if ql == 0:
            continue
        cap = min(kv, pps * PAGE)
        k, v, ks, vs = _row_keys(k_pool, v_pool, k_scale, v_scale,
                                 page_table, b, cap)
        qr = q[qs:qs + ql] * float(scale)
        for h in range(H):
            kh, vh = k[:, h], v[:, h]
            ksh = None if ks is None else ks[:, h]
            vsh = None if vs is None else vs[:, h]
            if ql == 1:
                out[qs, h] = emulated_decode(qr[0, h], kh, vh, ksh, vsh,
                                             cap, split_pages, pps)
                continue
            for t0 in range(0, ql, BQ):
                n = min(BQ, ql - t0)
                pos0 = kv - ql + t0
                n_keys = max(0, min(cap, pos0 + n))
                out[qs + t0:qs + t0 + n, h] = emulated_tile(
                    qr[t0:t0 + n, h], kh[:n_keys], vh[:n_keys],
                    None if ksh is None else ksh[:n_keys],
                    None if vsh is None else vsh[:n_keys], pos0, cap, terms)
    return out


def _mix(seed, H, D, mode):
    """Rows: a decode row, a 40-token chunk at the start of its prompt, a
    prefix hit (12 new tokens over 88 cached), an idle row, a decode row
    at the full table, and 5 padding tokens; 8 pages of 16 a row."""
    rng = np.random.default_rng(seed)
    pps = 8
    q_lens = [1, 40, 12, 0, 1]
    kv_lens = [77, 40, 100, 0, pps * PAGE]
    n_pool = len(q_lens) * pps + 1
    pt = (rng.permutation(n_pool - 1) + 1).reshape(len(q_lens), pps)
    q_starts = np.cumsum([0] + q_lens[:-1])
    n = sum(q_lens) + 5
    kf = rng.standard_normal((n_pool, PAGE, H, D)).astype(np.float32)
    vf = rng.standard_normal((n_pool, PAGE, H, D)).astype(np.float32)
    q = rng.standard_normal((n, H, D)).astype(np.float32)
    rows = [np.asarray(x, np.int32) for x in (pt, kv_lens, q_starts, q_lens)]
    if mode == "f32":
        jpools, jkw = [jnp.asarray(kf), jnp.asarray(vf)], {}
        tpools = [torch.from_numpy(kf), torch.from_numpy(vf)]
        tkw = {}
    else:
        kq, ks = jax_quantize_kv(jnp.asarray(kf), mode)
        vq, vs = jax_quantize_kv(jnp.asarray(vf), mode)
        jpools, jkw = [kq, vq], dict(k_scale=ks, v_scale=vs)
        tpools = [codes_torch(kq), codes_torch(vq)]
        tkw = dict(k_scale=torch.from_numpy(np.array(ks)),
                   v_scale=torch.from_numpy(np.array(vs)))
    jax_args = [jnp.asarray(q)] + jpools + [jnp.asarray(r) for r in rows]
    torch_args = [torch.from_numpy(q)] + tpools + [torch.from_numpy(r)
                                                   for r in rows]
    return (jax_args, jkw), (torch_args, tkw), sum(q_lens)


def _f64(torch_args, tkw):
    """The plain arithmetic in float64 (dequantized pools: code * scale
    is exact in float64)."""
    q, kp, vp, pt, kv, qs, ql = torch_args
    if tkw:
        kp = kp.to(torch.float64) * tkw["k_scale"].double()[..., None]
        vp = vp.to(torch.float64) * tkw["v_scale"].double()[..., None]
    return pa.ragged_attention_ref(q.double(), kp.double(), vp.double(), pt,
                                   kv, qs, ql)


def test_codes_are_exact_in_tf32_and_bf16():
    """Every int8 code and every finite e4m3 value: tf32 rounding and the
    tensor core's truncation keep it, and so does bf16."""
    i8 = torch.arange(-128, 128, dtype=torch.float32)
    e4 = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(
        torch.float8_e4m3fn).to(torch.float32)
    e4 = e4[torch.isfinite(e4)]
    assert len(e4) == 254                  # 0x7f and 0xff are NaN
    for x in (i8, e4):
        assert torch.equal(tf32(x), x)
        assert torch.equal(truncate(x), x)
        assert torch.equal(x.to(torch.bfloat16).to(torch.float32), x)
    assert e4.abs().max().item() == 448.0


@pytest.mark.parametrize("dp", [32, 64, 128])
def test_code_fragment_columns_agree(dp):
    """Each k-step of the code tile's S reads the same head-dim column at
    every reduction index from q's permuted planes and from the codes;
    each 16 columns stay in their block (the in-place permutation); an
    unpermuted q plane pairs wrong columns. P V's output columns cover
    the head dim once."""
    steps_a, steps_b = code_steps(dp)
    assert steps_a == steps_b
    assert sorted(d for s in steps_a for d in s) == list(range(dp))
    for kp in range(dp // 16):
        block = [d for s in steps_a[2 * kp:2 * kp + 2] for d in s]
        assert sorted(block) == list(range(16 * kp, 16 * kp + 16))
    natural = [list(range(8 * kk, 8 * kk + 8)) for kk in range(dp // 8)]
    assert natural != steps_b
    cols = v_columns(dp)
    assert sorted(c for tile in cols for c in tile) == list(range(dp))


@pytest.mark.parametrize("mode", ["f32", "int8", "fp8"])
@pytest.mark.parametrize("H,D", [(2, 64), (3, 32)])
def test_emulated_kernels_match_jax(mode, H, D):
    """The emulation, unsplit and with a 3-page split, against JAX's
    ``ragged_attention_lax`` (and its split reference) and the Pallas
    kernel in interpret mode: within 2e-5, padding exact 0."""
    (ja, jkw), (ta, tkw), n_used = _mix(7 * H + D, H, D, mode)
    got = emulated_ragged(*ta, **tkw)
    got_split = emulated_ragged(*ta, split_pages=3, **tkw)
    lax = np.asarray(ragged_attention_lax(*ja, **jkw))
    lax_split = np.asarray(ragged_attention_lax_split(*ja, 3, **jkw))
    pallas = np.asarray(ragged_attention_pallas(*ja, interpret=True, **jkw))
    for want in (lax, pallas):
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_split.numpy(), lax_split, rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got_split.numpy(), got.numpy(), rtol=TOL,
                               atol=TOL)
    assert (got[n_used:] == 0).all() and (got_split[n_used:] == 0).all()
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("mode,kind", [("f32", "float"), ("int8", "code"),
                                       ("fp8", "code")])
def test_one_tf32_product_is_a_hundred_times_worse(mode, kind):
    """Against float64, one tf32 product a k-step (q or p rounded to
    tf32) errs at least 100 times more than the kernels' two (codes) or
    three (float32): the tile rows need them to hold 2e-5."""
    _, (ta, tkw), _ = _mix(5, 2, 64, mode)
    want = _f64(ta, tkw)
    err = (emulated_ragged(*ta, **tkw).double() - want).abs().max().item()
    err1 = (emulated_ragged(*ta, terms=ONE_TERM[kind], **tkw).double()
            - want).abs().max().item()
    assert err < TOL
    assert err1 >= 100 * err, (err1, err)
