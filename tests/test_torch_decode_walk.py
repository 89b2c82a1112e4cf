"""The decode kernel's arithmetic (``csrc/paged_attention.cu`` on
``csrc/paged_walk.cuh``), emulated on the CPU.

On the card a thread-block cluster of CS blocks of W warps owns one
(slot, head). Worker ``g = rank * W + warp`` walks the slot's visible
pages ``g, g + CS * W, ...``; ``D / 8`` lanes share a key (eight
columns a lane, as ``lane_col``), ``256 / D`` keys go at once and each
key's dot product is an eight-term FMA chain a lane summed over its lanes
by an xor butterfly; the online softmax runs in the log2 domain (q
pre-scaled by ``sm_scale * log2(e)``) with one max update a page, each key
group keeping its own share of l and acc until the walk's end, where the
groups' shares are summed by a second butterfly. Each block merges its
warps in warp order into one record, and the cluster merges the blocks'
records in rank order.

The kernel cannot run here; this module runs the same arithmetic in float32
numpy (each FMA rounded once) at small sizes, with the walk's shape (W, CS
and pages a warp) read from the kernel's own constants, and holds it within
2e-5 of JAX's ``paged_attention_lax`` and of ``paged_attention_pallas`` in
interpret mode, at the card tests' geometries (pages of 8, 16 and 32
positions, head dims 16, 40, 64 and 128) with clusters of one to eight
blocks, and slots of 0, 1 and every length up to the full table.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.kernels.paged_attention import (  # noqa: E402
    paged_attention_lax, paged_attention_pallas)
from _torch_threads import one_thread  # noqa: E402,F401

TOL = 2e-5
LOG2E = np.float32(1.4426950408889634)
SOURCE = (Path(__file__).resolve().parents[1] / "paddle_tpu_torch" /
          "kernels" / "csrc" / "paged_attention.cu")
MAX_SMEM = 227 * 1024


def kernel_constants():
    """The launch constants of ``paged_attention.cu``."""
    text = SOURCE.read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                text).group(1))
            for name in ("kWarps", "kPagesPerWarp", "kMaxCluster",
                         "kStages")}


def plan(D, page, pps, pairs=1, sms=132):
    """(DP, W, CS) as ``launch_dp`` picks them: head dim padded to 32, 64
    or 128; a warp for every kPagesPerWarp pages of the table, at most
    kWarps a block and as many as the ring fits; as many blocks a cluster
    as the warps need, at most kMaxCluster, and no more than keep the
    ``pairs`` (slot, head) pairs' blocks resident at once on ``sms`` SMs
    (blocks an SM holds counted by shared memory, which binds at these
    shapes: 228 KB an SM, 1 KB a block reserved)."""
    c = kernel_constants()
    DP = 32 if D <= 32 else 64 if D <= 64 else 128
    stage = (2 * page * DP * 4 + 15) // 16 * 16
    workers = -(-pps // c["kPagesPerWarp"])
    W = min(workers, c["kWarps"], MAX_SMEM // (c["kStages"] * stage))
    smem = max(W * c["kStages"] * stage, 4 * (W + 1) * (DP + 2))
    resident = sms * (228 * 1024 // (smem + 1024))
    CS = min(c["kMaxCluster"], -(-workers // W))
    if CS * pairs > resident:
        CS = max(1, resident // pairs)
    return DP, W, CS


def fma(a, b, c):
    """float32 fmaf: the exact a * b + c, rounded once."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def lane_cols(DP):
    """[LPK, 8]: the head-dim column of element i of lane s of a key's
    lanes (float32 rows: two float4, at s and s + LPK)."""
    s = np.arange(DP // 8)[:, None]
    i = np.arange(8)[None, :]
    return 4 * s + (i & 3) + (i >> 2) * (DP // 2)


def walk_warp(qr, k, v, pages, cap, page, DP):
    """One warp's walk_pages over ``pages`` (page indices of the slot, in
    order): k and v [n_keys, DP] (columns past D zero), qr [DP] scaled.
    Returns (m, l, acc [DP]) after the key groups' shares are summed."""
    LPK = DP // 8
    KPP = 32 // LPK
    cols = lane_cols(DP)                          # [LPK, 8]
    m = np.float32(-np.inf)
    l = np.zeros(KPP, np.float32)                 # a key group's share
    acc = np.zeros((KPP, DP), np.float32)
    for p in pages:
        base = p * page
        sc = []
        for pp in range(0, page, KPP):            # passes: KPP keys at once
            j = pp + np.arange(KPP)               # key of each group
            key = j < page
            rows = np.where(key, base + j, 0)
            kf = np.zeros((KPP, DP), np.float32)
            ok = key & (rows < k.shape[0])
            kf[ok] = k[rows[ok]]
            part = np.zeros((KPP, LPK), np.float32)   # a lane's FMA chain
            for e in range(8):
                part = fma(qr[cols[:, e]][None], kf[:, cols[:, e]], part)
            o = LPK // 2
            while o:                              # butterfly over the lanes
                part = part + part[:, np.arange(LPK) ^ o]
                o //= 2
            dot = part[:, 0]
            valid = key & (base + j < cap)
            sc.append((np.where(valid, dot, -np.inf).astype(np.float32),
                       rows, key))
        mx = max(s.max() for s, _, _ in sc)
        m_new = max(m, mx)
        m_use = np.float32(0) if m_new == -np.inf else m_new
        alpha = np.exp2(np.float32(m - m_use))
        l = l * alpha
        acc = acc * alpha
        m = m_new
        for s, rows, key in sc:
            p_ = np.exp2(s - m_use).astype(np.float32)    # masked: 0
            l = l + p_
            vf = np.zeros((len(rows), DP), np.float32)
            ok = key & (rows < v.shape[0])
            vf[ok] = v[rows[ok]]
            acc = fma(p_[:, None], vf, acc)
    o = 1
    while o < len(l):                             # butterfly over the groups
        idx = np.arange(len(l)) ^ o
        l = l + l[idx]
        acc = acc + acc[idx]
        o *= 2
    return m, l[0], acc[0]


def merge(states):
    """merge_states: the records merged in order (log2 domain)."""
    mt = np.float32(-np.inf)
    for m, _, _ in states:
        mt = max(mt, m)
    mu = np.float32(0) if mt == -np.inf else mt
    lt = np.float32(0)
    at = np.zeros_like(states[0][2])
    for m, l, acc in states:
        f = np.exp2(np.float32(m - mu))
        lt = fma(l, f, lt)
        at = fma(acc, f, at)
    return mt, lt, at


def emulated_decode(q, k_pool, v_pool, page_table, seq_lens, CS,
                    sm_scale=None):
    """The decode kernel's output [B, H, D] for float32 numpy inputs, with
    clusters of CS blocks."""
    B, H, D = q.shape
    page, pps = k_pool.shape[1], page_table.shape[1]
    DP, W, _ = plan(D, page, pps)
    scale = np.float32(sm_scale if sm_scale is not None
                       else 1.0 / math.sqrt(D)) * LOG2E
    out = np.zeros_like(q)
    for b in range(B):
        cap = min(int(seq_lens[b]), pps * page)
        n_pages = min(-(-max(cap, 0) // page), pps)
        keys = max(cap, 0)
        k = k_pool[page_table[b]].reshape(pps * page, H, D)[:keys]
        v = v_pool[page_table[b]].reshape(pps * page, H, D)[:keys]
        for h in range(H):
            kh = np.zeros((keys, DP), np.float32)
            vh = np.zeros((keys, DP), np.float32)
            kh[:, :D], vh[:, :D] = k[:, h], v[:, h]
            qr = np.zeros(DP, np.float32)
            qr[:D] = q[b, h] * scale
            blocks = []
            for rank in range(CS):
                warps = [walk_warp(qr, kh, vh,
                                   range(rank * W + w, n_pages, CS * W),
                                   cap, page, DP) for w in range(W)]
                blocks.append(merge(warps))
            _, lt, at = merge(blocks)
            out[b, h] = 0 if lt == 0 else (at / lt)[:D]
    return out


def _inputs(H, D, page, pps, seq, seed):
    rng = np.random.default_rng(seed)
    B = len(seq)
    n_pool = B * pps + 1
    table = (rng.permutation(n_pool - 1) + 1).reshape(B, pps)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f32(B, H, D), f32(n_pool, page, H, D), f32(n_pool, page, H, D),
            table.astype(np.int32), np.asarray(seq, np.int32))


def test_the_plan_fills_the_card():
    """GPT-2-small decode (D 64, 16-token pages, 64 a row): four warps a
    block; the per-tier path's one slot (12 pairs) a cluster of eight
    (32 warps, two pages each), the smoke's nine slots (108 pairs) three
    blocks a pair, a large batch one; every visible page is walked by
    exactly one warp."""
    assert plan(64, 16, 64, pairs=12) == (64, 4, 8)
    assert plan(64, 16, 64, pairs=108) == (64, 4, 3)
    assert plan(64, 16, 64, pairs=32 * 64) == (64, 4, 1)
    for CS in (1, 3, 8):
        G = CS * 4
        walked = sorted(p for g in range(G) for p in range(g, 63, G))
        assert walked == list(range(63))


# (H, D, page, pages a row): the card tests' geometries, and tables wide
# enough for clusters of up to eight blocks
GEOMETRIES = [(2, 16, 8, 4), (4, 128, 32, 8), (3, 40, 16, 6),
              (2, 64, 16, 24), (2, 16, 8, 40), (2, 32, 8, 64)]


@pytest.mark.parametrize("H,D,page,pps", GEOMETRIES)
def test_emulated_decode_matches_jax(H, D, page, pps):
    """The emulation, at every cluster size the host may pick for the
    table (one block, two, the most), against JAX's ``paged_attention_lax``
    and the Pallas decode kernel in interpret mode: within 2e-5, a slot at
    seq_len 0 exact 0, a slot at seq_len 1 its one value row."""
    S = page * pps
    seq = [S, 1, 0, S // 2 + 3, 5, S - 1]
    q, kp, vp, table, seq_lens = _inputs(H, D, page, pps, seq, seed=D + pps)
    jargs = [jnp.asarray(x) for x in (q, kp, vp, table, seq_lens)]
    lax = np.asarray(paged_attention_lax(*jargs))
    pallas = np.asarray(paged_attention_pallas(*jargs, interpret=True))
    for CS in sorted({1, 2, plan(D, page, pps)[2]}):
        got = emulated_decode(q, kp, vp, table, seq_lens, CS)
        for want in (lax, pallas):
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        assert (got[2] == 0).all()
        np.testing.assert_allclose(got[1], vp[table[1, 0], 0], rtol=TOL,
                                   atol=TOL)


def test_every_slot_shorter_than_a_block_share():
    """Slots of 1 to 3 pages in a table that plans a cluster of eight:
    most warps, and whole blocks, walk nothing and still merge."""
    H, D, page, pps = 2, 32, 8, 64
    CS = plan(D, page, pps, pairs=10)[2]
    assert CS == 8
    seq = [1, 8, 9, 24, 0]
    q, kp, vp, table, seq_lens = _inputs(H, D, page, pps, seq, seed=3)
    got = emulated_decode(q, kp, vp, table, seq_lens, CS)
    want = np.asarray(paged_attention_lax(
        *[jnp.asarray(x) for x in (q, kp, vp, table, seq_lens)]))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert (got[4] == 0).all()
