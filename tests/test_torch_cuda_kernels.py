"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (with the reason) where no CUDA device
is present, and runs on a machine with the card::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

Imports no JAX (``--noconftest`` skips ``tests/conftest.py``, which
does), so it runs where only PyTorch is installed.
"""
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch.inference.llm import (  # noqa: E402
    CacheConfig, GenerationEngine, SchedulerConfig, TorchLM)
from paddle_tpu_torch.inference.llm.quant import (  # noqa: E402
    QuantConfig, quantize_kv)
from paddle_tpu_torch.kernels import paged_attention as pa  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = 2e-5      # the JAX package's tolerance for its Pallas tier


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _mix(device, H, D, page, q_lens, kv_lens, pages_per_seq, pad, seed):
    g = torch.Generator().manual_seed(seed)
    B = len(q_lens)
    n_pages = B * pages_per_seq + 1
    perm = torch.randperm(n_pages - 1, generator=g) + 1
    q_starts, s = [], 0
    for ql in q_lens:
        q_starts.append(s)
        s += ql
    i32 = dict(dtype=torch.int32, device=device)
    return dict(
        q=torch.randn(s + pad, H, D, generator=g).to(device),
        k_pool=torch.randn(n_pages, page, H, D, generator=g).to(device),
        v_pool=torch.randn(n_pages, page, H, D, generator=g).to(device),
        page_table=perm.reshape(B, pages_per_seq).to(**i32),
        kv_lens=torch.tensor(kv_lens, **i32),
        q_starts=torch.tensor(q_starts, **i32),
        q_lens=torch.tensor(q_lens, **i32)), s


@pytest.mark.parametrize("H,D,page,pps", [(2, 16, 8, 4), (12, 64, 16, 64),
                                          (4, 128, 32, 8), (3, 40, 16, 6)])
def test_kernel_matches_plain_version(device, H, D, page, pps):
    S = page * pps
    q_lens = [S // 2, 1, 3, 0, 1, S // 4]
    kv_lens = [S // 2, S - 1, 5, 0, 1, S // 4 + 7]
    args, n_used = _mix(device, H, D, page, q_lens, kv_lens, pps, 9, seed=H)
    before = pa.LAUNCHES["ragged_attention"]
    out = pa.ragged_attention(**args, max_q_len=max(q_lens))
    torch.cuda.synchronize()
    assert pa.LAUNCHES["ragged_attention"] == before + 1
    ref = pa.ragged_attention(**args, tier="ref")
    torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)
    assert (out[n_used:] == 0).all()


def test_kernel_grid_without_max_q_len(device):
    args, _ = _mix(device, 2, 16, 8, [5, 1, 0], [9, 20, 0], 4, 3, seed=1)
    out = pa.ragged_attention(**args, tier="kernel")
    ref = pa.ragged_attention(**args, tier="ref")
    torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)


def test_engine_kernel_tier_matches_plain_tier(device):
    model = TorchLM.tiny(device=device)
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6] * 3, [2, 7, 1, 8] * 5, [1, 2, 3]]
    outs = []
    for tier in ("auto", "ref"):
        eng = GenerationEngine(
            model, cache_config=CacheConfig(
                num_layers=2, num_heads=2, head_dim=16, num_pages=64,
                page_size=8, max_slots=4, max_seq_len=128),
            scheduler_config=SchedulerConfig(max_slots=4, max_seq_len=128),
            attn_tier=tier)
        outs.append(eng.generate(prompts, 8))
    assert outs[0] == outs[1]


def _quantized(args, mode):
    """``args`` with its float pools re-stored as ``mode`` code pools,
    plus the scale-pool keywords (empty for float32)."""
    if mode == "f32":
        return args, {}
    kq, ks = quantize_kv(args["k_pool"], mode)
    vq, vs = quantize_kv(args["v_pool"], mode)
    return dict(args, k_pool=kq, v_pool=vq), dict(k_scale=ks, v_scale=vs)


@pytest.mark.parametrize("mode", ["f32", "int8", "fp8"])
@pytest.mark.parametrize("split", [0, 1, 3, 16])
@pytest.mark.parametrize("H,D,page,pps", [(2, 16, 8, 4), (32, 64, 16, 128),
                                          (3, 30, 16, 6)])
def test_quant_and_split_kernels_match_plain(device, mode, split, H, D,
                                             page, pps):
    S = page * pps
    q_lens = [S // 2, 1, 3, 0, 1, S // 4]
    kv_lens = [S // 2, S - 1, 5, 0, S, S // 4 + 7]
    args, n_used = _mix(device, H, D, page, q_lens, kv_lens, pps, 9,
                        seed=D)
    args, scales = _quantized(args, mode)
    is_split = pa.split_active(split, pps)
    name = pa.kernel_name(args["k_pool"].dtype, is_split)
    before = pa.LAUNCHES[name]
    out = pa.ragged_attention(**args, max_q_len=max(q_lens),
                              split_pages=split, **scales)
    torch.cuda.synchronize()
    assert pa.LAUNCHES[name] == before + 1
    ref = pa.ragged_attention_ref_split(**args, split_pages=split, **scales)
    torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)
    assert (out[n_used:] == 0).all()
    if is_split:
        unsplit = pa.ragged_attention(**args, max_q_len=max(q_lens),
                                      **scales)
        torch.testing.assert_close(out, unsplit, rtol=TOL, atol=TOL)
        again = pa.ragged_attention(**args, max_q_len=max(q_lens),
                                    split_pages=split, **scales)
        assert torch.equal(out, again)     # no atomics: the same bits


# every row kind of the redesigned kernels: idle, one query (the decode
# walk), two (the smallest tile row), around one and eight 64-row tiles;
# the last row sees no key (kv_len 0); context lengths are no multiple of
# the page
EDGE_Q_LENS = [0, 1, 2, 15, 16, 17, 63, 64, 65, 512, 1]
EDGE_KV_LENS = [0, 77, 43, 15, 111, 170, 63, 333, 101, 600, 0]


@pytest.mark.parametrize("mode", ["f32", "int8", "fp8"])
@pytest.mark.parametrize("split", [0, 3])
@pytest.mark.parametrize("page,D", [(8, 32), (16, 64), (32, 80), (16, 128)])
def test_row_kinds_page_sizes_and_head_dims(device, mode, split, page, D):
    """The decode walk and the tensor-core tile at every q_len around
    their threshold and the tile's rows, page sizes 8/16/32, head dims
    32/64/80/128, a page of all-zero values (codes 0 under scale 0) read
    by two rows: within 2e-5 of the plain version (the split one's
    reference for the split), padding exact 0, the split within 2e-5 of
    the unsplit kernel, reruns bit-identical."""
    pps = -(-640 // page)
    args, n_used = _mix(device, 4, D, page, EDGE_Q_LENS, EDGE_KV_LENS, pps,
                        7, seed=page + D)
    args, scales = _quantized(args, mode)
    zero_page = int(args["page_table"][9, 1])     # rows 9 and 4 read it
    args["page_table"][4, 0] = zero_page
    if mode == "f32":
        for pool in ("k_pool", "v_pool"):
            args[pool][zero_page] = 0
    else:
        for pool in ("k_pool", "v_pool"):
            args[pool].view(torch.uint8)[zero_page] = 0
        for sc in scales.values():
            sc[zero_page] = 0
    max_q = max(EDGE_Q_LENS)
    outs = {}
    for sp in (0, split) if split else (0,):
        out = pa.ragged_attention(**args, max_q_len=max_q, split_pages=sp,
                                  **scales)
        again = pa.ragged_attention(**args, max_q_len=max_q, split_pages=sp,
                                    **scales)
        torch.cuda.synchronize()
        ref = pa.ragged_attention_ref_split(**args, split_pages=sp, **scales)
        torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)
        assert (out[n_used:] == 0).all()
        assert torch.equal(out, again)
        outs[sp] = out
    if split:
        torch.testing.assert_close(outs[split], outs[0], rtol=TOL, atol=TOL)
    row = sum(EDGE_Q_LENS[:-1])                   # the last row: no key
    assert (outs[0][row] == 0).all()


# sha256 of the decode kernel's output bytes at its GPT-2-small geometry on
# the inputs of ``_decode_bits_inputs``, from the build of the cluster design
# (paged_attention.cu on paged_walk.cuh's asynchronous-copy walk) on an H100
# (132 SMs: clusters of four blocks at these 96 pairs; a card with another
# SM count may pick another cluster size, and so other bits)
DECODE_BITS = "0e66e4ea2631c99b8c50c512e0ef27af6ef9fe47f08fb1d1417357542024956f"


def _decode_bits_inputs(device):
    rng = np.random.default_rng(2024)
    B, H, D, page, pps = 8, 12, 64, 16, 64
    n_pages = B * pps + 1
    f32 = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).to(device)
    table = rng.permutation(n_pages - 1).reshape(B, pps) + 1
    seq = [1000, 1, 0, 517, 1024, 999, 16, 33]
    i32 = dict(dtype=torch.int32, device=device)
    return dict(q=f32(B, H, D), k_pool=f32(n_pages, page, H, D),
                v_pool=f32(n_pages, page, H, D),
                page_table=torch.tensor(table, **i32),
                seq_lens=torch.tensor(seq, **i32))


def _digest(out):
    return hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()


def test_decode_kernel_bits_did_not_move(device):
    """The decode kernel (``paged_attention.cu``) gives the bits its
    build gave when they were pinned."""
    out = pa.paged_attention(**_decode_bits_inputs(device), tier="kernel")
    torch.cuda.synchronize()
    assert _digest(out) == DECODE_BITS, _digest(out)


# sha256 of the ragged kernels' output bytes on decode-only rows (every row
# one query: the one-query walk alone), by (page type, geometry, split), as
# the build of ragged_attention.cuh with its own copy of the walk gave them:
# the walk moved to paged_walk.cuh without moving a bit. The int8 and fp8
# entries were taken again, with every kernel source unchanged, when the
# KV quantizer's scales became true divisions (amax / 127, amax / 448):
# they quantize these inputs
RAGGED_DECODE_BITS = {
    "f32 gpt2 0":
        "7d7ea99bfd27bb17ec81ed018934de33582552f2b64a6d4d02a2a5457db6e2fd",
    "f32 gpt2 16":
        "5bdedd66717194bdc20f3add8115edd93ace9021cced26db67d9c5fbad5ad4f0",
    "int8 gpt2 0":
        "748b663d2de24078900d16ff1dd99d39184b5194bbb29c5f491a5fe1e5d94f01",
    "int8 gpt2 16":
        "855c4caf2f68df9b57925771a36e3c12e04cc1cfab7fb04b9d4f28c1d1da7a5a",
    "fp8 gpt2 0":
        "c789cac71ed26ce31bc1a1aa01c35d643449634feb1e3b4eef21fed76316e3b9",
    "fp8 gpt2 16":
        "958688e1d3d33810d1739614077a01a4bdd020b0c78d3e83a8ab54cf803e1500",
    "f32 d40 0":
        "16b465bc7137b9eb793862031b15873611255c3e9328af3d09df69cff8ed76fa",
    "f32 d40 16":
        "571f5539aa633756bfe31d269a8a41548b597d84ed3d8c3dd0ae00802f84954e",
    "int8 d40 0":
        "cd3ebc9f7e8c5a83267a235fdc4828b06acc5bae07ac12074e872a41982d6829",
    "int8 d40 16":
        "e496ce65822ce134719be6d399b80972fdc5a2221748c757edbb440638130241",
    "fp8 d40 0":
        "e7b367c3b0d0c153d12e87234dc23d3cfb0c43df14e325528084f7a9ea56de14",
    "fp8 d40 16":
        "c6c827a2a0ff76b190bb0748ae28fd13c69c8c3a59fe8714dac4b09da0d1b12d",
}
RAGGED_BITS_GEOMETRIES = {"gpt2": (12, 64, 16, 64), "d40": (3, 40, 8, 24)}


def _ragged_decode_inputs(device, geometry, mode):
    """Eight one-query rows (lengths 0 to the full table) at ``geometry``
    (H, D, page, pages a row), float32 pools re-stored as ``mode``."""
    H, D, page, pps = RAGGED_BITS_GEOMETRIES[geometry]
    rng = np.random.default_rng(7)
    S = page * pps
    kv_lens = [S - 24, 1, 0, S // 2 + 5, S, S - 1, page, 2 * page + 1]
    B = len(kv_lens)
    n_pages = B * pps + 1
    f32 = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).to(device)
    i32 = dict(dtype=torch.int32, device=device)
    args = dict(q=f32(B, H, D), k_pool=f32(n_pages, page, H, D),
                v_pool=f32(n_pages, page, H, D),
                page_table=torch.tensor(
                    rng.permutation(n_pages - 1).reshape(B, pps) + 1, **i32),
                kv_lens=torch.tensor(kv_lens, **i32),
                q_starts=torch.arange(B, **i32),
                q_lens=torch.ones(B, **i32))
    return _quantized(args, mode)


def ragged_decode_digests(device):
    """{"mode geometry split": sha256} of the ragged kernels on
    ``_ragged_decode_inputs``, unsplit and split 16."""
    out = {}
    for geometry in RAGGED_BITS_GEOMETRIES:
        for mode in ("f32", "int8", "fp8"):
            args, scales = _ragged_decode_inputs(device, geometry, mode)
            for split in (0, 16):
                got = pa.ragged_attention(**args, tier="kernel", max_q_len=1,
                                          split_pages=split, **scales)
                torch.cuda.synchronize()
                out[f"{mode} {geometry} {split}"] = _digest(got)
    return out


def _inexact_amax_rows(qmax: float, n: int = 64, D: int = 16):
    """``n`` rows of D float32 values whose absmax ``a`` has
    ``float32(a) * float32(1 / qmax) != float32(a) / float32(qmax)``
    (numpy picks them), and the float32 quotients numpy gives."""
    rng = np.random.default_rng(int(qmax))
    inv = np.float32(1.0) / np.float32(qmax)
    cand = (rng.uniform(0.5, 8.0, 200_000)).astype(np.float32)
    bad = cand[cand * inv != cand / np.float32(qmax)][:n]
    assert len(bad) == n, "numpy found too few inexact amax values"
    rows = rng.uniform(-0.5, 0.5, (n, D)).astype(np.float32) * bad[:, None]
    rows[:, 3] = -bad                  # the absmax of each row, negative
    return rows, (bad / np.float32(qmax)).astype(np.float32)


@pytest.mark.parametrize("mode,qmax", [("int8", 127.0), ("fp8", 448.0)])
def test_quantize_scales_divide_exactly(device, mode, qmax):
    """The KV quantizer's scales on the card equal numpy's float32
    ``amax / qmax`` bit for bit, on rows where a multiply by the
    reciprocal (PyTorch's way with a Python-scalar divisor) lands an ulp
    away; for int8 also ``quantize_absmax`` directly."""
    from paddle_tpu_torch.kernels.int8 import quantize_absmax

    rows, want = _inexact_amax_rows(qmax)
    x = torch.from_numpy(rows).to(device)
    _, scales = quantize_kv(x[:, None, :], mode)
    got = scales[:, 0].cpu().numpy()
    assert got.view(np.uint32).tolist() == want.view(np.uint32).tolist()
    if mode == "int8":
        _, s = quantize_absmax(x, axis=-1)
        assert s[:, 0].cpu().numpy().view(np.uint32).tolist() == \
            want.view(np.uint32).tolist()


def test_ragged_decode_bits_did_not_move(device):
    """The ragged kernels' one-query rows, float32 / int8 / fp8 pages,
    unsplit and split 16, at two geometries (the 16-byte copy route and,
    for code pages at D 40, the plain-load one) give the bits of the build
    that had its own copy of the walk."""
    assert ragged_decode_digests(device) == RAGGED_DECODE_BITS


@pytest.mark.parametrize("H,D,page,pps,seq", [
    (2, 32, 8, 64, [1, 8, 9, 24, 0]),      # every slot under a block's share
    (3, 64, 16, 64, [0]),                  # B = 1, seq_len 0
    (2, 16, 8, 40, [320, 1, 0, 161]),      # a cluster of three
    (4, 128, 32, 64, [2048, 33, 0, 1000]),  # D 128: a ring of fewer warps
])
def test_decode_kernel_cluster_edges(device, H, D, page, pps, seq):
    """Slots whose pages leave whole blocks of the cluster with nothing
    to walk (they still reach both cluster barriers), a lone empty slot,
    and the widest rows: within 2e-5 of the plain version, a seq_len-0
    slot exact 0, a rerun bit-identical."""
    args = _per_tier_inputs(device, len(seq), 1, H, D, page, pps, seed=pps)
    args["q"] = args["q"][:, 0].contiguous()
    seq_lens = torch.tensor(seq, dtype=torch.int32, device=device)
    out = pa.paged_attention(**args, seq_lens=seq_lens, tier="kernel")
    again = pa.paged_attention(**args, seq_lens=seq_lens, tier="kernel")
    torch.cuda.synchronize()
    ref = pa.paged_attention(**args, seq_lens=seq_lens, tier="ref")
    torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)
    assert torch.equal(out, again)
    for b, n in enumerate(seq):
        if n == 0:
            assert (out[b] == 0).all()


def test_quantized_kernel_rejects_missing_scales(device):
    args, _ = _mix(device, 2, 16, 8, [2], [5], 4, 0, seed=3)
    args, _ = _quantized(args, "int8")
    with pytest.raises(ValueError, match="scale"):
        pa.ragged_attention(**args)


@pytest.mark.parametrize("max_seq_len,split", [(1000, 0), (1000, 16),
                                               (64, 0), (200, 3)])
def test_engine_at_unaligned_page_directory(device, max_seq_len, split):
    """Page-table widths the two-level directory does not fill (63 pages
    in 64 columns, 4 in 8, 13 in 16): the flattened table reaches the
    kernel every step, and the tokens equal the plain tier's."""
    model = TorchLM.tiny(max_seq_len=max_seq_len, device=device)
    cfg = CacheConfig(num_layers=2, num_heads=2, head_dim=16, num_pages=96,
                      page_size=16, max_slots=3, max_seq_len=max_seq_len)
    assert cfg.dir_entries * cfg.dir_fanout > cfg.pages_per_seq
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6] * 4, [2, 7, 1, 8] * 5, [1, 2, 3]]
    outs = []
    for tier in ("auto", "ref"):
        eng = GenerationEngine(
            model, cache_config=cfg,
            scheduler_config=SchedulerConfig(max_slots=3,
                                             max_seq_len=max_seq_len,
                                             kv_split_pages=split),
            attn_tier=tier)
        pa.LAUNCHES.clear()
        outs.append(eng.generate(prompts, 8))
        if tier == "auto":
            name = pa.kernel_name(torch.float32,
                                  pa.split_active(split, cfg.pages_per_seq))
            assert dict(pa.LAUNCHES) == {name: 2 * eng.steps_dispatched}
    assert outs[0] == outs[1]


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_quantized_split_engine_runs_the_split_kernel(device, kv):
    model = TorchLM.tiny(device=device)
    eng = GenerationEngine(
        model, cache_config=CacheConfig(
            num_layers=2, num_heads=2, head_dim=16, num_pages=64,
            page_size=8, max_slots=4, max_seq_len=128),
        scheduler_config=SchedulerConfig(max_slots=4, max_seq_len=128,
                                         chunk_tokens=8, kv_split_pages=3),
        quant=QuantConfig(kv=kv, weights="int8"))
    pa.LAUNCHES.clear()
    outs = eng.generate([[3, 1, 4, 1, 5, 9, 2, 6] * 3, [2, 7, 1, 8] * 5], 8)
    assert [len(o) for o in outs] == [8, 8]
    name = pa.kernel_name(eng.cache.k_pool.dtype, True)
    assert dict(pa.LAUNCHES) == {name: 2 * eng.steps_dispatched}


def _per_tier_inputs(device, B, T, H, D, page, pps, seed):
    """Float pools with distinct real pages per slot (page 0 is the
    garbage page) and a query block ``[B, T, H, D]``."""
    g = torch.Generator().manual_seed(seed)
    n_pages = B * pps + 1
    perm = torch.randperm(n_pages - 1, generator=g) + 1
    return dict(
        q=torch.randn(B, T, H, D, generator=g).to(device),
        k_pool=torch.randn(n_pages, page, H, D, generator=g).to(device),
        v_pool=torch.randn(n_pages, page, H, D, generator=g).to(device),
        page_table=perm.reshape(B, pps).to(device=device,
                                           dtype=torch.int32))


GEOMETRIES = [(2, 16, 8, 4), (12, 64, 16, 64), (4, 128, 32, 8),
              (3, 40, 16, 6)]


@pytest.mark.parametrize("H,D,page,pps", GEOMETRIES)
def test_decode_kernel_matches_plain_version(device, H, D, page, pps):
    S = page * pps
    seq = [S, 1, 0, S // 2 + 3, 5, S - 1]
    args = _per_tier_inputs(device, len(seq), 1, H, D, page, pps, seed=D)
    args["q"] = args["q"][:, 0].contiguous()
    seq_lens = torch.tensor(seq, dtype=torch.int32, device=device)
    before = pa.LAUNCHES[pa.PAGED_KERNEL]
    out = pa.paged_attention(**args, seq_lens=seq_lens)
    torch.cuda.synchronize()
    assert pa.LAUNCHES[pa.PAGED_KERNEL] == before + 1
    ref = pa.paged_attention(**args, seq_lens=seq_lens, tier="ref")
    torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)
    assert (out[2] == 0).all()                 # seq_len 0: exact zeros
    assert torch.equal(out, pa.paged_attention(**args, seq_lens=seq_lens))


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("H,D,page,pps", GEOMETRIES)
@pytest.mark.parametrize("T", [1, 5, 37, 64, 65, 512])
def test_mixed_kernel_matches_plain_version(device, H, D, page, pps, T,
                                            split):
    """Every row, padding rows included (they attend the whole
    context), against the plain version; a slot at seq_len 0 is exact
    zeros on every row; reruns give the same bits. ``split``: the
    host's own schedule (None), unsplit (0), or one key block a chunk
    (1, merged in a second pass)."""
    S = page * pps
    q_lens = [min(T, 3), 0, T, 1, 0, max(T - 2, 0)]
    seq = [S, S // 2, min(S, T + 9), 1, 0, S - 1]
    args = _per_tier_inputs(device, len(seq), T, H, D, page, pps, seed=T)
    i32 = dict(dtype=torch.int32, device=device)
    seq_lens, ql = torch.tensor(seq, **i32), torch.tensor(q_lens, **i32)
    before = pa.LAUNCHES[pa.MIXED_KERNEL]
    if split is None:
        out = pa.verify_attention(**args, seq_lens=seq_lens, q_lens=ql)
    else:
        out = pa.mixed_attention_cuda(**args, seq_lens=seq_lens, q_lens=ql,
                                      split_blocks=split)
    torch.cuda.synchronize()
    assert pa.LAUNCHES[pa.MIXED_KERNEL] == before + 1
    ref = pa.mixed_attention(**args, seq_lens=seq_lens, q_lens=ql,
                             tier="ref")
    torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)
    assert (out[4] == 0).all()
    again = (pa.mixed_attention(**args, seq_lens=seq_lens, q_lens=ql)
             if split is None else
             pa.mixed_attention_cuda(**args, seq_lens=seq_lens, q_lens=ql,
                                     split_blocks=split))
    assert torch.equal(out, again)


@pytest.mark.parametrize("split", [0, 2, None])
def test_mixed_kernel_at_the_verify_shape(device, split):
    """The verify shape (GPT-2-small heads, eight slots of 1 + 4 rows
    near 1000 positions, one slot empty, q_lens 0 to 5) with the split
    on (the host's schedule, or 2 key blocks a chunk) and off: each
    within 2e-5 of the plain version, bit-identical run to run, the
    empty slot exact 0."""
    seq = [1000, 990, 0, 1023, 1001, 977, 1012, 960]
    q_lens = [5, 1, 0, 3, 5, 2, 4, 5]
    args = _per_tier_inputs(device, 8, 5, 12, 64, 16, 64, seed=11)
    i32 = dict(dtype=torch.int32, device=device)
    seq_lens, ql = torch.tensor(seq, **i32), torch.tensor(q_lens, **i32)
    _, _, n_split = pa.mixed_plan(8, 5, 12, 16, 64, 132, split)
    assert (n_split > 1) == (split != 0)
    run = [pa.mixed_attention_cuda(**args, seq_lens=seq_lens, q_lens=ql,
                                   split_blocks=split) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(run[0], run[1])
    ref = pa.mixed_attention_ref(**args, seq_lens=seq_lens, q_lens=ql)
    torch.testing.assert_close(run[0], ref, rtol=TOL, atol=TOL)
    assert (run[0][2] == 0).all()


def test_per_tier_kernels_refuse_what_they_do_not_take(device):
    args = _per_tier_inputs(device, 2, 3, 2, 16, 8, 4, seed=0)
    i32 = dict(dtype=torch.int32, device=device)
    seq_lens, ql = torch.tensor([9, 4], **i32), torch.tensor([3, 1], **i32)
    codes, _ = quantize_kv(args["k_pool"], "int8")
    with pytest.raises(ValueError, match="float32 pools"):
        pa.mixed_attention(**dict(args, k_pool=codes, v_pool=codes),
                           seq_lens=seq_lens, q_lens=ql)
    big = dict(args, k_pool=torch.zeros(9, 64, 2, 16, device=device),
               v_pool=torch.zeros(9, 64, 2, 16, device=device))
    with pytest.raises(ValueError, match="page_size"):
        pa.mixed_attention(**big, seq_lens=seq_lens, q_lens=ql)
    strided = dict(args, q=args["q"].transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        pa.mixed_attention(**strided, seq_lens=seq_lens, q_lens=ql)
    decode = dict(args, q=args["q"][:, 0].contiguous())
    with pytest.raises(ValueError, match="int32"):
        pa.paged_attention(**decode, seq_lens=seq_lens.long())


def test_per_tier_graphs_kernel_route_matches_plain_route(device):
    """A tiny model's per-tier graphs (two chunks, a verify step, a decode
    step) through the kernels and through the plain attention, on two
    caches in lockstep: logits at 1e-4, one launch per layer per call."""
    from paddle_tpu_torch.inference.llm.model import (
        lm_chunk_prefill, lm_decode, lm_verify)

    model = TorchLM.tiny(device=device)
    spec, L = model.spec, model.spec.num_layers
    i32 = dict(dtype=torch.int32, device=device)
    pools, logits = {}, {}
    before = dict(pa.LAUNCHES)
    for tier in ("kernel", "ref"):
        kp = torch.zeros(L, 17, 8, spec.num_heads, spec.head_dim,
                         device=device)
        vp = torch.zeros_like(kp)
        row = torch.arange(1, 17, **i32)
        prompt = torch.arange(3, 43, **i32) % spec.vocab
        out = []
        for start in (0, 16, 32):
            n = min(16, 40 - start)
            toks = torch.zeros(16, **i32)
            toks[:n] = prompt[start:start + n]
            out.append(lm_chunk_prefill(model.params, spec, toks, start, n,
                                        kp, vp, row, attn_tier=tier)[:n])
        out.append(lm_verify(model.params, spec,
                             torch.tensor([[5, 6, 7, 0]], **i32),
                             torch.tensor([40], **i32),
                             torch.tensor([3], **i32), kp, vp, row[None],
                             attn_tier=tier)[0])
        out.append(lm_decode(model.params, spec, torch.tensor([9], **i32),
                             torch.tensor([43], **i32), kp, vp, row[None],
                             attn_tier=tier))
        logits[tier], pools[tier] = out, (kp, vp)
        if tier == "kernel":
            torch.cuda.synchronize()
            got = {k: pa.LAUNCHES[k] - before.get(k, 0)
                   for k in (pa.MIXED_KERNEL, pa.PAGED_KERNEL)}
            assert got == {pa.MIXED_KERNEL: 4 * L, pa.PAGED_KERNEL: L}
    for got, want in zip(logits["kernel"], logits["ref"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    for got, want in zip(pools["kernel"], pools["ref"]):
        torch.testing.assert_close(got[:, 1:], want[:, 1:], rtol=1e-4,
                                   atol=1e-4)


# ------------------------------------------------------------ CUDA graphs


@pytest.mark.parametrize("mode", ["f32", "int8", "fp8"])
@pytest.mark.parametrize("split", [0, 3])
def test_graph_replay_of_the_step_is_bit_equal_to_eager(device, mode,
                                                        split):
    """``lm_ragged_step`` captured into a CUDA graph (the tile grid sized
    to the whole block, as the engine captures it) and replayed gives
    the eager step's logits and pool writes bit for bit (the garbage
    page aside); the capture holds one ragged launch a layer and counts
    none itself."""
    from paddle_tpu_torch.inference.llm.kv_cache import PagedKVCache
    from paddle_tpu_torch.inference.llm.model import lm_ragged_step

    model = TorchLM.tiny(device=device)
    spec = model.spec
    quant = None if mode == "f32" else QuantConfig(kv=mode)
    cache = PagedKVCache(CacheConfig(
        num_layers=2, num_heads=2, head_dim=16, num_pages=64, page_size=8,
        max_slots=4, max_seq_len=128, kv_quant=quant.kv if quant else "off"),
        device=device)
    for slot, n in enumerate((40, 17, 60)):
        assert cache.allocate(slot, n)
    g = torch.Generator().manual_seed(5)
    i32 = dict(dtype=torch.int32, device=device)
    # a chunk row of 12 after 20 resident, two decode rows, an idle slot
    q_lens = torch.tensor([12, 1, 1, 0], **i32)
    q_starts = torch.tensor([0, 12, 13, 0], **i32)
    kv_lens = torch.tensor([32, 9, 44, 0], **i32)
    N = 16
    tokens = torch.randint(0, spec.vocab, (N,), generator=g).to(**i32)
    page_table = torch.from_numpy(cache.page_table.copy()).to(**i32)
    for pool in (cache.k_pool, cache.v_pool):
        raw = torch.randint(-100, 100, pool.shape, generator=g)
        if mode == "fp8":        # finite e4m3 codes (0x7f is NaN)
            pool.view(torch.uint8).copy_((raw + 100) % 120)
        elif mode == "int8":
            pool.copy_(raw)
        else:
            pool.copy_(raw / 50.0)
    if cache.k_scale is not None:
        cache.k_scale.copy_(torch.rand(cache.k_scale.shape, generator=g))
        cache.v_scale.copy_(torch.rand(cache.v_scale.shape, generator=g))
    pools = [p for p in (cache.k_pool, cache.v_pool, cache.k_scale,
                         cache.v_scale) if p is not None]
    before = [p.clone() for p in pools]

    def step(max_q):
        return lm_ragged_step(model.params, spec, tokens, q_starts, q_lens,
                              kv_lens, cache.k_pool, cache.v_pool,
                              page_table, max_q_len=max_q,
                              k_scale=cache.k_scale, v_scale=cache.v_scale,
                              quant=quant, kv_split_pages=split)

    eager = step(12)
    torch.cuda.synchronize()
    after = [p.clone() for p in pools]
    for p, b in zip(pools, before):
        p.copy_(b)
    graph = torch.cuda.CUDAGraph()
    n0 = dict(pa.LAUNCHES)
    with pa.held_launches() as held:
        with torch.cuda.graph(graph):
            static = step(N)
    assert dict(pa.LAUNCHES) == n0
    name = pa.kernel_name(cache.k_pool.dtype,
                          pa.split_active(split, page_table.shape[1]))
    assert dict(held) == {name: spec.num_layers}
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(static, eager)
    # every page but the garbage page 0, where the padding tokens'
    # duplicate writes leave an arbitrary one of their values
    for p, a in zip(pools, after):
        if p.dtype == torch.float8_e4m3fn:
            p, a = p.view(torch.uint8), a.view(torch.uint8)
        assert torch.equal(p[:, 1:], a[:, 1:])


@pytest.mark.parametrize("depth", [0, 1, 2])
@pytest.mark.parametrize("kv,split", [("off", 0), ("int8", 3)])
def test_engine_graphs_on_and_off_give_the_same_tokens(device, depth, kv,
                                                       split):
    """The engine with CUDA graphs (one per step signature, replayed)
    and without, at async depths 0-2: the same tokens as the eager
    serial engine, launches layers x steps counted through the replays,
    the signatures within ``graph_bound``, one graph each."""
    model = TorchLM.tiny(device=device)
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6] * 3, [2, 7, 1, 8] * 5, [1, 2, 3],
               list(range(40, 90))]
    outs = []
    for graphs in (False, True):
        eng = GenerationEngine(
            model, cache_config=CacheConfig(
                num_layers=2, num_heads=2, head_dim=16, num_pages=64,
                page_size=8, max_slots=3, max_seq_len=128),
            scheduler_config=SchedulerConfig(
                max_slots=3, max_seq_len=128, chunk_tokens=16,
                async_depth=depth if graphs else 0, kv_split_pages=split),
            quant=QuantConfig(kv=kv), cuda_graphs=graphs)
        pa.LAUNCHES.clear()
        outs.append(eng.generate(prompts, 12))
        name = pa.kernel_name(eng.cache.k_pool.dtype, split > 0)
        assert dict(pa.LAUNCHES) == {name: 2 * eng.steps_dispatched}
        captured = sum(g is not None for g in eng._graphs.values())
        assert captured == (eng.xla_compiles if graphs else 0)
        assert 0 < eng.xla_compiles <= eng.graph_bound
        eng.cache.check_invariants()
        assert eng.cache.pages_in_use == 0 and eng.pipeline_depth == 0
    assert outs[0] == outs[1]


def _tiny_engine(device, depth, graphs=True, **sched):
    return GenerationEngine(
        TorchLM.tiny(device=device), cache_config=CacheConfig(
            num_layers=2, num_heads=2, head_dim=16, num_pages=64,
            page_size=8, max_slots=3, max_seq_len=128),
        scheduler_config=SchedulerConfig(
            max_slots=3, max_seq_len=128, chunk_tokens=16,
            async_depth=depth, **sched), cuda_graphs=graphs)


_PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6] * 3, [2, 7, 1, 8] * 5, [1, 2, 3],
            list(range(40, 90)), [5] * 30]


@pytest.mark.parametrize("depth", [0, 1])
def test_step_events_time_the_device(device, depth):
    """The step profiler's CUDA events around each step (graph replays
    included): one record per step call, a busy span for every step
    after the first, an idle share in [0, 1), and the sampled steps'
    spans in their records; tokens equal with observability off."""
    from paddle_tpu_torch import observability as obs

    eng = _tiny_engine(device, depth)
    on = eng.generate(_PROMPTS, 12)
    summ = eng.stepprof.summary()
    assert summ["commits"] == eng.steps_committed
    assert summ["gap_steps"] == eng.steps_dispatched - 1
    assert summ["gap_busy_s"] > 0 and 0 <= summ["idle_share"] < 1
    assert any(r.fenced and r.device_s > 0 for r in eng.stepprof.records())
    try:
        obs.disable()
        off_eng = _tiny_engine(device, depth)
        off = off_eng.generate(_PROMPTS, 12)
    finally:
        obs.enable()
    assert off == on and len(off_eng.stepprof) == 0


@pytest.mark.parametrize("depth", [1, 2])
def test_fault_boundary_with_graphs(device, depth):
    """Injected NaN rows through graph replays at async depths 1 and 2:
    the poisoned requests end device_fault after one recorded retry
    each (no re-run at depth > 0, as in the JAX engine), the others give
    the tokens of a clean run with graphs off, no page leaks. (At depth
    0 the retry runs the step again and draws again, as the JAX engine's
    does, and these rows survive it: the CPU tests hold that case to the
    JAX engine.)"""
    from paddle_tpu_torch.inference.llm import faults

    clean = _tiny_engine(device, 0, graphs=False).generate(_PROMPTS, 12)
    inj = faults.FaultInjector(faults.FaultConfig(nan_rate=0.04, seed=6))
    prev = faults.set_default_injector(inj)
    try:
        eng = _tiny_engine(device, depth)
    finally:
        faults.set_default_injector(prev)
    rids = [eng.submit(p, 12) for p in _PROMPTS]
    eng.run()
    reqs = [eng.scheduler.requests[r] for r in rids]
    hit = [r.finish_reason == "device_fault" for r in reqs]
    assert any(hit) and not all(hit)
    assert [r.output for r, h in zip(reqs, hit) if not h] == \
        [o for o, h in zip(clean, hit) if not h]
    assert eng.fault_retries["nan"] == inj.counts["nan"]
    eng.cache.check_invariants()
    assert eng.cache.pages_in_use == 0


# ------------------------------------------ the int8 matmul, narrow scales

from paddle_tpu_torch.inference.llm import (  # noqa: E402
    FabricConfig, ServingFabric)
from paddle_tpu_torch.kernels import int8 as i8  # noqa: E402


@pytest.mark.parametrize("M", [1, 7, 8, 16, 17, 64, 130])
@pytest.mark.parametrize("K,N", [(32, 96), (48, 40), (2048, 6144),
                                 (8192, 2048), (1040, 24)])
def test_int8_matmul_bit_equal(device, M, K, N):
    """The row quantizer and the int8 matmul against their plain
    versions: codes, scales and products bit-equal, at row counts
    around the 16-row tile and the decode/chunk switch, K a multiple of
    16 but not of 64, N not a multiple of the block; an all-zero row and
    a row with one huge value included."""
    g = torch.Generator(device=device).manual_seed(M * 7 + K + N)
    x = torch.randn(M, K, generator=g, device=device)
    x[0] = 0.0
    if M > 2:
        x[2, 3] = 1e4
    w = 0.02 * torch.randn(K, N, generator=g, device=device)
    wq, ws = i8.quantize_absmax(w, axis=0)
    wqt = wq.t().contiguous()
    pa.LAUNCHES.clear()
    xq, xs = i8.quantize_rows(x)
    out = i8.int8_matmul(xq, xs, wqt, ws)
    rq, rs = i8.quantize_rows_ref(x)
    ref = i8.int8_matmul_ref(xq, xs, wqt, ws)
    torch.cuda.synchronize()
    assert torch.equal(xq, rq) and torch.equal(xs, rs)
    assert torch.equal(out, ref)
    assert dict(pa.LAUNCHES) == {i8.QUANTIZE_ROWS_KERNEL: 1,
                                 i8.INT8_MATMUL_KERNEL: 1}


def test_int8_kernels_nan_row_and_refusals(device):
    x = torch.randn(5, 64, device=device)
    x[3, 9] = float("nan")
    w = 0.02 * torch.randn(64, 32, device=device)
    wq, ws = i8.quantize_absmax(w, axis=0)
    xq, xs = i8.quantize_rows(x)
    out = i8.int8_matmul(xq, xs, wq.t().contiguous(), ws)
    torch.cuda.synchronize()
    assert torch.isnan(xs[3]).all() and torch.isnan(out[3]).all()
    assert torch.isfinite(out[[0, 1, 2, 4]]).all()
    with pytest.raises(ValueError, match="multiple of 16"):
        i8.int8_matmul(xq[:, :40].contiguous(), xs,
                       wq.t().contiguous()[:, :40].contiguous(), ws)
    with pytest.raises(ValueError, match="contiguous"):
        i8.int8_matmul(xq, xs, wq.t(), ws)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("scale_dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("split", [0, 3])
@pytest.mark.parametrize("page,D", [(8, 32), (16, 64), (16, 128)])
def test_narrow_scale_kernels_match_plain(device, mode, scale_dtype, split,
                                          page, D):
    """The ragged pair over float16/bfloat16 scale pools: within 2e-5 of
    the plain version on the same narrow scales, padding exact 0, reruns
    bit-identical, launches under the narrow kernel's name."""
    pps = -(-640 // page)
    args, n_used = _mix(device, 4, D, page, EDGE_Q_LENS, EDGE_KV_LENS, pps,
                        7, seed=page + D + 3)
    args, scales = _quantized(args, mode)
    scales = {k: v.to(scale_dtype) for k, v in scales.items()}
    pa.LAUNCHES.clear()
    out = pa.ragged_attention(**args, max_q_len=max(EDGE_Q_LENS),
                              split_pages=split, **scales)
    again = pa.ragged_attention(**args, max_q_len=max(EDGE_Q_LENS),
                                split_pages=split, **scales)
    torch.cuda.synchronize()
    ref = pa.ragged_attention_ref_split(**args, split_pages=split, **scales)
    torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)
    assert (out[n_used:] == 0).all() and torch.equal(out, again)
    name = pa.kernel_name(args["k_pool"].dtype,
                          pa.split_active(split, pps), scale_dtype)
    assert dict(pa.LAUNCHES) == {name: 2}
    with pytest.raises(ValueError, match="one dtype"):
        pa.ragged_attention(**args, k_scale=scales["k_scale"],
                            v_scale=scales["v_scale"].float())


@pytest.mark.parametrize("sd", ["float32", "bfloat16"])
def test_weight_matmul_engine_graphs_and_launches(device, sd):
    """The engine with the int8 weight matmul: graphs on and off give the
    same tokens, the two int8 kernels launch four times a layer a step
    through the replays, and the narrow scale pool is stored narrow."""
    model = TorchLM.tiny(device=device)
    quant = QuantConfig(kv="int8", weights="int8", weight_matmul="int8",
                        scale_dtype=sd)
    outs = []
    for graphs in (False, True):
        eng = GenerationEngine(
            model, cache_config=CacheConfig(
                num_layers=2, num_heads=2, head_dim=16, num_pages=64,
                page_size=8, max_slots=3, max_seq_len=128),
            scheduler_config=SchedulerConfig(
                max_slots=3, max_seq_len=128, chunk_tokens=16,
                async_depth=1 if graphs else 0),
            quant=quant, cuda_graphs=graphs)
        assert eng.cache.k_scale.dtype == getattr(torch, sd)
        pa.LAUNCHES.clear()
        outs.append(eng.generate(_PROMPTS, 10))
        steps = eng.steps_dispatched
        got = dict(pa.LAUNCHES)
        assert got[i8.INT8_MATMUL_KERNEL] == 8 * steps
        assert got[i8.QUANTIZE_ROWS_KERNEL] == 8 * steps
        eng.cache.check_invariants()
    assert outs[0] == outs[1]


def test_fabric_kill_releases_the_replica(device):
    """A two-replica fabric on the card: outputs equal one engine's, and
    after a mid-run kill and respawn the card holds no more memory than
    before it by half a replica's pools (a corpse would add them all)."""
    model = TorchLM.tiny(device=device)
    cache = CacheConfig(num_layers=2, num_heads=2, head_dim=16,
                        num_pages=64, page_size=8, max_slots=3,
                        max_seq_len=128)
    sched = SchedulerConfig(max_slots=3, max_seq_len=128, chunk_tokens=16,
                            async_depth=1)
    quant = QuantConfig(kv="int8", weights="int8", weight_matmul="int8")
    one = GenerationEngine(model, cache_config=cache, scheduler_config=sched,
                           quant=quant)
    want = one.generate(_PROMPTS, 10)
    fab = ServingFabric(model, FabricConfig(replicas=2), cache_config=cache,
                        scheduler_config=sched, quant=quant)
    rids = [fab.submit(p, 10) for p in _PROMPTS]
    for _ in range(3):
        fab.step()
    pools = sum(t.numel() * t.element_size() for t in (
        fab.replicas[1].cache.k_pool, fab.replicas[1].cache.v_pool,
        fab.replicas[1].cache.k_scale, fab.replicas[1].cache.v_scale))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    fab.kill_replica(1)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() - before <= pools // 2
    fab.run()
    assert [fab.output_of(r) for r in rids] == want
    assert fab.pool_restored()


# ------------------------------------------------------------- dropout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape,mask_shape", [
    ((4, 33, 65), None),                 # not a multiple of the vector
    ((16, 128, 768), None),
    ((2, 3, 8, 8), (2, 3, 1, 1)),        # dropout2d's broadcast mask
    ((2, 3, 2, 4, 4), (2, 3, 1, 1, 1)),  # dropout3d's
    ((5, 7, 9), (1, 7, 1))])
@pytest.mark.parametrize("upscale", [True, False])
def test_dropout_kernel_is_its_plain_version(device, dtype, shape,
                                             mask_shape, upscale):
    """The dropout kernel gives its plain version's bits (threefry on
    int64 tensors) on the same key, forward and backward, and the
    kernel's wrapper counts one launch a call."""
    from paddle_tpu_torch.core import threefry
    from paddle_tpu_torch.kernels import dropout as dk

    g = torch.Generator(device=device).manual_seed(len(shape))
    x = torch.randn(*shape, generator=g, device=device).to(dtype)
    key = threefry.prng_key(1234 + len(shape))
    before = dk.LAUNCHES[dk.KERNEL_NAME]
    got = dk.dropout_cuda(x, key, 0.1, mask_shape, upscale)
    assert dk.LAUNCHES[dk.KERNEL_NAME] == before + 1
    want = dk.dropout_ref(x, key, 0.1, mask_shape, upscale)
    assert got.dtype == dtype
    bits = torch.int16 if dtype != torch.float32 else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))
    xr = x.clone().requires_grad_(True)
    y = dk.dropout(xr, key, 0.1, mask_shape, upscale)
    dy = torch.randn(*shape, generator=g, device=device).to(dtype)
    y.backward(dy)
    assert torch.equal(xr.grad, dk.dropout_ref(dy, key, 0.1, mask_shape,
                                               upscale))


def test_dropout_kernel_flat_slice_of_the_attention_shape(device):
    """At the attention-probability shape of bench.py's GPT, a stretch
    of flat indices past 2^27 against the plain version's slice, two
    runs with identical bits, and the kept share within 1e-3 of 1 - p."""
    from paddle_tpu_torch.core import threefry
    from paddle_tpu_torch.kernels import dropout as dk

    x = torch.rand(16, 12, 1024, 1024, device=device)
    key = threefry.prng_key(77)
    y = dk.dropout_cuda(x, key, 0.1)
    assert torch.equal(y, dk.dropout_cuda(x, key, 0.1))
    start, count = 150_000_000, 4_000_000
    part = dk.dropout_ref(x.view(-1)[start:start + count], key, 0.1,
                          start=start)
    assert torch.equal(y.view(-1)[start:start + count], part)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.9) < 1e-3


def test_dropout_kernel_refuses_what_it_does_not_take(device):
    from paddle_tpu_torch.core import threefry
    from paddle_tpu_torch.kernels import dropout as dk

    key = threefry.prng_key(0)
    with pytest.raises(ValueError):
        dk.dropout_cuda(torch.zeros(4, device=device, dtype=torch.float64),
                        key, 0.5)
    with pytest.raises(ValueError):
        dk.dropout_cuda(torch.zeros(4, 4, device=device).t(), key, 0.5)
    with pytest.raises(ValueError):
        dk.dropout_cuda(torch.zeros(4, device=device), key, 1.0)
