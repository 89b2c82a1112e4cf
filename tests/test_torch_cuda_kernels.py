"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (with the reason) where no CUDA device
is present, and runs on a machine with the card::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

Imports no JAX (``--noconftest`` skips ``tests/conftest.py``, which
does), so it runs where only PyTorch is installed.
"""
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
