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
