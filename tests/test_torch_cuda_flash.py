"""The flash attention kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (with the reason) where no CUDA device
is present, and runs on a machine with the card::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_flash.py -q

The float32 kernels' card tests select with ``-k f32``::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_flash.py -q -k f32

Tolerances, kernel against plain version on the same inputs: float32
``o`` and ``lse`` at rtol = atol = 2e-5 (the JAX package's Pallas-tier
tolerance; the float32 forward's 3xTF32 products are held to its float64
version at the same 2e-5), ``dq``/``dk``/``dv`` at 1e-4 (sums of up to S
products of those; the float32 backward kernels' 3xTF32 products are
held to their float64 version at the same 1e-4); bf16 outputs and gradients at 2e-2
(both sides round p and dS to
bf16, a step of 3.9e-3 relative, the kernel against a running max and
the plain version against the row's final max), bf16 ``lse`` at 2e-5
(it is formed in float32 from the same float32 products); float16 (the
bf16 kernels' source built for ``.f16`` operands) at 1e-2, no looser
than bf16 (a step of 4.9e-4 relative, the same two rounding points), its
``lse`` at 2e-5. Two runs of a kernel give identical bits (no atomics).
The float16 tests select with ``-k f16``.
"""
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch.jit import TrainStep  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402
from paddle_tpu_torch.text.gpt import GPTConfig, GPTForCausalLM  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
LSE_TOL = 2e-5


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, B, H, Sq, Sk, D, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(B, H, S, D, generator=g, device=device).to(dtype)
            for S in (Sq, Sk, Sk, Sq)]


# (B, H, Sq, Sk, D, causal): whole tiles, a partial tile (S 96), Sq < Sk,
# Sq > Sk (leading rows see no key), head_dim 128
CASES = [(2, 3, 256, 256, 64, True), (2, 3, 256, 256, 64, False),
         (1, 2, 96, 96, 64, True), (1, 2, 128, 256, 64, True),
         (1, 2, 384, 256, 64, True), (2, 2, 256, 256, 128, True),
         (1, 2, 192, 320, 128, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Sq,Sk,D,causal", CASES)
def test_kernels_match_plain_versions(device, dtype, B, H, Sq, Sk, D, causal):
    q, k, v, do = _inputs(device, B, H, Sq, Sk, D, dtype, seed=Sq + D)
    scale = D ** -0.5
    fwd_tol, grad_tol = TOL[dtype]
    o, lse = fa.flash_fwd_cuda(q, k, v, scale, causal)
    ro, rlse = fa.flash_fwd_ref(q, k, v, scale, causal)
    torch.testing.assert_close(o.float(), ro.float(), rtol=fwd_tol,
                               atol=fwd_tol)
    torch.testing.assert_close(lse, rlse, rtol=LSE_TOL, atol=LSE_TOL)
    delta = fa.bwd_delta(o, do)
    dk, dv = fa.flash_bwd_dkdv_cuda(q, k, v, do, lse, delta, scale, causal)
    dq = fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal)
    rdk, rdv = fa.flash_bwd_dkdv_ref(q, k, v, do, lse, delta, scale, causal)
    rdq = fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, scale, causal)
    for name, got, want in (("dq", dq, rdq), ("dk", dk, rdk),
                            ("dv", dv, rdv)):
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=grad_tol,
                                   atol=grad_tol, msg=name)
    again = fa.flash_fwd_cuda(q, k, v, scale, causal)
    assert torch.equal(again[0], o) and torch.equal(again[1], lse)
    assert torch.equal(fa.flash_bwd_dkdv_cuda(q, k, v, do, lse, delta, scale,
                                              causal)[0], dk)
    assert torch.equal(fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale,
                                            causal), dq)
    if causal and Sq > Sk:
        dead = Sq - Sk
        assert o[:, :, :dead].abs().max().item() == 0.0
        assert dq[:, :, :dead].abs().max().item() == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_not_16_byte_aligned(device, dtype):
    """Rows whose stride is not a multiple of 16 bytes take the kernels'
    plain loads: the same bits as the 16-byte loads of the same values."""
    B, H, S, D = 1, 2, 192, 64
    g = torch.Generator(device=device).manual_seed(3)
    wide = [torch.randn(B, H, S, D + 1, generator=g, device=device).to(dtype)
            for _ in range(4)]
    odd = [t[..., :D] for t in wide]                 # row stride D + 1
    even = [t.contiguous() for t in odd]
    for causal in (True, False):
        outs = []
        for q, k, v, do in (odd, even):
            o, lse = fa.flash_fwd_cuda(q, k, v, 0.125, causal)
            delta = fa.bwd_delta(o, do)
            outs.append((o, lse) + fa.flash_bwd_dkdv_cuda(
                q, k, v, do, lse, delta, 0.125, causal) + (
                fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, 0.125,
                                     causal),))
        for a, b in zip(*outs):
            assert torch.equal(a, b)


# the bf16 forward (csrc/flash_fwd_bf16.cu) at lengths that are not whole
# tiles (its query tiles are 128 rows at D 64 and 64 at D 128, its key
# tiles 64): (Sq, Sk, D, causal)
BF16_FWD_CASES = [(1, 1, 64, True), (63, 63, 64, True), (65, 65, 64, False),
                  (200, 200, 64, True), (1000, 1000, 64, True),
                  (1000, 1000, 128, False), (65, 65, 128, True),
                  (63, 200, 64, True), (200, 63, 64, True),
                  (65, 1000, 128, True), (1000, 65, 64, False),
                  (1, 1000, 128, True), (1000, 1, 64, True),
                  (200, 1000, 64, False)]


@pytest.mark.parametrize("Sq,Sk,D,causal", BF16_FWD_CASES)
def test_bf16_forward_matches_plain_version(device, Sq, Sk, D, causal):
    """o at 2e-2 and lse at 2e-5 against the plain version; a row that
    sees no key (causal, Sq > Sk: the first Sq - Sk rows) exact 0 with
    lse NEG_INF; a rerun bit-identical; one launch a call."""
    q, k, v, _ = _inputs(device, 2, 3, Sq, Sk, D, torch.bfloat16,
                         seed=Sq * 7 + Sk + D)
    scale = D ** -0.5
    before = fa.LAUNCHES["flash_attention_fwd"]
    o, lse = fa.flash_fwd_cuda(q, k, v, scale, causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_fwd"] == before + 1
    ro, rlse = fa.flash_fwd_ref(q, k, v, scale, causal)
    torch.testing.assert_close(o.float(), ro.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse, rlse, rtol=LSE_TOL, atol=LSE_TOL)
    again = fa.flash_fwd_cuda(q, k, v, scale, causal)
    assert torch.equal(again[0], o) and torch.equal(again[1], lse)
    if causal and Sq > Sk:
        dead = Sq - Sk
        assert o[:, :, :dead].abs().max().item() == 0.0
        assert (lse[:, :, :dead] == fa.NEG_INF).all()


@pytest.mark.parametrize("D", [64, 128])
def test_bf16_forward_on_strided_bshd_views(device, D):
    """q, k, v sliced out of one packed bf16 ``[B, S, 3, H, D]``
    projection and read as ``[B, H, S, D]`` views: the same bits as on
    contiguous copies, within tolerance of the plain version, and o
    laid out ``[B, S, H, D]``."""
    B, S, H = 2, 300, 3
    g = torch.Generator(device=device).manual_seed(D)
    qkv = torch.randn(B, S, 3, H, D, generator=g,
                      device=device).to(torch.bfloat16)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(dim=2))
    o, lse = fa.flash_fwd_cuda(q, k, v, D ** -0.5, True)
    assert o.transpose(1, 2).is_contiguous()
    oc, lsec = fa.flash_fwd_cuda(q.contiguous(), k.contiguous(),
                                 v.contiguous(), D ** -0.5, True)
    assert torch.equal(o, oc) and torch.equal(lse, lsec)
    ro, rlse = fa.flash_fwd_ref(q, k, v, D ** -0.5, True)
    torch.testing.assert_close(o.float(), ro.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse, rlse, rtol=LSE_TOL, atol=LSE_TOL)


# the bf16 backward (csrc/flash_bwd_bf16.cu) at lengths that are not whole
# tiles (dK/dV blocks of 64 keys walking query tiles of 32, dQ blocks of 64
# rows walking key tiles of 64), Sq < Sk and Sq > Sk (the first Sq - Sk
# rows see no key when causal): (Sq, Sk, D, causal)
BF16_BWD_CASES = [(1, 1, 64, True), (63, 63, 64, True), (65, 65, 64, False),
                  (200, 200, 64, True), (1000, 1000, 64, True),
                  (1000, 1000, 128, False), (65, 65, 128, True),
                  (63, 200, 64, True), (200, 63, 64, True),
                  (65, 1000, 128, True), (1000, 65, 64, False),
                  (1, 1000, 128, True), (1000, 1, 64, True),
                  (200, 1000, 64, False), (1000, 200, 128, True),
                  (63, 65, 128, False)]


@pytest.mark.parametrize("Sq,Sk,D,causal", BF16_BWD_CASES)
def test_bf16_backward_matches_plain_versions(device, Sq, Sk, D, causal):
    """dq, dk and dv at 2e-2 against the plain versions on the same lse
    and delta; dq of a row that sees no key exact 0; a rerun
    bit-identical; each call one launch of its kernel."""
    q, k, v, do = _inputs(device, 2, 3, Sq, Sk, D, torch.bfloat16,
                          seed=Sq * 5 + Sk + D)
    scale = D ** -0.5
    o, lse = fa.flash_fwd_cuda(q, k, v, scale, causal)
    delta = fa.bwd_delta(o, do)
    names = ("flash_attention_bwd_dkdv", "flash_attention_bwd_dq")
    before = [fa.LAUNCHES[n] for n in names]
    dk, dv = fa.flash_bwd_dkdv_cuda(q, k, v, do, lse, delta, scale, causal)
    dq = fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal)
    torch.cuda.synchronize()
    assert [fa.LAUNCHES[n] for n in names] == [n + 1 for n in before]
    rdk, rdv = fa.flash_bwd_dkdv_ref(q, k, v, do, lse, delta, scale, causal)
    rdq = fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, scale, causal)
    for name, got, want in (("dq", dq, rdq), ("dk", dk, rdk),
                            ("dv", dv, rdv)):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2, msg=name)
    again = fa.flash_bwd_dkdv_cuda(q, k, v, do, lse, delta, scale, causal)
    assert torch.equal(again[0], dk) and torch.equal(again[1], dv)
    assert torch.equal(fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale,
                                            causal), dq)
    if causal and Sq > Sk:
        assert dq[:, :, :Sq - Sk].abs().max().item() == 0.0


def _packed_autograd_bits(device, D, dtype, seed):
    """The bshd entry on q, k, v sliced out of one packed ``[B, S, 3, H,
    D]`` projection (read in place as strided views) against the same
    call on contiguous copies: the output and the packed gradient
    bit-equal, each kernel launched once a call."""
    B, S, H = 2, 320, 3
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(B, S, 3, H, D, generator=g, device=device).to(dtype)
    do = torch.randn(B, S, H, D, generator=g, device=device).to(dtype)
    outs = []
    for packed in (True, False):
        x = qkv.clone().requires_grad_(True)
        q, k, v = x.unbind(dim=2)
        if not packed:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        before = dict(fa.LAUNCHES)
        o = fa.flash_attention_bshd(q, k, v, causal=True, block_q=64,
                                    block_k=64)
        o.backward(do)
        torch.cuda.synchronize()
        assert {n: fa.LAUNCHES[n] - before.get(n, 0)
                for n in fa.KERNEL_NAMES} == {n: 1 for n in fa.KERNEL_NAMES}
        outs.append((o.detach(), x.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("D", [64, 128])
def test_bf16_autograd_on_strided_bshd_views(device, D):
    _packed_autograd_bits(device, D, torch.bfloat16, seed=D + 1)


@pytest.mark.parametrize("Sq,Sk,D,causal", BF16_BWD_CASES)
def test_f32_backward_matches_plain_and_float64(device, Sq, Sk, D, causal):
    """The float32 backward (csrc/flash_bwd_f32.cu, 3xTF32 on the tensor
    cores) at the bf16 backward's edge lengths: dq, dk and dv at 1e-4
    against the plain versions and against the same arithmetic in
    float64 on the same lse and delta; dq of a row that sees no key
    exact 0; a rerun bit-identical; each call one launch."""
    import chip_smoke

    q, k, v, do = _inputs(device, 2, 3, Sq, Sk, D, torch.float32,
                          seed=Sq * 3 + Sk + D)
    scale = D ** -0.5
    o, lse = fa.flash_fwd_cuda(q, k, v, scale, causal)
    delta = fa.bwd_delta(o, do)
    names = ("flash_attention_bwd_dkdv", "flash_attention_bwd_dq")
    before = [fa.LAUNCHES[n] for n in names]
    dk, dv = fa.flash_bwd_dkdv_cuda(q, k, v, do, lse, delta, scale, causal)
    dq = fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal)
    torch.cuda.synchronize()
    assert [fa.LAUNCHES[n] for n in names] == [n + 1 for n in before]
    rdk, rdv = fa.flash_bwd_dkdv_ref(q, k, v, do, lse, delta, scale, causal)
    rdq = fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, scale, causal)
    wdq, wdk, wdv = chip_smoke.flash_bwd_f64(q, k, v, do, lse, delta, scale,
                                             causal)
    for name, got, want, exact in (("dq", dq, rdq, wdq), ("dk", dk, rdk, wdk),
                                   ("dv", dv, rdv, wdv)):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4, msg=name)
        torch.testing.assert_close(got.double(), exact, rtol=1e-4, atol=1e-4,
                                   msg=name)
    again = fa.flash_bwd_dkdv_cuda(q, k, v, do, lse, delta, scale, causal)
    assert torch.equal(again[0], dk) and torch.equal(again[1], dv)
    assert torch.equal(fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale,
                                            causal), dq)
    if causal and Sq > Sk:
        assert dq[:, :, :Sq - Sk].abs().max().item() == 0.0


@pytest.mark.parametrize("Sq,Sk,D,causal", BF16_BWD_CASES)
def test_f32_forward_matches_plain_and_float64(device, Sq, Sk, D, causal):
    """The float32 forward (csrc/flash_fwd_f32.cu, 3xTF32 on the tensor
    cores) at the bf16 backward's edge lengths: o and lse at 2e-5 against
    the plain version and against the same arithmetic in float64; a row
    that sees no key exact 0 with lse NEG_INF; a rerun bit-identical; one
    launch a call."""
    import chip_smoke

    q, k, v, _ = _inputs(device, 2, 3, Sq, Sk, D, torch.float32,
                         seed=Sq * 11 + Sk + D)
    scale = D ** -0.5
    before = fa.LAUNCHES["flash_attention_fwd"]
    o, lse = fa.flash_fwd_cuda(q, k, v, scale, causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_fwd"] == before + 1
    assert o.dtype == torch.float32 and lse.shape == (2, 3, Sq, 1)
    ro, rlse = fa.flash_fwd_ref(q, k, v, scale, causal)
    wo, wlse = chip_smoke.flash_fwd_f64(q, k, v, scale, causal)
    for name, got, want, exact in (("o", o, ro, wo), ("lse", lse, rlse, wlse)):
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5, msg=name)
        torch.testing.assert_close(got.double(), exact, rtol=2e-5, atol=2e-5,
                                   msg=name)
    again = fa.flash_fwd_cuda(q, k, v, scale, causal)
    assert torch.equal(again[0], o) and torch.equal(again[1], lse)
    if causal and Sq > Sk:
        dead = Sq - Sk
        assert o[:, :, :dead].abs().max().item() == 0.0
        assert (lse[:, :, :dead] == fa.NEG_INF).all()


@pytest.mark.parametrize("D", [64, 128])
def test_f32_forward_on_strided_bshd_views(device, D):
    """q, k, v sliced out of one packed float32 ``[B, S, 3, H, D]``
    projection and read as ``[B, H, S, D]`` views: the same bits as on
    contiguous copies, within 2e-5 of the plain version, and o laid out
    ``[B, S, H, D]``."""
    B, S, H = 2, 300, 3
    g = torch.Generator(device=device).manual_seed(D + 3)
    qkv = torch.randn(B, S, 3, H, D, generator=g, device=device)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(dim=2))
    o, lse = fa.flash_fwd_cuda(q, k, v, D ** -0.5, True)
    assert o.transpose(1, 2).is_contiguous()
    oc, lsec = fa.flash_fwd_cuda(q.contiguous(), k.contiguous(),
                                 v.contiguous(), D ** -0.5, True)
    assert torch.equal(o, oc) and torch.equal(lse, lsec)
    ro, rlse = fa.flash_fwd_ref(q, k, v, D ** -0.5, True)
    torch.testing.assert_close(o, ro, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse, rlse, rtol=LSE_TOL, atol=LSE_TOL)


def test_f32_forward_ignores_the_tf32_flag(device):
    """The float32 forward is 3xTF32 whatever PyTorch's TF32 flag says:
    the same bits with ``allow_tf32`` on and off."""
    q, k, v, _ = _inputs(device, 2, 3, 256, 256, 64, torch.float32, seed=6)
    outs = []
    for flag in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = flag
        outs.append(fa.flash_fwd_cuda(q, k, v, 0.125, True))
    torch.backends.cuda.matmul.allow_tf32 = False
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.parametrize("D", [64, 128])
def test_f32_autograd_on_strided_bshd_views(device, D):
    _packed_autograd_bits(device, D, torch.float32, seed=D + 2)


def test_f32_backward_ignores_the_tf32_flag(device):
    """The float32 backward is 3xTF32 whatever PyTorch's TF32 flag says:
    the same bits with ``allow_tf32`` on and off."""
    q, k, v, do = _inputs(device, 2, 3, 256, 256, 64, torch.float32, seed=5)
    o, lse = fa.flash_fwd_cuda(q, k, v, 0.125, True)
    delta = fa.bwd_delta(o, do)
    outs = []
    for flag in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = flag
        outs.append(fa.flash_bwd_dkdv_cuda(q, k, v, do, lse, delta, 0.125, True)
                    + (fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, 0.125,
                                            True),))
    torch.backends.cuda.matmul.allow_tf32 = False
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_autograd_on_strided_bshd_views(device):
    """The bshd entry on q, k, v sliced out of one packed projection (as
    the GPT attention does): the kernels read the strided views in
    place; values and grads equal the plain route's within tolerance."""
    B, S, H, D = 2, 256, 4, 64
    g = torch.Generator(device=device).manual_seed(0)
    qkv = torch.randn(B, S, 3, H, D, generator=g, device=device)
    outs = {}
    for tier in ("kernel", "ref"):
        x = qkv.clone().requires_grad_(True)
        q, k, v = x.unbind(dim=2)
        before = dict(fa.LAUNCHES)
        o = fa.flash_attention_bshd(q, k, v, causal=True, tier=tier)
        (o * torch.cos(o)).sum().backward()
        launched = {n: fa.LAUNCHES[n] - before.get(n, 0)
                    for n in fa.KERNEL_NAMES}
        outs[tier] = (o.detach(), x.grad, launched)
    assert outs["kernel"][2] == {n: 1 for n in fa.KERNEL_NAMES}
    assert outs["ref"][2] == {n: 0 for n in fa.KERNEL_NAMES}
    assert outs["kernel"][0].is_contiguous()
    torch.testing.assert_close(outs["kernel"][0], outs["ref"][0], rtol=2e-5,
                               atol=2e-5)
    torch.testing.assert_close(outs["kernel"][1], outs["ref"][1], rtol=1e-4,
                               atol=1e-4)


def test_kernels_refuse_what_they_do_not_take(device):
    q = torch.zeros(1, 2, 128, 32, device=device)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd_cuda(q, q, q, 1.0, True)
    # float16 is taken now (the third dtype); float64 is still refused
    h = torch.zeros(1, 2, 128, 64, device=device, dtype=torch.float64)
    with pytest.raises(ValueError):
        fa.flash_fwd_cuda(h, h, h, 1.0, True)
    q = torch.zeros(1, 2, 128, 64, device=device)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd_cuda(q, q.cpu(), q, 1.0, True)


def test_gpt_train_step_on_card(device):
    """A small GPT trains two TrainStep calls of two steps on the card:
    each flash kernel launches once per layer per step, the losses are
    finite and equal the plain attention route's at 1e-4 relative."""
    cfg = dict(vocab_size=512, hidden_size=256, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=512,
               max_position_embeddings=256, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0, loss_chunks=4)
    ids = torch.randint(0, 512, (2, 2, 4, 256), device=device,
                        generator=torch.Generator(device=device).manual_seed(1))
    losses = {}
    for tier in ("auto", "ref"):
        model = GPTForCausalLM(GPTConfig(**cfg, attn_tier=tier), device=device)
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
        step = TrainStep(model, lambda n, x, y: n.loss(x, y), opt,
                         steps_per_call=2)
        fa.LAUNCHES.clear()
        losses[tier] = torch.cat([step(x, x) for x in ids])
        torch.cuda.synchronize()
        want = cfg["num_hidden_layers"] * 4 if tier == "auto" else 0
        assert dict(fa.LAUNCHES) == ({n: want for n in fa.KERNEL_NAMES}
                                     if want else {})
    assert torch.isfinite(losses["auto"]).all()
    torch.testing.assert_close(losses["auto"], losses["ref"], rtol=1e-4,
                               atol=0)


F16_TOL = 1e-2


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal", CASES)
def test_f16_kernels_match_plain_versions(device, B, H, Sq, Sk, D, causal):
    """The float16 forward, dK/dV and dQ kernels against their plain
    versions (float16 rounding points), bit-identical reruns."""
    q, k, v, do = _inputs(device, B, H, Sq, Sk, D, torch.float16,
                          seed=Sq + D + 1)
    scale = D ** -0.5
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_fwd_cuda(q, k, v, scale, causal)
    ro, rlse = fa.flash_fwd_ref(q, k, v, scale, causal)
    assert o.dtype == torch.float16
    torch.testing.assert_close(o.float(), ro.float(), rtol=F16_TOL,
                               atol=F16_TOL)
    torch.testing.assert_close(lse, rlse, rtol=LSE_TOL, atol=LSE_TOL)
    delta = fa.bwd_delta(o, do)
    dk, dv = fa.flash_bwd_dkdv_cuda(q, k, v, do, lse, delta, scale, causal)
    dq = fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal)
    rdk, rdv = fa.flash_bwd_dkdv_ref(q, k, v, do, lse, delta, scale, causal)
    rdq = fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, scale, causal)
    for name, got, want in (("dq", dq, rdq), ("dk", dk, rdk),
                            ("dv", dv, rdv)):
        assert got.dtype == torch.float16
        torch.testing.assert_close(got.float(), want.float(), rtol=F16_TOL,
                                   atol=F16_TOL, msg=name)
    assert all(fa.LAUNCHES[n] == before.get(n, 0) + 1
               for n in fa.KERNEL_NAMES)
    again = fa.flash_fwd_cuda(q, k, v, scale, causal)
    assert torch.equal(again[0], o) and torch.equal(again[1], lse)
    assert torch.equal(fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale,
                                            causal), dq)


@pytest.mark.parametrize("Sq,Sk,D,causal", [(63, 63, 64, True),
                                            (200, 1000, 64, False),
                                            (1000, 65, 128, True)])
def test_f16_partial_tiles_match_plain_versions(device, Sq, Sk, D, causal):
    q, k, v, do = _inputs(device, 1, 2, Sq, Sk, D, torch.float16, seed=Sq)
    o = fa.flash_attention_bhsd(q, k, v, causal=causal, block_q=Sq,
                                block_k=Sk)
    ro, _ = fa.flash_fwd_ref(q, k, v, D ** -0.5, causal)
    torch.testing.assert_close(o.float(), ro.float(), rtol=F16_TOL,
                               atol=F16_TOL)


def test_f16_gpt_scaler_steps_on_card(device):
    """A small GPT in AMP O2 float16 with a GradScaler whose first scale
    overflows: each float16 flash kernel launches once per layer per
    step, the overflowed steps leave the parameters bit-unchanged and
    halve the scale, later losses are finite."""
    from paddle_tpu_torch.amp import GradScaler, decorate

    cfg = dict(vocab_size=512, hidden_size=256, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=512,
               max_position_embeddings=256, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0)
    model = GPTForCausalLM(GPTConfig(**cfg), device=device)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    model, opt = decorate(model, opt, level="O2", dtype="float16")
    scaler = GradScaler(init_loss_scaling=2.0 ** 40,
                        decr_every_n_nan_or_inf=1)
    ids = torch.randint(0, 512, (6, 4, 256), device=device,
                        generator=torch.Generator(device=device).manual_seed(2))
    fa.LAUNCHES.clear()
    skipped, losses = 0, []
    for x in ids:
        before = [p.detach().clone() for p in model.parameters()]
        loss = model.loss(x, x)
        scaler.scale(loss).backward()
        scaler.unscale_(opt)
        found = scaler._found_inf
        scaler.step(opt)
        opt.clear_grad()
        if found:
            skipped += 1
            assert all(torch.equal(a, p) for a, p in
                       zip(before, model.parameters()))
        losses.append(loss.float().item())
    assert skipped >= 1 and scaler._scale < 2.0 ** 40
    assert all(map(lambda v: v == v and abs(v) < 1e4, losses[-2:]))
    assert dict(fa.LAUNCHES) == {n: 2 * 6 for n in fa.KERNEL_NAMES}
