"""The port's flash attention against the JAX package's, on the CPU.

The port's ``flash_attention_bshd`` runs its plain versions here (the
tensors lie on the CPU) through the same ``torch.autograd.Function``
the card's kernels sit in; the JAX side runs its Pallas kernels in
interpret mode, as ``tests/test_flash_attention.py`` does. The same
seeded numpy inputs go to both. Tolerances are the JAX package's own
for its kernels against ``sdpa_reference``: forward (and lse) at
rtol = atol = 2e-4, gradients at 5e-4 (float32). bf16 inputs are held
at 2e-2: both sides round p and dS to bf16 (8 mantissa bits, a step of
2^-8 = 3.9e-3 relative), the JAX kernel against a blockwise running
max and the port's plain version against the row's final max, so
single roundings may fall on either side of a bf16 step.
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from paddle_tpu.kernels import flash_attention as jfa  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.kernels.attention import sdpa_reference  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

FWD_TOL = 2e-4
GRAD_TOL = 5e-4
BF16_TOL = 2e-2

# (B, Sq, Sk, H, D, causal): equal lengths in two blocks, four blocks
# each way (S 512), Sq < Sk, Sq > Sk (leading rows see no key)
SHAPES = [(1, 256, 256, 2, 64, False), (1, 256, 256, 2, 64, True),
          (1, 512, 512, 1, 64, True), (1, 128, 256, 2, 64, True),
          (1, 384, 256, 2, 64, True), (2, 128, 128, 1, 128, False)]


def _inputs(B, Sq, Sk, H, D, seed, scale=0.3):
    rng = np.random.RandomState(seed)
    return [(rng.randn(B, S, H, D) * scale).astype(np.float32)
            for S in (Sq, Sk, Sk)]


def _torch(arrays, dtype=torch.float32):
    return [torch.tensor(a, dtype=dtype, requires_grad=True) for a in arrays]


def _jax(arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("B,Sq,Sk,H,D,causal", SHAPES)
def test_forward_matches_jax_flash_and_reference(B, Sq, Sk, H, D, causal):
    arrays = _inputs(B, Sq, Sk, H, D, seed=Sq + Sk)
    q, k, v = _torch(arrays)
    out = fa.flash_attention_bshd(q, k, v, causal=causal)
    want = jfa.flash_attention_bshd(*_jax(arrays), causal=causal)
    np.testing.assert_allclose(_np(out), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)
    ref = sdpa_reference(q, k, v, is_causal=causal)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=FWD_TOL, atol=FWD_TOL)
    assert not fa.LAUNCHES, "a CPU run launched a kernel"


@pytest.mark.parametrize("B,Sq,Sk,H,D,causal", SHAPES)
def test_grads_match_jax_flash(B, Sq, Sk, H, D, causal):
    arrays = _inputs(B, Sq, Sk, H, D, seed=1 + Sq)
    q, k, v = _torch(arrays)
    o = fa.flash_attention_bshd(q, k, v, causal=causal)
    (o * torch.cos(o)).sum().backward()

    def loss(q, k, v):
        o = jfa.flash_attention_bshd(q, k, v, causal=causal)
        return jnp.sum(o * jnp.cos(o))

    want = jax.grad(loss, argnums=(0, 1, 2))(*_jax(arrays))
    for name, t, w in zip("qkv", (q, k, v), want):
        np.testing.assert_allclose(_np(t.grad), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_lse_matches_jax(causal):
    B, Sq, Sk, H, D = 1, 256, 384, 2, 64
    arrays = [np.swapaxes(a, 1, 2)
              for a in _inputs(B, Sq, Sk, H, D, seed=5)]      # [B, H, S, D]
    scale = 1.0 / np.sqrt(D)
    o, lse = fa.flash_fwd_ref(*[torch.tensor(a) for a in arrays], scale,
                              causal)
    jo, jlse = jfa._flash_fwd(*_jax(arrays), scale, causal, 128, 128)
    assert lse.shape == (B, H, Sq, 1) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=FWD_TOL,
                               atol=FWD_TOL)


def test_rows_that_see_no_key_are_zero():
    B, Sq, Sk, H, D = 1, 384, 256, 2, 64
    q, k, v = [torch.tensor(np.swapaxes(a, 1, 2))
               for a in _inputs(B, Sq, Sk, H, D, seed=9)]
    o, lse = fa.flash_fwd_ref(q, k, v, 0.125, True)
    dead = Sq - Sk                       # query i sees key j <= i - 128
    assert torch.equal(o[:, :, :dead], torch.zeros_like(o[:, :, :dead]))
    assert torch.all(lse[:, :, :dead] == fa.NEG_INF)
    do = torch.randn_like(o)
    dq, dk, dv = fa.flash_bwd_ref(q, k, v, o, lse, do, 0.125, True)
    assert torch.equal(dq[:, :, :dead], torch.zeros_like(dq[:, :, :dead]))
    assert torch.isfinite(dk).all() and torch.isfinite(dv).all()


def test_rejects_ragged_seq():
    q = torch.zeros(1, 192, 1, 64)
    with pytest.raises(ValueError, match="divisible"):
        fa.flash_attention_bshd(q, q, q)


def test_kernel_tier_refuses_cpu_tensors():
    q = torch.zeros(1, 128, 1, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bshd(q, q, q, tier="kernel")
    with pytest.raises(ValueError, match="tier"):
        fa.flash_attention_bshd(q, q, q, tier="fast")


@pytest.mark.parametrize("kernel,dtype,library", [
    ("fwd", torch.float32, "flash_fwd_f32"),
    ("bwd_dkdv", torch.float32, "flash_bwd_f32"),
    ("bwd_dq", torch.float32, "flash_bwd_f32"),
    ("fwd", torch.bfloat16, "flash_fwd_bf16"),
    ("bwd_dkdv", torch.bfloat16, "flash_bwd_bf16"),
    ("bwd_dq", torch.bfloat16, "flash_bwd_bf16")])
def test_entry_loads_each_kernel_from_its_library(monkeypatch, kernel, dtype,
                                                  library):
    """``_entry`` asks ``_build.load`` for the library that holds the C
    entry ``flash_<kernel>_<dtype>`` and types its arguments: pointers
    and the stream as ``c_void_p``, so none is cut to 32 bits."""
    from paddle_tpu_torch.kernels import _build

    class Entry:
        argtypes = None
        restype = None

    asked = []

    def load(name):
        asked.append(name)
        lib = type("Lib", (), {})()
        setattr(lib, f"flash_{kernel}_{fa._SUFFIX[dtype]}", Entry())
        return lib

    monkeypatch.setattr(_build, "load", load)
    fn = fa._entry(kernel, dtype)
    assert asked == [library]
    n_ptr = {"fwd": 5, "bwd_dkdv": 8, "bwd_dq": 7}[kernel]
    assert fn.argtypes[:n_ptr + 1] == [ctypes.c_void_p] * (n_ptr + 1)
    assert fn.argtypes[-1] is ctypes.c_void_p and fn.restype is ctypes.c_int


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_matches_jax_flash(causal):
    B, S, H, D = 1, 256, 2, 64
    arrays = [a.astype(ml_dtypes.bfloat16).astype(np.float32)
              for a in _inputs(B, S, S, H, D, seed=11)]
    q, k, v = _torch(arrays, torch.bfloat16)
    o = fa.flash_attention_bshd(q, k, v, causal=causal)
    assert o.dtype == torch.bfloat16
    (o.float() ** 2).sum().backward()
    jq, jk, jv = _jax(arrays, jnp.bfloat16)
    jo = jfa.flash_attention_bshd(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(o), np.asarray(jo, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)
    want = jax.grad(lambda q, k, v: jnp.sum(jfa.flash_attention_bshd(
        q, k, v, causal=causal).astype(jnp.float32) ** 2),
        argnums=(0, 1, 2))(jq, jk, jv)
    for name, t, w in zip("qkv", (q, k, v), want):
        assert t.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(t.grad), np.asarray(w, np.float32),
                                   rtol=BF16_TOL, atol=BF16_TOL,
                                   err_msg=f"d{name}")
