"""The float16 flash route against the JAX package's, on the CPU.

float16 is the third dtype of the flash kernels (AMP O2 float16
training reaches them). The port's ``flash_attention_bshd`` runs its
plain versions here (float16 rounding points: ``p`` cast to v's / dO's
dtype, ``dS`` to q's / k's, float32 sums) through the same
``torch.autograd.Function`` the card's float16 kernels sit in; the JAX
side runs its Pallas kernels in interpret mode on float16 inputs, as
``tests/test_flash_attention.py`` does for float32. Outputs and
gradients are held at 1e-2: both sides round p and dS to float16 (10
mantissa bits, a step of 2^-11 relative), against the blockwise running
max on the JAX side and the row's final max on the port's, and round the
result once more; lse is float32 from float32 sums (2e-4). The card
holds the float16 kernels to these plain versions
(``tests/test_torch_cuda_flash.py``, ``chip_smoke.py``).
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.kernels import flash_attention as jfa  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as fa  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

F16_TOL = 1e-2
LSE_TOL = 2e-4


def _inputs(B, Sq, Sk, H, D, seed, scale=0.3):
    rng = np.random.RandomState(seed)
    return [(rng.randn(B, S, H, D) * scale).astype(np.float16)
            for S in (Sq, Sk, Sk)]


@pytest.mark.parametrize("B,Sq,Sk,H,D,causal", [
    (1, 128, 128, 2, 64, True), (1, 256, 256, 1, 64, False),
    (1, 128, 256, 2, 64, True), (1, 128, 128, 1, 128, True)])
def test_f16_plain_versions_match_jax_flash(B, Sq, Sk, H, D, causal):
    arrays = _inputs(B, Sq, Sk, H, D, seed=Sq + D)
    q, k, v = (torch.tensor(a, requires_grad=True) for a in arrays)
    o = fa.flash_attention_bshd(q, k, v, causal=causal)
    assert o.dtype == torch.float16
    g = np.random.RandomState(1).randn(*o.shape).astype(np.float16)
    o.backward(torch.tensor(g))
    jq, jk, jv = (jnp.asarray(a) for a in arrays)
    jo, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention_bshd(
        q, k, v, causal=causal), jq, jk, jv)
    assert jo.dtype == jnp.float16
    np.testing.assert_allclose(o.detach().float().numpy(),
                               np.asarray(jo, np.float32), rtol=F16_TOL,
                               atol=F16_TOL)
    for name, t, w in zip("qkv", (q, k, v), vjp(jnp.asarray(g))):
        assert t.grad.dtype == torch.float16 and w.dtype == jnp.float16
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(w, np.float32), rtol=F16_TOL,
                                   atol=F16_TOL, err_msg=f"d{name}")


def test_f16_lse_matches_jax():
    arrays = _inputs(1, 128, 128, 2, 64, seed=3)
    qt, kt, vt = (torch.tensor(a).transpose(1, 2) for a in arrays)
    _, lse = fa.flash_fwd_ref(qt, kt, vt, 64 ** -0.5, True)
    jq, jk, jv = (jnp.swapaxes(jnp.asarray(a), 1, 2) for a in arrays)
    _, jlse = jfa._flash_fwd(jq, jk, jv, sm_scale=64 ** -0.5, causal=True,
                             block_q=128, block_k=128)
    np.testing.assert_allclose(lse.numpy().reshape(-1),
                               np.asarray(jlse, np.float32).reshape(-1),
                               rtol=LSE_TOL, atol=LSE_TOL)


@pytest.mark.parametrize("kernel,library", [
    ("fwd", "flash_fwd_f16"), ("bwd_dkdv", "flash_bwd_f16"),
    ("bwd_dq", "flash_bwd_f16")])
def test_f16_entry_loads_from_its_library(monkeypatch, kernel, library):
    """float16's C entries live in their own libraries, built from the
    16-bit sources the bf16 ones share."""
    from paddle_tpu_torch.kernels import _build

    class Entry:
        argtypes = None
        restype = None

    asked = []

    def load(name):
        asked.append(name)
        lib = type("Lib", (), {})()
        setattr(lib, f"flash_{kernel}_f16", Entry())
        return lib

    monkeypatch.setattr(_build, "load", load)
    fn = fa._entry(kernel, torch.float16)
    assert asked == [library]
    assert fn.argtypes[0] is ctypes.c_void_p and fn.restype is ctypes.c_int
    src = (_build.CSRC / f"{library}.cu").read_text()
    assert "#define FLASH_ELEM __half" in src


def test_f16_cuda_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 2, 128, 64, dtype=torch.float16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd_cuda(q, q, q, 0.125, True)
