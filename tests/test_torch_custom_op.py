"""The port's custom ops against the JAX package's, on the CPU.

- ``custom_op`` with torch's autodiff and with a custom backward against
  the JAX ``custom_op`` on the same seeded inputs: outputs and gradients
  at rtol = 1e-6 (float32; the programs of ``tests/test_extensions.py``,
  whose results are exact, are checked exactly);
- ``cuda_op`` on CPU tensors runs its ``reference``, held bit-equal to
  the JAX ``pallas_op`` run in interpret mode (the kernels multiply and
  add in float32, which rounds the same on both sides); its registry
  entry, the ``torch.library`` op and the fake implementation's shapes
  (meta tensors and ``FakeTensorMode``), ``Tensor`` in and out, and the
  checks made before any build: the kernel's signature, the launch
  contract, the dtypes and contiguity a launch needs.

The kernels themselves run only on the card:
``tests/test_torch_cuda_custom_op.py``.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jp  # noqa: E402
from paddle_tpu.utils import custom_op as jcustom_op  # noqa: E402
from paddle_tpu.utils import pallas_op  # noqa: E402

import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.core.dispatch import get_op  # noqa: E402
from paddle_tpu_torch.core.tensor import Tensor  # noqa: E402
from paddle_tpu_torch.utils import (ShapeDtypeStruct, cuda_op,  # noqa: E402
                                    custom_op)
from _torch_threads import one_thread  # noqa: E402,F401

co = sys.modules["paddle_tpu_torch.utils.custom_op"]
ROOT = Path(__file__).resolve().parent.parent
TRIPLE = (ROOT / "paddle_tpu_torch/utils/csrc/my_triple.cu").read_text()
ADD_SRC = """
__global__ void my_add(const float* x, const float* y, float* o, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] + y[i];
}
"""
RTOL = 1e-6


@pytest.fixture(autouse=True)
def cpu():
    saved = tdevice._CURRENT[0]
    tp.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


def _same(shape, seed):
    a = np.random.RandomState(seed).randn(*shape).astype("float32")
    jt, tt = jp.to_tensor(a), tp.to_tensor(a)
    jt.stop_gradient = tt.stop_gradient = False
    return jt, tt


def test_custom_op_autodiff_programs_of_the_extension_tests():
    @custom_op("my_square_plus")
    def my_square_plus(x, bias=0.0):
        return x * x + bias

    t = tp.to_tensor(np.array([1.0, 2.0, 3.0], "float32"))
    t.stop_gradient = False
    out = my_square_plus(t, bias=1.0)
    np.testing.assert_array_equal(out.numpy(), [2.0, 5.0, 10.0])
    out.sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), [2.0, 4.0, 6.0])
    assert get_op("my_square_plus").fn is not None


def test_custom_backward_program_of_the_extension_tests():
    my_relu = custom_op("my_relu_custom",
                        lambda x: (torch.clamp(x, min=0), (x,)),
                        backward=lambda res, g: (g * (res[0] > 0) * 10.0,))
    t = tp.to_tensor(np.array([-1.0, 2.0], "float32"))
    t.stop_gradient = False
    my_relu(t).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), [0.0, 10.0])


def test_custom_op_autodiff_matches_jax():
    jop = jcustom_op("cmp_gelu_tanh")(
        lambda x, k=1.0: 0.5 * x * (1 + jnp.tanh(0.79788456 * k * (
            x + 0.044715 * x ** 3))))
    top = custom_op("cmp_gelu_tanh")(
        lambda x, k=1.0: 0.5 * x * (1 + torch.tanh(0.79788456 * k * (
            x + 0.044715 * x ** 3))))
    jx, tx = _same((5, 7), 0)
    jy, ty = jop(jx, k=0.9), top(tx, k=0.9)
    (jy * jy).sum().backward()
    (ty * ty).sum().backward()
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy.numpy()),
                               rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad.numpy()),
                               rtol=RTOL, atol=1e-7)


def test_custom_backward_matches_jax_with_two_inputs():
    """``fwd`` returns a residual tuple of tensors and a Python number;
    the backward's gradients are deliberately not the true ones."""
    def jfwd(x, w):
        return x * w * 0.5, (x, w, 0.5)

    def jbwd(res, g):
        x, w, scale = res
        return g * w * 2.0 * scale, g * x * 3.0

    jop = jcustom_op("cmp_scaled_mul", jfwd, backward=jbwd)
    top = custom_op("cmp_scaled_mul", jfwd, backward=jbwd)
    (jx, tx), (jw, tw) = _same((4, 3), 1), _same((4, 3), 2)
    jop(jx, jw).sum().backward()
    out = top(tx, tw)
    out.sum().backward()
    assert isinstance(out, Tensor)
    for a, b in ((jx, tx), (jw, tw)):
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(a.grad.numpy()),
                                   rtol=RTOL, atol=1e-7)


def _triple(name="my_triple", reference=lambda x: x * 3.0):
    return cuda_op(name, TRIPLE, "my_triple",
                   out_shape_fn=lambda x: ShapeDtypeStruct(x.shape, x.dtype),
                   reference=reference)


def _jax_triple():
    def kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 3.0

    return pallas_op("my_triple", kernel,
                     out_shape_fn=lambda x: jax.ShapeDtypeStruct(x.shape,
                                                                 x.dtype),
                     interpret=True)


@pytest.mark.parametrize("shape", [(4, 8), (37, 5), (3,)])
def test_cuda_op_on_the_cpu_equals_pallas_interpret(shape):
    a = np.random.RandomState(len(shape)).randn(*shape).astype("float32")
    want = np.asarray(_jax_triple()(jp.to_tensor(a)).numpy())
    got = _triple()(tp.to_tensor(a))
    assert isinstance(got, Tensor) and got.stop_gradient
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(_triple()(tp.ones([4, 8])).numpy(),
                                  3 * np.ones((4, 8)))


def test_two_input_cuda_op_equals_pallas_interpret():
    def kernel(x_ref, y_ref, o_ref):
        o_ref[...] = x_ref[...] + y_ref[...]

    jadd = pallas_op("my_add", kernel, out_shape_fn=lambda x, y:
                     jax.ShapeDtypeStruct(x.shape, x.dtype), interpret=True)
    tadd = cuda_op("my_add", ADD_SRC, "my_add",
                   lambda x, y: ShapeDtypeStruct(x.shape, "float32"),
                   reference=lambda x, y: x + y)
    (ja, ta), (jb, tb) = _same((6, 10), 3), _same((6, 10), 4)
    np.testing.assert_array_equal(tadd(ta.detach(), tb.detach()).numpy(),
                                  np.asarray(jadd(ja, jb).numpy()))


def test_cuda_op_registry_and_fake_shapes():
    op = _triple()
    assert get_op("my_triple") is op.op
    assert not op.op.differentiable
    lib = torch.ops.paddle_tpu.my_triple
    (meta,) = lib([torch.empty(4, 8, device="meta")])
    assert meta.shape == (4, 8) and meta.device.type == "meta"
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        (fake,) = lib([mode.from_tensor(torch.empty(3, 5))])
        assert fake.shape == (3, 5) and fake.dtype == torch.float32

    def two(x):
        return [ShapeDtypeStruct((x.shape[0],), "int32"),
                ShapeDtypeStruct((2, *x.shape), x.dtype)]

    cuda_op("my_two_out", "__global__ void k(const float* x, int* a, "
            "float* b, int64_t n) {}", "k", two)
    a, b = torch.ops.paddle_tpu.my_two_out([torch.empty(7, 3,
                                                        device="meta")])
    assert (a.shape, a.dtype, b.shape) == ((7,), torch.int32, (2, 7, 3))


def test_cuda_op_gradient_stops_as_in_jax():
    x = tp.to_tensor([1.0, 2.0])
    x.stop_gradient = False
    y = _triple()(x)
    assert y.stop_gradient


def test_cuda_op_without_reference_raises_on_the_cpu():
    op = cuda_op("my_triple_noref", TRIPLE, "my_triple",
                 lambda x: ShapeDtypeStruct(x.shape, x.dtype))
    with pytest.raises(RuntimeError, match="no reference"):
        op(tp.ones([2]))


def test_cuda_op_reference_is_held_to_the_declared_output():
    op = _triple("my_triple_badref", reference=lambda x: (x * 3.0).double())
    with pytest.raises(RuntimeError, match="declares"):
        op(tp.ones([2]))


@pytest.mark.parametrize("source,kernel,match", [
    (TRIPLE, "missing", "no `__global__ void missing"),
    ("__global__ void k(const float* x, float* o, int n) {}", "k",
     "int64_t element count"),
    ("__global__ void k(float x, float* o, int64_t n) {}", "k",
     "not a pointer"),
    ("__global__ void k(const float4* x, float* o, int64_t n) {}", "k",
     "element type 'float4'"),
    ("__global__ void k(int64_t n) {}", "k", "takes no pointers")])
def test_cuda_op_refuses_a_kernel_it_cannot_launch(source, kernel, match):
    with pytest.raises(ValueError, match=match):
        cuda_op("my_refused", source, kernel,
                lambda x: ShapeDtypeStruct(x.shape, x.dtype))


def test_kernel_signature_and_launcher():
    src = ("__global__ void __launch_bounds__(128) k(const __nv_bfloat16* "
           "__restrict__ a, const int64_t* idx, unsigned char *m, float* "
           "const o, const int64_t n) {}")
    assert co.kernel_pointer_dtypes(src, "k") == [
        torch.bfloat16, torch.int64, torch.uint8, torch.float32]
    text = co.launcher_source(TRIPLE, "my_triple", 2)
    assert text.startswith(TRIPLE)
    assert 'extern "C" int paddle_tpu_cuda_op_launch' in text
    assert "paddle_tpu_launch_(my_triple," in text
    assert "ptrs[0], ptrs[1], (int64_t)n" in text
    assert _triple().source == text


def test_launch_checks_before_any_build():
    spec = co._CUDA_OPS["my_add"] if "my_add" in co._CUDA_OPS else None
    if spec is None:
        cuda_op("my_add", ADD_SRC, "my_add",
                lambda x, y: ShapeDtypeStruct(x.shape, "float32"))
        spec = co._CUDA_OPS["my_add"]
    f32 = torch.ones(4, 4)
    out = [((4, 4), torch.float32)]
    spec._check([f32, f32], out)
    with pytest.raises(ValueError, match="2 inputs and 2 outputs"):
        spec._check([f32, f32], out * 2)
    with pytest.raises(ValueError, match="input 1 is torch.float64"):
        spec._check([f32, f32.double()], out)
    with pytest.raises(ValueError, match="not contiguous"):
        spec._check([f32, f32.t()], out)
    with pytest.raises(ValueError, match="output 0 is declared"):
        spec._check([f32, f32], [((4, 4), torch.bfloat16)])
