"""The port's ``cuda_op`` user kernels and the Paddle-API core on the card.

Marked ``cuda``: each test skips (with the reason) where no CUDA device
is present, and runs on a machine with the card::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_custom_op.py -q

Imports no JAX, so it runs where only PyTorch is installed.

- ``my_triple`` (the JAX package's user kernel, CUDA C++) bit-equal to
  ``x * 3.0`` at sizes that leave a float4 tail, with its default grid
  and with a capped grid-stride grid; reruns bit-identical; one launch
  counted per call; on contiguous views at 4-, 8- and 12-byte offsets
  (not 16-byte aligned, so the kernel takes its one-float path); and at
  sizes that are not multiples of 4 and at every offset, under the
  default grid, under ``chip_smoke.triple_grid`` (two float4 a thread,
  one pass) and under that grid cut to one block an SM (several passes
  of the grid-stride loop);
- a two-input kernel and a kernel with a bf16 input;
- a source that does not compile raises at the first call, and a
  dtype that does not match the kernel raises before any build;
- resnet18 float32 on the card (TF32 off) against the port's CPU path:
  logits at 1e-4 of their scale, gradients at 1e-3 of each tensor's;
  and two Momentum steps in float64 on both: losses, gradients, updates
  and running statistics at 1e-6 of each tensor's largest value.
"""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import paddle_tpu_torch as paddle  # noqa: E402
import paddle_tpu_torch.nn.functional as PF  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.utils import ShapeDtypeStruct, cuda_op  # noqa: E402
from paddle_tpu_torch.vision.models import resnet18  # noqa: E402

pytestmark = pytest.mark.cuda

co = sys.modules["paddle_tpu_torch.utils.custom_op"]
ROOT = Path(__file__).resolve().parent.parent
TRIPLE = (ROOT / "paddle_tpu_torch/utils/csrc/my_triple.cu").read_text()


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    saved = tdevice._CURRENT[0]
    paddle.set_device("gpu")
    yield torch.device("cuda")
    tdevice._CURRENT[0] = saved


def _same(shape):
    return lambda *xs: ShapeDtypeStruct(shape(xs[0]), xs[0].dtype)


@pytest.mark.parametrize("shape", [(4, 8), (1001, 37), (3,), (4099, 4099)])
@pytest.mark.parametrize("capped", [False, True])
def test_my_triple_is_bit_equal_to_its_plain_version(device, shape, capped):
    grid = (lambda x: (min(-(-x.numel() // 1024), 64),)) if capped else None
    op = cuda_op("my_triple", TRIPLE, "my_triple", _same(lambda x: x.shape),
                 grid_fn=grid, reference=lambda x: x * 3.0)
    x = paddle.randn(list(shape))
    before = co.LAUNCHES.get("my_triple", 0)
    y = op(x)
    torch.cuda.synchronize()
    assert co.LAUNCHES["my_triple"] == before + 1
    assert isinstance(y, paddle.Tensor) and y.device == x.device
    assert torch.equal(y, x * 3.0)
    assert torch.equal(op(x), y)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_my_triple_on_a_view_at_an_offset(device, offset):
    op = cuda_op("my_triple", TRIPLE, "my_triple", _same(lambda x: x.shape),
                 reference=lambda x: x * 3.0)
    x = paddle.randn([4099 * 5])[offset:]
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    y = op(x)
    torch.cuda.synchronize()
    assert torch.equal(y, x * 3.0)


@pytest.mark.parametrize("n", [3, 4099 * 4099, 132 * 8 * 256 * 16 + 5,
                               8192 * 8192 + 2])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("grid", ["default", "triple_grid", "capped"])
def test_my_triple_at_odd_sizes_and_offsets(device, n, offset, grid):
    """Bit-equal to ``x * 3.0`` where n is not a multiple of 4 (a scalar
    tail after the float4s), at 0-, 4-, 8- and 12-byte offsets, with the
    grid-stride loop's passes of two float4 whole or cut short by the
    grid: ``cuda_op``'s default grid (one block per 256 elements),
    ``chip_smoke.triple_grid`` (its blocks of 128 threads) and that grid
    cut to 132 blocks."""
    import chip_smoke

    grid_fn = {"default": None, "triple_grid": chip_smoke.triple_grid,
               "capped": lambda x: (min(chip_smoke.triple_grid(x)[0],
                                        132),)}[grid]
    op = cuda_op("my_triple", TRIPLE, "my_triple", _same(lambda x: x.shape),
                 grid_fn=grid_fn, block=256 if grid == "default" else
                 chip_smoke.TRIPLE_BLOCK, reference=lambda x: x * 3.0)
    x = paddle.randn([n + offset])[offset:]
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    y = op(x)
    torch.cuda.synchronize()
    assert torch.equal(y, x * 3.0)
    del x, y


def test_two_inputs_and_a_bf16_input(device):
    add = cuda_op("my_add_card", """#include <cuda_bf16.h>
__global__ void add(const float* x, const __nv_bfloat16* y, float* o,
                    int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] + __bfloat162float(y[i]);
}""", "add", lambda x, y: ShapeDtypeStruct(x.shape, "float32"), block=128)
    x = paddle.randn([300, 7])
    y = paddle.randn([300, 7]).astype("bfloat16")
    assert torch.equal(add(x, y), x + y.float())
    with pytest.raises(ValueError, match="input 1 is torch.float32"):
        add(x, x)


def test_a_broken_source_raises_at_build(device):
    op = cuda_op("my_broken", "__global__ void k(const float* x, float* o, "
                 "int64_t n) { o[0] = x[0] +; }", "k",
                 _same(lambda x: x.shape))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        op(paddle.ones([4]))


def test_resnet18_on_the_card_matches_the_cpu_path(device):
    """Logits at 1e-4 of their scale, every gradient at 1e-3 of its
    tensor's largest value (measured on an H100: 4.8e-6 and 1.7e-5; a
    deep randomly initialised ResNet-50 is ill-conditioned in float32
    itself, so the 1e-3 gradient check uses this well-conditioned
    resnet18)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    paddle.seed(0)
    net = resnet18(num_classes=1000)
    paddle.set_device("cpu")
    ref = resnet18(num_classes=1000)
    paddle.set_device("gpu")
    ref.set_state_dict(net.state_dict())
    g = torch.Generator().manual_seed(3)
    x = torch.rand(4, 3, 64, 64, generator=g)
    y = torch.randint(0, 1000, (4,), generator=g)
    out = []
    for model, dev in ((net, "cuda"), (ref, "cpu")):
        logits = model(x.to(dev))
        PF.cross_entropy(logits, y.to(dev)).backward()
        out.append((logits.detach().cpu(),
                    {n: p.grad.cpu() for n, p in model.named_parameters()}))
    (lg, gg), (lc, gc) = out
    assert (lg - lc).abs().max() <= 1e-4 * lc.abs().max()
    for name, want in gc.items():
        assert (gg[name] - want).abs().max() <= 1e-3 * want.abs().max(), name


def test_resnet18_momentum_steps_on_the_card_match_the_cpu_path(device):
    """Two free-running steps of Momentum(0.1, 0.9) with Nesterov and
    weight decay, in float64 on the card and on the CPU path from the
    same weights: every loss, gradient, parameter update (after minus
    before) and BatchNorm running statistic within 1e-6 of its tensor's
    largest value. In float64 the network's float32 ill-conditioning
    stays far below the check, so it holds the backward pass and the
    optimizer's ``_foreach_*`` update on the card."""
    paddle.seed(0)
    net = resnet18(num_classes=1000)
    paddle.set_device("cpu")
    ref = resnet18(num_classes=1000)
    paddle.set_device("gpu")
    ref.set_state_dict(net.state_dict())
    g = torch.Generator().manual_seed(3)
    xs = torch.rand(2, 4, 3, 64, 64, generator=g, dtype=torch.float64)
    ys = torch.randint(0, 1000, (2, 4), generator=g)
    runs = []
    for model, dev in ((net, "cuda"), (ref, "cpu")):
        model.to(dtype="float64")
        opt = paddle.optimizer.Momentum(0.1, 0.9, parameters=model.parameters(),
                                        use_nesterov=True, weight_decay=1e-4)
        before = {k: v.detach().cpu().clone()
                  for k, v in model.state_dict().items()}
        steps = []
        for x, y in zip(xs, ys):
            loss = PF.cross_entropy(model(x.to(dev)), y.to(dev))
            loss.backward()
            grads = {n: p.grad.cpu().clone()
                     for n, p in model.named_parameters()}
            opt.step()
            opt.clear_grad()
            state = {k: v.detach().cpu().clone()
                     for k, v in model.state_dict().items()}
            steps.append((loss.item(), grads, state, before))
            before = state
        runs.append(steps)

    def gap(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    for (lg, gg, sg, bg), (lc, gc, sc, bc) in zip(*runs):
        assert abs(lg - lc) <= 1e-6 * abs(lc)
        for name, want in gc.items():
            assert gap(gg[name], want) <= 1e-6, name
        for name, want in sc.items():
            if name.endswith(("_mean", "_variance")):
                assert gap(sg[name], want) <= 1e-6, name
            else:
                assert gap(sg[name] - bg[name], want - bc[name]) <= 1e-6, name
