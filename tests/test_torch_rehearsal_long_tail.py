"""A CPU rehearsal of ``chip_smoke.py``'s long-tail phases
(``tests/_torch_rehearsal.py`` ``long_tail_on_cpu``):

- ``phase_profiler_cost``: bench.py's GPT at 2 layers of d 64 under the
  profiler's schedule (one closed, one ready, two recorded steps), the
  exported traces parsed, ``summary()`` counting ``train_step`` once per
  recorded step, ``benchmark()`` against the host-timed events, the
  cost model over its static program; a step whose ``RecordEvent`` is
  missing fails;
- ``phase_quantization``: resnet18 at 64^2 through QAT (its first step
  against a second CPU run, the float32 flip trace), PTQ and
  ``convert_int8`` through the counting int8 wrappers (20 convs and the
  Linear); the card's int8 model with one weight code flipped fails its
  comparison with the CPU's; fake-quanters that multiply by the
  reciprocal of the scale fail the flip trace;
- ``phase_sparse``: the GCN on a 2,000-node graph (its first step in
  float64 against a second CPU run, the dropout kernel held to its plain
  version at the steps' shape, the dropout launches of the float32
  steps) and SECOND's stage on a 41 x 64 x 64 grid (neighbour sums over
  voxels on surfaces, patterns); a graph with one edge dropped on the
  "card" fails, and so does a dropout mask with one bit flipped;
- ``phase_distribution``: the VAE at 32 -> 16 -> 8 and the sweep at
  4,096 elements; an ``ExpTransform`` whose log-det is off by 1e-3 on
  the "card" fails;
- ``phase_onnx``: LeNet exported and evaluated, resnet18 refused.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_rehearsal import (  # noqa: E402,F401
    CPU, cs, long_tail_on_cpu, np, paddle, plain_kernels, training_on_cpu)
from _torch_threads import one_thread  # noqa: E402,F401


def test_profiler_cost_phase(long_tail_on_cpu):
    got = cs.phase_profiler_cost(CPU)
    want = {n: 2 * 2 for n in cs.fa.KERNEL_NAMES}
    assert got["trace_kernels"] == want
    assert got["records"] > 10 and got["program_ms"] > 0
    assert got["row_launches"][cs.fa.KERNEL_NAMES[0]] == 2 * (6 + 2 * 2)


def test_profiler_phase_fails_a_missing_record_event(long_tail_on_cpu,
                                                     monkeypatch):
    real, made = paddle.profiler.RecordEvent, []

    class Leaky(real):
        def __init__(self, name, event_type=None):
            super().__init__(name, event_type)
            made.append(self)
            self._skip = len(made) == 3    # the first recorded step's

        def begin(self):
            if not self._skip:
                super().begin()

    monkeypatch.setattr(paddle.profiler, "RecordEvent", Leaky)
    with pytest.raises(AssertionError, match="profiler"):
        cs.phase_profiler_cost(CPU)


def test_quantization_phase(long_tail_on_cpu):
    got = cs.phase_quantization(CPU)
    p = got["parity"]
    assert p["logits"] == p["loss"] == p["flips"] == 0
    assert p["quanters"] == 2 * 21
    # the float32 trace, the CPU against itself: the same x / s bits in
    # every quanter, no flip
    trace = got["f32_trace"]
    assert trace["quanters"] == trace["same_inputs"] == 2 * 21
    assert trace["flips"] == 0 and trace["first"] is None
    assert got["int8_gap"] == 0.0
    assert got["launches"] == {cs.i8.INT8_MATMUL_KERNEL: 21,
                               cs.i8.QUANTIZE_ROWS_KERNEL: 1}
    assert got["convs"] == 20 and got["bound_ms"] > 0


def test_quantization_phase_fails_a_flipped_int8_code(long_tail_on_cpu,
                                                      monkeypatch):
    q = paddle.quantization
    real, made = q.PTQ.convert_int8, []

    def flipped(self, model, *a, **kw):
        out = real(self, model, *a, **kw)
        if len(made) == 1:    # the card's in the CPU comparison
            conv = next(m for m in out.sublayers()
                        if type(m).__name__ == "_Int8Conv2DLayer")
            code = conv._w_qt[0, 0, 0]
            conv._w_qt[0, 0, 0] = code - 1 if code > -127 else code + 1
        made.append(out)
        return out

    monkeypatch.setattr(q.PTQ, "convert_int8", flipped)
    with pytest.raises(AssertionError, match="int8 tier"):
        cs.phase_quantization(CPU)


def test_qat_flip_trace_fails_a_reciprocal_divide(long_tail_on_cpu,
                                                 monkeypatch):
    """The "card"'s fake-quanters round ``x * (1 / s)`` where the CPU's
    round ``x / s`` (PyTorch's form of a division by a Python number on
    the card): codes flip where both runs round the same x / s bits."""
    q = paddle.quantization
    real, made = cs._qat_config, []

    class Reciprocal(q.FakeQuanterWithAbsMaxObserver):
        def forward(self, x):
            super().forward(x)                  # the scale's update
            s = torch.clamp(self._scale, min=1e-9) / 127.0
            codes = torch.clamp(torch.round(x * (1.0 / s)), -127, 127)
            return x + (codes * s - x).detach()

    def config():
        made.append(1)
        if len(made) == 1:                      # the card's
            return q.QuantConfig(activation=Reciprocal(), weight=Reciprocal())
        return real()

    monkeypatch.setattr(cs, "_qat_config", config)
    with pytest.raises(AssertionError, match="from the same x / s"):
        cs.qat_flip_trace(CPU)


def test_sparse_phase(long_tail_on_cpu, monkeypatch):
    held, hold = [], cs.dropout_at_path_shapes

    def recorded(device, cases, seed=70):
        held.extend((tuple(shape), *rest) for _, shape, *rest in cases)
        return hold(device, cases, seed)

    monkeypatch.setattr(cs, "dropout_at_path_shapes", recorded)
    got = cs.phase_sparse(CPU)
    gcn, second = got["gcn"], got["second"]
    # the steps' dropout shape (2,000 nodes, hidden 32) held to plain
    assert held == [((2000, 32), cs.GCN_DROPOUT)]
    assert gcn["loss_gap"] == gcn["grad_gap"] == 0.0
    assert gcn["dropout_launches"] == 2 * 2 * 3
    assert max(second["errs"].values()) <= cs.SECOND_TOL
    assert min(second["pairs"]) > 0
    # the voxels lie on surfaces: most sampled sites have neighbours
    assert second["neighbours"] >= cs.SECOND_MIN_NEIGHBOURS
    assert min(second["covered"].values()) >= cs.SECOND_MIN_COVERED


def test_sparse_phase_fails_a_flipped_dropout_mask_bit(long_tail_on_cpu,
                                                       monkeypatch):
    """The dropout "kernel" keeps one element its plain version drops
    (or drops one it keeps) at the GCN's shape: the check before the
    steps fails."""
    real = cs.dk.dropout_cuda

    def flipped(x, key, p, mask_shape=None, upscale=True):
        y = real(x, key, p, mask_shape, upscale)
        if tuple(x.shape) == (2000, 32):
            y = y.clone()
            y[0, 0] = 0.0 if y[0, 0] != 0 else x[0, 0] / (1 - p)
        return y

    monkeypatch.setattr(cs.dk, "dropout_cuda", flipped)
    with pytest.raises(AssertionError, match="dropout kernel arxiv GCN"):
        cs.phase_gcn(CPU)


def test_sparse_phase_fails_a_dropped_edge(long_tail_on_cpu, monkeypatch):
    real, made = paddle.sparse_csr_tensor, []

    def dropped(crows, cols, vals, shape, **kw):
        if not made:                      # the card's adjacency
            crows, cols, vals = (np.array(a) for a in (crows, cols, vals))
            row = int(np.searchsorted(crows, 1, side="right")) - 1
            j = int(crows[row])
            cols, vals = np.delete(cols, j), np.delete(vals, j)
            crows[row + 1:] -= 1
        made.append(shape)
        return real(crows, cols, vals, shape, **kw)

    monkeypatch.setattr(paddle, "sparse_csr_tensor", dropped)
    with pytest.raises(AssertionError, match="GCN"):
        cs.phase_sparse(CPU)


def test_distribution_phase(long_tail_on_cpu):
    got = cs.phase_distribution(CPU)
    assert got["worst"][1] == 0.0
    assert set(got["draws"].values()) == {0.0}
    assert got["kl_pairs"] == 12 and got["transforms"] == 12
    assert got["vae"]["loss_gap"] == got["vae"]["grad_gap"] == 0.0


def test_distribution_phase_fails_an_off_log_det(long_tail_on_cpu,
                                                 monkeypatch):
    exp = paddle.distribution.ExpTransform
    real, calls = cs._dist_results, []

    def off_on_the_card(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            with monkeypatch.context() as m:
                m.setattr(exp, "_forward_log_det_jacobian",
                          lambda self, x: x + 1e-3)
                return real(*a, **kw)
        return real(*a, **kw)

    monkeypatch.setattr(cs, "_dist_results", off_on_the_card)
    with pytest.raises(AssertionError, match="sweep"):
        cs.phase_distribution(CPU)


def test_onnx_phase(long_tail_on_cpu):
    got = cs.phase_onnx(CPU)
    assert got["err"] <= cs.ONNX_TOL
    assert "adaptive_avg_pool2d" in got["refused"]
