"""A CPU rehearsal of ``chip_smoke.py``'s Paddle-API core, compile and
high-level training phases (``tests/_torch_rehearsal.py``):

- the core phases: the custom-op programs and ``my_triple`` through its
  op (reference counted as a launch) at small shapes, the ResNet
  parity phase (CPU against CPU) and the ResNet training phase with
  its hook-off steps, on resnet18 at 64 x 64, batch 2; ``torch.mul``
  and the plain version agree with my_triple's reference;
- the compile and export phases at the training rehearsal's size:
  ``to_static`` (each CPU call eager and reported so, logits equal to
  eager, one flash launch a layer a call), ``jit.save`` / ``load``
  (bit-equal logits at two batches and gradients), the static program
  (losses bit-equal to eager ``TrainStep``) and the host extensions
  (built with g++);
- the high-level training phases: ``Model.fit`` / ``evaluate`` /
  ``predict`` over bf16 ``FakeData`` on resnet18 at 64 x 64, batch 2
  (ResNet-50's summary and flops at 224 x 224 against the pinned JAX
  counts, which a changed pin fails), the worker ring with ``fork``
  workers (the loader's choice without CUDA; batches equal
  ``num_workers=0``'s, a loader that falls back to the thread prefetch
  fails), and the static tail (sequence ops, EMA, static save/load).
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_rehearsal import (  # noqa: E402,F401
    CPU, compile_on_cpu, core_on_cpu, cpu_card, cs, hapi_on_cpu,
    training_on_cpu)
from _torch_threads import one_thread  # noqa: E402,F401


def test_core_phases(core_on_cpu):
    core = cs.phase_custom_ops(CPU)
    assert core["launches"] == 2 and core["max_abs_err"] == 0.0
    x = core["x"]
    assert torch.equal(torch.mul(x, 3.0), cs.triple_plain(x))
    assert cs.triple_grid(torch.empty(8192, 8192)) == (
        8192 * 8192 // (8 * cs.TRIPLE_BLOCK),)
    assert cs.triple_grid(torch.empty(4, 8)) == (1,)
    cs.phase_resnet_parity(CPU, CPU)
    got = cs.phase_resnet_train(CPU, profile=False)
    assert got["ms_per_step"] > 0 and got["ms_per_step_hook_off"] > 0


def test_to_static_phase(compile_on_cpu):
    """The to_static phase's CPU part: logits equal to the eager
    model's in every call, one flash forward a layer a call (each CPU
    call runs eagerly), the tensor if and while equal to Python and
    reported eager with the CPU's reason."""
    got = cs.phase_to_static(CPU)
    assert got["bit_equal"]
    assert got["if"]["reason"] == got["while"]["reason"] == "runs on the CPU"


def test_jit_save_load_phase(compile_on_cpu):
    """jit.save / jit.load of the narrow GPT (bf16 weights): logits at
    two batches bit-equal, the backward's launches and gradients, the
    model's parameter names."""
    got = cs.phase_jit_save_load(CPU)
    assert set(got["logits"]) == {2, 3}
    assert max(got["logits"].values()) == 0.0 and got["grad_rel"] == 0.0


def test_static_train_phase(compile_on_cpu):
    """The static program of the narrow GPT under O2 bf16: losses
    bit-equal to the eager TrainStep, the three flash stand-ins once a
    layer a step."""
    got = cs.phase_static_train(CPU)
    assert got["losses"] == got["eager"]
    assert got["records"] > 0


def test_extensions_phase(compile_on_cpu):
    """The cpp_extension op and the plugin kernel built with g++ (the
    test skips without it), each equal on its device and on the CPU."""
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the host extension and the plugin")
    got = cs.phase_extensions(CPU)
    assert set(got) == {"cpp::scale_shift", "plugin::axpb"}


def test_hapi_resnet_phase(hapi_on_cpu):
    """Model.fit / evaluate / predict over FakeData bf16 with TrainStep,
    the step timer's waits, summary/flops equal to the pinned JAX counts,
    save/load bit-equal, no port kernel launched."""
    got = cs.phase_hapi_resnet(CPU, {"samples_per_s": 1.0})
    assert len(got["losses"]) == cs.HAPI_STEPS
    assert got["samples_per_s"] > 0 and 0 < got["loader_share"] < 1
    assert got["busy_share"] is None          # the stand-in profiler
    assert got["flops"] == cs.RESNET50_COUNTS["flops"]
    assert len(got["eval"]["acc"]) == 2


def test_hapi_resnet_phase_fails_wrong_counts(hapi_on_cpu, monkeypatch):
    monkeypatch.setattr(cs, "RESNET50_COUNTS", {**cs.RESNET50_COUNTS,
                                                "flops": 1})
    with pytest.raises(AssertionError, match="summary/flops"):
        cs.check_resnet_counts(CPU)


def test_hapi_workers_phase(hapi_on_cpu):
    """The ring serves both loaders (batches equal num_workers=0's) and
    Model.fit runs through it."""
    got = cs.phase_hapi_workers(CPU)
    assert set(got) == {"lenet", "resnet50"}
    for row in got.values():
        assert row["loader_samples_per_s"] > 0
        assert row["fit_samples_per_s"] > 0


def test_hapi_workers_phase_refuses_the_thread_fallback(hapi_on_cpu,
                                                        monkeypatch):
    """The loader without the native tier (the phase's own check of the
    tier passes, the DataLoader's finds none) falls back to the thread
    prefetch, which the phase refuses."""
    import itertools

    from paddle_tpu_torch.core import native

    answers = itertools.chain([True], itertools.repeat(False))
    monkeypatch.setattr(native, "available", lambda: next(answers))
    with pytest.raises(AssertionError, match="fell back"):
        cs.phase_hapi_workers(CPU)


def test_static_extras_phase(hapi_on_cpu):
    got = cs.phase_static_extras(CPU)
    assert set(got["errors"]) == set(cs.SEQ_CASES)
    assert max(got["errors"].values()) == 0.0      # the CPU against itself
    assert got["ops"] > 0
