"""A CPU rehearsal of ``chip_smoke.py``'s speculative, per-tier and
Paddle-API core phases.

The smoke runs only on the card. Here its phase functions run on the
CPU with each kernel wrapper replaced by the kernel's plain version
(still counting one launch per call), so the phases' control flow, their
launch bookkeeping and their checks are exercised before a chip run:

- the decode and mixed kernel checks at the per-tier shapes (GPT-2-small
  heads);
- the speculative engine path and the per-tier path on a narrow model
  with GPT-2-small's vocabulary and context (d 64, 2 layers), the
  smoke's own twelve requests;
- the bound arithmetic of the kernels line, and the library yardstick
  (SDPA on K/V gathered dense) computing the plain version's function;
- the flash times phase and its rows of the kernels line at a small
  shape (the wrappers swapped for their plain versions, each timing a
  single call): the backward rows carry SDPA's backward alone and
  ``bwd_delta``'s time, every row names its bf16 and float32 sources in
  the repository, the float32 forward's row carries an earlier design's
  two times when a library of it is given, and SDPA's backward computes
  the plain backward's gradients;
- the flash phase's float64 check of the float32 forward and backward:
  the plain versions against themselves pass it with a non-zero error,
  outputs or gradients off by 1e-3 fail it, and rows that see no key
  (o = 0, lse = NEG_INF) count no error;
- the float32 training phase on a narrow GPT (d 128, 2 layers, 2 x 128
  tokens) with the flash wrappers swapped for their plain versions:
  one launch of each per layer per step, finite losses;
- the ragged times phase and its rows of the kernels line at narrow
  heads (H 2, D 16, the smoke's contexts): both bounds at every shape
  (the tensor-core bound's arithmetic checked by hand on a tiny mix),
  an earlier design's two times when its libraries are given, each
  row's launches by step class and launches x (time - bound); and the
  engine path's count of ragged launches by step class (decode-only
  steps and steps with a chunk or prefix row), which must add up to
  its launches;
- the smoke's build of an earlier ``ragged_attention.cuh`` (the SIMT
  page walk of the parent commit's design as text): each page type's
  library source has the header and its local includes inlined and
  keeps its C entry; and of an earlier decode kernel
  ``paged_attention.cu``: the headers beside it are inlined before the
  port's, and the per-tier times phase (the smoke's shapes, GPT-2-small
  heads) gives its decode row that design's two times;
- the async serving phase (depths 0 and 1 here, the smoke's three
  batches of long-context traffic with prompts cut to a quarter, int8
  KV and weights, the KV split) on a narrow model with GPT-3 XL's
  context (a 1024-token vocabulary): equal tokens across depths and the
  graphs switch (the CPU path runs eagerly either way), launches layers
  x steps in the timed batch, signatures within the bound, one row of
  numbers a run;
- the preemption phase on a narrow model with GPT-2-small's context (a
  1024-token vocabulary), at async depth 1: preemptions, swap-outs and
  swap-ins, quota deferrals and the deadline's timeout all happen, and
  the survivors equal their uncontended runs;
- the core phases: the custom-op programs and ``my_triple`` through its
  op (reference counted as a launch) at small shapes, the ResNet
  parity phase (CPU against CPU) and the ResNet training phase with
  its hook-off steps, on resnet18 at 64 x 64, batch 2; ``torch.mul``
  and the plain version agree with my_triple's reference.

Nothing here measures the card: times printed by the phases under this
rehearsal are host times of the plain versions.
"""
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

import collections  # noqa: E402
import sys  # noqa: E402

import chip_smoke as cs  # noqa: E402
import paddle_tpu_torch as paddle  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.vision.models import resnet18  # noqa: E402
from paddle_tpu_torch.inference.llm import ModelSpec, TorchLM  # noqa: E402
from paddle_tpu_torch.inference.llm.model import init_lm_params  # noqa: E402
from paddle_tpu_torch.kernels import paged_attention as pa  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

CPU = torch.device("cpu")


@pytest.fixture
def plain_kernels(monkeypatch):
    """Every kernel wrapper runs its plain version and counts a launch;
    ``auto`` resolves to the kernel tier; synchronize is a no-op."""

    def counting(ref, name_of):
        def run(*args, **kw):
            kw.pop("max_q_len", None)
            kw.pop("split_blocks", None)
            split = kw.pop("split_pages", 0)
            out = ref(*args, **kw)
            pa.LAUNCHES[name_of(args, split)] += 1
            return out
        return run

    monkeypatch.setattr(pa, "ragged_attention_cuda", counting(
        pa.ragged_attention_ref, lambda a, sp: pa.kernel_name(
            a[1].dtype, pa.split_active(sp, a[3].shape[1]))))
    monkeypatch.setattr(pa, "paged_attention_cuda", counting(
        pa.paged_attention_ref, lambda a, sp: pa.PAGED_KERNEL))
    monkeypatch.setattr(pa, "mixed_attention_cuda", counting(
        pa.mixed_attention_ref, lambda a, sp: pa.MIXED_KERNEL))
    monkeypatch.setattr(pa, "_resolve_tier",
                        lambda tier, q: "ref" if tier == "ref" else "kernel")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    saved = pa.LAUNCHES.copy()
    yield
    pa.LAUNCHES.clear()                # the phases leave their counts
    pa.LAUNCHES.update(saved)


class _Event:
    """A stand-in for ``torch.cuda.Event`` on the CPU: every span 1 ms."""

    def __init__(self, **kw):
        pass

    def record(self):
        pass

    def elapsed_time(self, other):
        return 1.0


class _Profile:
    """A stand-in for ``torch.profiler.profile`` that records nothing
    (the CPU profiler's per-op records would dominate the rehearsal)."""

    def __init__(self, **kw):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def key_averages(self):
        return []


@pytest.fixture
def cpu_card(monkeypatch):
    """What a serving phase reads of the card, stood in for on the CPU:
    its name, memory statistics, events and the profiler; engines built
    without CUDA graphs, which need the card."""
    monkeypatch.setattr(cs, "card_identity", lambda: "CPU rehearsal")
    for name in ("reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "max_memory_reserved"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.profiler, "profile", _Profile)
    make = cs.make_engine

    def eager(*args, **kw):
        kw["cuda_graphs"] = None
        return make(*args, **kw)

    monkeypatch.setattr(cs, "make_engine", eager)


def test_async_serving_phase(plain_kernels, cpu_card, monkeypatch):
    # GPT-3 XL's context with a 1024-token vocabulary: the plain
    # sampler over 50304 tokens takes most of a step on the CPU
    spec = ModelSpec(vocab=1024, d_model=64, num_layers=2, num_heads=2,
                     head_dim=32, max_seq_len=cs.GPT3_XL.max_seq_len)
    model = TorchLM(spec, init_lm_params(spec, seed=0, device=CPU),
                    device=CPU)
    monkeypatch.setattr(cs, "ASYNC_DEPTHS", (0, 1))
    # the smoke's traffic with each prompt cut to a quarter
    batches = [[(p[:len(p) // 4], sp) for p, sp in cs.requests_long(
        s, spec.vocab)] for s in (11, 13, 17)]
    rows = cs.phase_async_serving(model, batches)
    assert [(r["depth"], r["graphs"]) for r in rows] == [
        (0, False), (0, True), (1, False), (1, True)]
    for r in rows:
        assert r["steps"] > 0 and r["ms_per_step"] > 0
        assert r["signatures"] <= r["graph_bound"]
        assert r["graphs_captured"] == 0          # eager on the CPU
    # depth 1: every mixed step's commit phase left one step in flight
    assert rows[2]["occupancy"][0] == 0 < rows[2]["occupancy"][1]


def test_preempt_swap_phase(plain_kernels, cpu_card):
    spec = ModelSpec(vocab=1024, d_model=64, num_layers=2, num_heads=2,
                     head_dim=32, max_seq_len=cs.GPT2_SMALL.max_seq_len)
    model = TorchLM(spec, init_lm_params(spec, seed=0, device=CPU),
                    device=CPU)
    got = cs.phase_preempt_swap(model)
    assert got["preemptions"] > 0 and got["swapped_in"] > 0
    assert got["ties"] == 0                       # one backend: equal


def _narrow_model(max_seq_len):
    spec = ModelSpec(vocab=1024, d_model=64, num_layers=2, num_heads=2,
                     head_dim=32, max_seq_len=max_seq_len)
    return TorchLM(spec, init_lm_params(spec, seed=0, device=CPU),
                   device=CPU)


def test_observability_phase(plain_kernels, cpu_card, monkeypatch):
    """The main path's observability phase at depth 1 (the async phase's
    traffic cut to a quarter): tokens equal on and off, one record per
    committed step, phases summing to each step's wall time, the
    ledger's tenant sums, and the printed numbers present."""
    model = _narrow_model(cs.GPT3_XL.max_seq_len)
    monkeypatch.setattr(cs, "ASYNC_TOKENS", [])
    batches = [[(p[:len(p) // 4], sp) for p, sp in cs.requests_long(
        s, model.spec.vocab)] for s in (11, 13, 17)]
    out = cs.phase_observability(model, batches)
    assert out["steps"] > 0 and out["ms_per_step"] > 0
    assert out["ms_per_step_off"] > 0
    assert set(out["phase_ms"]) >= {"plan", "pack", "dispatch",
                                    "sample_commit"}
    assert out["bytes_per_step"] > 0 and out["flops_per_step"] > 0
    assert out["captures"] == 0                   # eager on the CPU
    assert {"ttft", "itl", "queue_wait"} <= set(out["slo"])
    assert {r["tenant"] for r in out["slo"]["ttft"]} == {"a", "b"}
    from paddle_tpu_torch import observability as obs
    assert obs.default_registry().enabled        # left on


def test_faults_journal_phase(plain_kernels, cpu_card):
    """The journal, fault and brownout phase at GPT-2-small's context on
    a narrow model: the kill lands, the restore equals the clean run,
    seeded NaN rows and dispatch faults are retried once each and end
    only their requests, and the brownout ladder climbs to shedding and
    back to 0."""
    model = _narrow_model(cs.GPT2_SMALL.max_seq_len)
    rep = cs.phase_faults_journal(model)
    assert rep["restore"]["restored"] > 0
    assert rep["restore"]["ties"] == 0            # one backend: equal
    for kind in ("nan", "dispatch"):
        assert rep[kind]["injected"] == rep[kind]["retries"] > 0
        assert rep[kind]["device_faults"] > 0 and rep[kind]["survivors"] > 0
        assert rep[kind]["ties"] == 0
    o = rep["overload"]
    assert o["shed"] + o["overloaded"] > 0 and o["retry_after_s"][0] > 0


def test_per_tier_kernel_phase(plain_kernels):
    errors = cs.phase_per_tier_kernels(CPU)
    assert errors == {pa.PAGED_KERNEL: 0.0, pa.MIXED_KERNEL: 0.0}


def test_spec_engine_and_per_tier_phases(plain_kernels):
    spec = ModelSpec(vocab=cs.GPT2_SMALL.vocab, d_model=64, num_layers=2,
                     num_heads=2, head_dim=32,
                     max_seq_len=cs.GPT2_SMALL.max_seq_len)
    model = TorchLM(spec, init_lm_params(spec, seed=0, device=CPU),
                    device=CPU)
    requests = cs.requests_spec()
    launches, teacher, diverge = cs.phase_spec_engine(model, requests)
    assert set(launches) == {"ragged_attention"}
    assert diverge == [None] * len(requests)   # one backend: equal tokens
    got = cs.phase_per_tier(model, requests, teacher, diverge)
    assert set(got) == {pa.MIXED_KERNEL, pa.PAGED_KERNEL}
    assert all(n % spec.num_layers == 0 and n > 0 for n in got.values())


def test_bounds_and_library_yardstick():
    decode = cs.per_tier_mix("decode", 40, CPU)
    chunk = cs.per_tier_mix("chunk", 41, CPU)
    H, D = 12, 64
    # decode: every position below each seq_len, K and V, float32
    assert cs.per_tier_work(decode)[0] == (sum(decode["seq_lens"].tolist())
                                           * H * D * 8 + 2 * 9 * H * D * 4)
    # chunk: 512 queries after 512 resident keys, 4 * D per pair and head
    pairs = sum(512 + t + 1 for t in range(512))
    assert cs.per_tier_work(chunk)[1] == pairs * H * 4 * D
    for args in (decode, chunk, cs.per_tier_mix("verify", 42, CPU)):
        qd, k, v, mask = cs.per_tier_sdpa_inputs(args)
        lib = F.scaled_dot_product_attention(qd, k, v, attn_mask=mask)
        ref = cs.per_tier_call(args, "ref")
        ref = ref if ref.dim() == 4 else ref[:, None]
        seen = args["seq_lens"] > 0                # empty slots excluded
        torch.testing.assert_close(lib.transpose(1, 2)[seen], ref[seen],
                                   rtol=2e-5, atol=2e-5)


def test_flash_times_and_rows(monkeypatch):
    fa = cs.fa

    def once(fn, reps=20, warmup=3):
        fn()
        return 1.0

    monkeypatch.setattr(cs, "time_cuda", once)
    monkeypatch.setattr(cs, "FLASH_TRAIN", (1, 2, 96, 96, 64))
    for name in ("fwd", "bwd_dkdv", "bwd_dq"):
        monkeypatch.setattr(fa, f"flash_{name}_cuda",
                            getattr(fa, f"flash_{name}_ref"))
    launches = {n: 384 for n in fa.KERNEL_NAMES}
    errors = {(n, dt): 0.0 for n in fa.KERNEL_NAMES
              for dt in ("bfloat16", "float32")}
    errors.update({(n, "float64"): (2e-6, 1e-6) for n in fa.KERNEL_NAMES})
    old_fwd = type("Lib", (), {"flash_fwd_f32": type("Fn", (), {})()})()
    entry = fa._entry
    rows = cs.flash_rows(CPU, launches, errors,
                         {n: 72 for n in fa.KERNEL_NAMES}, ("old.cu", old_fwd))
    assert fa._entry is entry
    root = cs.os.path.dirname(cs.os.path.abspath(cs.__file__))
    assert [r["name"] for r in rows] == list(fa.KERNEL_NAMES)
    for row in rows:
        assert row["launches"] == 384 and row["ms"] == 1.0
        assert row["launches_f32"] == 72
        assert cs.os.path.exists(cs.os.path.join(root, row["source"]))
        assert cs.os.path.exists(cs.os.path.join(root, row["source_f32"]))
        bwd = row["name"] != "flash_attention_fwd"
        assert row["source"].endswith("flash_bwd_bf16.cu" if bwd
                                      else "flash_fwd_bf16.cu")
        assert row["source_f32"].endswith("flash_bwd_f32.cu" if bwd
                                          else "flash_fwd_f32.cu")
        assert row["f64_err_f32"] == {"kernel": 2e-6, "plain": 1e-6}
        for t in (row, row["f32"]):
            assert (t["library_ms"] is None) == bwd
            assert ("library_bwd_ms" in t and "delta_ms" in t) == bwd
        assert "design" not in row
        assert row["f32"].get("design") == (None if bwd else {
            "source": "old.cu", "ms": [1.0, 1.0]})
    # the yardstick computes the function: SDPA's backward alone gives
    # the plain backward's gradients (float32)
    q, k, v, do = cs.flash_inputs((1, 2, 96, 96, 64), torch.float32, 5, CPU)
    o, lse = fa.flash_fwd_ref(q, k, v, 0.125, True)
    want = fa.flash_bwd_ref(q, k, v, o, lse, do, 0.125, True)
    qg, kg, vg = (t.requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    got = torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.fixture
def core_on_cpu(monkeypatch):
    """The core phases at CPU sizes: my_triple's op runs its reference
    and counts a launch, the ResNet phases run resnet18 at 64 x 64,
    batch 2, and the card's memory counters and synchronize are
    no-ops."""
    co = sys.modules["paddle_tpu_torch.utils.custom_op"]

    def run(self, xs):
        outs = self._reference(xs, self.out_specs(xs))
        co.LAUNCHES[self.name] = co.LAUNCHES.get(self.name, 0) + 1
        return outs

    monkeypatch.setattr(co._CudaOp, "run", run)
    monkeypatch.setattr(cs, "TRIPLE_SHAPES", ((4, 8), (64, 96)))
    monkeypatch.setattr(cs, "resnet50", resnet18)
    for name, value in (("RESNET_SIZE", 64), ("RESNET_BATCH", 2),
                        ("RESNET_PARITY_BATCH", 2), ("RESNET_WARMUP", 1),
                        ("RESNET_STEPS", 2), ("RESNET_PLAIN_STEPS", 1),
                        ("RESNET_PARITY_STEPS", 2)):
        monkeypatch.setattr(cs, name, value)
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    saved = tdevice._CURRENT[0]
    paddle.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved
    co.LAUNCHES.pop("my_triple", None)


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


def test_float32_training_phase(monkeypatch):
    """The float32 training phase at a CPU size: each flash wrapper runs
    its plain version and counts a launch (the plain functions the phase
    refuses are reached only through the wrappers), every kernel
    launches once per layer per step and the losses are finite."""
    fa = cs.fa
    monkeypatch.setattr(fa, "LAUNCHES", collections.Counter())
    for kind, name in zip(("fwd", "bwd_dkdv", "bwd_dq"), fa.KERNEL_NAMES):
        def run(*args, _ref=getattr(fa, f"flash_{kind}_ref"), _name=name):
            fa.LAUNCHES[_name] += 1
            return _ref(*args)
        monkeypatch.setattr(fa, f"flash_{kind}_cuda", run)
    monkeypatch.setattr(fa, "_use_kernel", lambda tier, q: tier != "ref")
    monkeypatch.setattr(cs, "TRAIN_CFG", {
        **cs.TRAIN_CFG, "vocab_size": 512, "hidden_size": 128,
        "num_hidden_layers": 2, "num_attention_heads": 2,
        "intermediate_size": 256, "max_position_embeddings": 128,
        "loss_chunks": 2})
    monkeypatch.setattr(cs, "TRAIN_BATCH", 2)
    monkeypatch.setattr(cs, "TRAIN_SEQ", 128)
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    got = cs.phase_train_f32(CPU)
    steps = cs.TRAIN_F32_K * (1 + cs.TRAIN_F32_CALLS)
    assert got["launches"] == {n: 2 * steps for n in fa.KERNEL_NAMES}
    assert got["ms_per_step"] > 0
    assert fa.flash_fwd_ref.__name__ == "flash_fwd_ref"   # restored


def test_float64_check_of_the_float32_backward():
    fa = cs.fa
    shape = (1, 2, 96, 96, 64)
    q, k, v, do = cs.flash_inputs(shape, torch.float32, 4, CPU)
    o, lse = fa.flash_fwd_ref(q, k, v, 0.125, True)
    args = (q, k, v, do, lse, fa.bwd_delta(o, do), 0.125, True)
    dk, dv = fa.flash_bwd_dkdv_ref(*args)
    plain = {"dq": fa.flash_bwd_dq_ref(*args), "dk": dk, "dv": dv}
    worst = {}
    cs.check_f64(worst, args, plain, plain, shape)
    for name in cs.fa.KERNEL_NAMES[1:]:
        kern, ref = worst[(name, "float64")]
        assert kern == ref and 0 < kern < 1e-4
    off = {n: t + 1e-3 for n, t in plain.items()}
    with pytest.raises(AssertionError, match="float64 error"):
        cs.check_f64({}, args, off, plain, shape)


def test_float64_check_of_the_float32_forward():
    """``check_f64`` on the forward's o and lse: the plain version against
    itself passes with a non-zero error (rows that see no key, Sq > Sk
    causal, add none: both sides give lse = NEG_INF there), o off by 1e-3
    fails, and the forward's float64 version agrees with the plain one."""
    fa = cs.fa
    shape = (1, 2, 160, 96, 64)
    q, k, v, do = cs.flash_inputs(shape, torch.float32, 6, CPU)
    o, lse = fa.flash_fwd_ref(q, k, v, 0.125, True)
    want_o, want_lse = cs.flash_fwd_f64(q, k, v, 0.125, True)
    assert (want_lse[:, :, :64] == lse[:, :, :64].double()).all()
    assert want_o[:, :, :64].abs().max().item() == 0.0
    torch.testing.assert_close(want_o, o.double(), rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(want_lse, lse.double(), rtol=2e-5, atol=2e-5)
    args = (q, k, v, do, lse, fa.bwd_delta(o, do), 0.125, True)
    plain = {"o": o, "lse": lse}
    worst = {}
    cs.check_f64(worst, args, plain, plain, shape)
    kern, ref = worst[("flash_attention_fwd", "float64")]
    assert kern == ref and 0 < kern < 2e-5
    assert set(worst) == {("flash_attention_fwd", "float64")}
    with pytest.raises(AssertionError, match="float64 error"):
        cs.check_f64({}, args, {"o": o + 1e-3, "lse": lse}, plain, shape)


def test_tensor_core_bound_by_hand():
    """Rows of one query at 67 TFLOP/s, longer rows at two (codes) or
    three (float32) TF32 products per operation at 495, dequantization
    at 67; bytes as the float32 bound counts them."""
    i32 = dict(dtype=torch.int32)
    args = dict(q=torch.zeros(4, 1, 8), q_lens=torch.tensor([1, 3], **i32),
                kv_lens=torch.tensor([5, 3], **i32))
    ops = {True: 6 * 32 * 2 / 495e12 + (5 * 32 + 8 * 8 * 2) / 67e12,
           False: 6 * 32 * 3 / 495e12 + 5 * 32 / 67e12}
    for quant in (True, False):
        nbytes, _ = cs.attention_work(args, quant)
        ms, by = cs.tc_bound(args, quant)
        want = max(nbytes / cs.HBM_BYTES_PER_S, ops[quant])
        assert ms == pytest.approx(want * 1e3, rel=1e-12)
        assert by == "bytes"
    long_row = dict(q=torch.zeros(601, 1, 64),    # a 600-token chunk
                    q_lens=torch.tensor([1, 600], **i32),
                    kv_lens=torch.tensor([5, 600], **i32))
    assert cs.tc_bound(long_row, True)[1] == "operations"


def test_ragged_times_and_rows(plain_kernels, monkeypatch):
    monkeypatch.setattr(cs, "time_cuda", lambda fn, reps=20, warmup=3:
                        (fn(), 1.0)[1])
    for name, spec in (("GPT3_XL", cs.GPT3_XL), ("GPT2_SMALL",
                                                  cs.GPT2_SMALL)):
        monkeypatch.setattr(cs, name, ModelSpec(
            vocab=64, d_model=32, num_layers=2, num_heads=2, head_dim=16,
            max_seq_len=spec.max_seq_len))
    names = [pa.kernel_name(cs.DTYPES[m], sp) for sp in (False, True)
             for m in cs.MODES]
    int8 = pa.kernel_name(torch.int8, True)
    # the row takes the path its launches come from: the last one whose
    # total matches
    monkeypatch.setattr(cs, "LAUNCHES_BY_STEP", {
        "quantized": {"kernel": int8, "decode": 1200, "mix": 120},
        "other": {"kernel": int8, "decode": 1, "mix": 2}})
    entry = pa._entry
    rows = cs.phase_times(CPU, {n: 1320 if n == int8 else 24 for n in names},
                          {n: 0.0 for n in names}, ("old.cuh", {}))
    assert pa._entry is entry
    assert [r["name"] for r in rows] == names
    root = cs.os.path.dirname(cs.os.path.abspath(cs.__file__))
    for row in rows:
        assert cs.os.path.exists(cs.os.path.join(root, row["source"]))
        assert row["launches"] == (1320 if row["name"] == int8 else 24)
        assert row["ms"] == 1.0
        kinds = {"decode", "mix"} | ({"decode_gpt2_small", "mix_gpt2_small"}
                                     if row["name"] == names[0] else set())
        assert set(row["shapes"]) == kinds
        for t in row["shapes"].values():
            assert t["design_ms"] == [1.0, 1.0]
            assert 0 < t["tc_bound_ms"] <= t["bound_ms"]
            assert {t["bound_by"], t["tc_bound_by"]} <= {"bytes",
                                                         "operations"}
        assert ("launches_by_step" in row) == (row["name"] == int8)
    assert rows[names.index(int8)]["launches_by_step"] == {
        "path": "quantized", "kernel": int8, "decode": 1200, "mix": 120}
    loss = rows[names.index(int8)]["launch_ms_over_bound"]
    shapes = rows[names.index(int8)]["shapes"]
    assert loss == {k: n * (1.0 - shapes[k]["bound_ms"])
                    for k, n in (("decode", 1200), ("mix", 120))}


def test_engine_path_counts_launches_by_step(plain_kernels, monkeypatch):
    spec = ModelSpec(vocab=cs.GPT2_SMALL.vocab, d_model=64, num_layers=2,
                     num_heads=2, head_dim=32,
                     max_seq_len=cs.GPT2_SMALL.max_seq_len)
    model = TorchLM(spec, init_lm_params(spec, seed=0, device=CPU),
                    device=CPU)
    monkeypatch.setattr(cs, "LAUNCHES_BY_STEP", {})
    name = pa.kernel_name(torch.float32, True)
    launches = cs.drive_path("rehearsal", model, cs.requests_gpt2(7), name,
                             split=cs.SPLIT, chunk=cs.CHUNK,
                             min_prefix_pages=256 // cs.PAGE)[0]
    got = cs.LAUNCHES_BY_STEP["rehearsal"]
    assert got["kernel"] == name
    assert got["decode"] > 0 and got["mix"] > 0
    assert got["decode"] + got["mix"] == launches[name]
    assert pa.ragged_attention_cuda.__name__ == "run"     # unwrapped


def test_old_ragged_sources_inline_the_header():
    old = (cs._build.CSRC / "paged_walk.cuh").read_text()
    header = ('#pragma once\n#include "paged_walk.cuh"\n' + old[:0]
              + "#define RAGGED_ATTENTION_ENTRY(NAME, T) int NAME;\n")
    sources = cs.old_ragged_sources(header)
    assert set(sources) == {f"{lib}_old" for lib, _, _ in pa._LIBS.values()}
    for lib, entry, _ in pa._LIBS.values():
        text = sources[f"{lib}_old"]
        assert "#include \"" not in text and "#pragma once" not in text
        assert "namespace paged" in text           # paged_walk.cuh inlined
        assert f"RAGGED_ATTENTION_ENTRY({entry}," in text


def test_old_decode_source_takes_the_headers_beside_it(tmp_path):
    """An earlier ``paged_attention.cu`` with its own ``paged_walk.cuh``
    beside it: that header is inlined, not the port's, and a header not
    beside it comes from ``csrc/``."""
    (tmp_path / "paged_walk.cuh").write_text(
        '#pragma once\n#include "cp_async.cuh"\n// the earlier walk\n')
    text = ('#include "paged_walk.cuh"\n'
            'extern "C" int paged_attention_f32() { return 0; }\n')
    got = cs.inline_includes(text, beside=tmp_path)
    assert "// the earlier walk" in got and "walk_pages" not in got
    assert "namespace cpasync" in got              # from csrc/
    assert '#include "' not in got and "#pragma once" not in got


def test_per_tier_rows_time_an_earlier_decode_kernel(plain_kernels,
                                                     monkeypatch):
    """The per-tier times phase at the smoke's shapes with an earlier
    decode kernel given: the decode row carries that design's two times
    (before and after the kernel's), the mixed row none; ``pa._entry`` is
    the port's own afterwards."""
    monkeypatch.setattr(cs, "time_cuda", lambda fn, reps=20, warmup=3:
                        (fn(), 1.0)[1])
    entry = pa._entry
    names = list(cs.PER_TIER)
    rows = cs.per_tier_rows(CPU, {n: 7 for n in names},
                            {n: 0.0 for n in names}, ("old.cu", None))
    assert pa._entry is entry
    by_name = {r["name"]: r for r in rows}
    decode = by_name[pa.PAGED_KERNEL]["shapes"]["decode"]
    assert decode["design_ms"] == [1.0, 1.0]
    assert 0 < decode["bound_ms"] and decode["bound_by"] == "bytes"
    for kind, t in by_name[pa.MIXED_KERNEL]["shapes"].items():
        assert "design_ms" not in t, kind
