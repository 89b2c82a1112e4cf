"""A CPU rehearsal of ``chip_smoke.py``'s flash and training phases,
with each kernel wrapper its counting plain version
(``tests/_torch_rehearsal.py``):

- the flash times phase and its rows of the kernels line at a small
  shape (the wrappers swapped for their plain versions, each timing a
  single call): the backward rows carry SDPA's backward alone and
  ``bwd_delta``'s time, every row names its bf16 and float32 sources in
  the repository, the float32 forward's row carries an earlier design's
  two times when a library of it is given, and SDPA's backward computes
  the plain backward's gradients; the float16 rows likewise;
- the flash phase's float64 check of the float32 forward and backward:
  the plain versions against themselves pass it with a non-zero error,
  outputs or gradients off by 1e-3 fail it, and rows that see no key
  (o = 0, lse = NEG_INF) count no error;
- the float32 training phase on a narrow GPT (d 128, 2 layers, 2 x 128
  tokens) with the flash wrappers swapped for their plain versions:
  one launch of each per layer per step, finite losses;
- training as users configure it: the dropout kernel phase (a planted
  bit fails) and its row, dropout through the kernel in the training
  path, float16 O2 with a GradScaler (a changed parameter fails), the
  remat policies, Adam's low-memory tiers and incremental decode.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_rehearsal import (  # noqa: E402,F401
    CPU, F, _once, _small_dropout_shapes, collections, cs, training_on_cpu)
from _torch_threads import one_thread  # noqa: E402,F401


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


def test_dropout_kernel_phase(training_on_cpu, monkeypatch):
    """The phase at small shapes (the attention case compared over its
    first and last slices, as at full size), the stand-in kernel being
    the plain version: it passes, and counts one launch a forward."""
    _small_dropout_shapes(monkeypatch)
    assert cs._dropout_slices(2 * 3 * 64 * 64) == ((0, 4096),
                                                    (24576 - 4096, 4096))
    got = cs.phase_dropout_kernel(CPU)
    assert got == {"max_abs_err": 0.0}


def test_dropout_kernel_phase_fails_a_planted_bit(training_on_cpu,
                                                  monkeypatch):
    _small_dropout_shapes(monkeypatch)
    kernel = training_on_cpu

    def wrong(x, key, p, mask_shape=None, upscale=True):
        out = kernel(x, key, p, mask_shape, upscale).clone()
        flat = out.view(-1)
        flat[7] = -flat[7] if flat[7] != 0 else 1.0
        return out

    monkeypatch.setattr(cs.dk, "dropout_cuda", wrong)
    with pytest.raises(AssertionError, match="differ from the plain"):
        cs.phase_dropout_kernel(CPU)


def test_dropout_times_and_row(training_on_cpu, monkeypatch):
    _small_dropout_shapes(monkeypatch)
    monkeypatch.setattr(cs, "time_cuda", _once)
    times = cs.dropout_times(CPU)
    row = cs.dropout_row(times, 74, 0.0)
    for key in ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"):
        assert key in row, key
    assert row["library_ms"] is None and row["launches"] == 74
    root = cs.os.path.dirname(cs.os.path.abspath(cs.__file__))
    assert cs.os.path.exists(cs.os.path.join(root, row["source"]))
    n = 2 * 3 * 64 * 64
    t_bytes = 2 * n * 4 / cs.HBM_BYTES_PER_S
    t_ops = cs.DROPOUT_INT_OPS * n / cs.INT32_OPS_PER_S
    assert row["bound_ms"] == pytest.approx(1e3 * max(t_bytes, t_ops))
    assert row["bound_by"] == ("operations" if t_ops > t_bytes else "bytes")
    assert row["hidden"]["dtype"] == "bfloat16"


def test_train_dropout_phase(training_on_cpu):
    """The main path at a CPU size: every dropout launch counted
    (forward and backward, (1 + 2 L) hidden and L attention a step), the
    flash stand-ins idle, the plain versions reached only through the
    kernel's stand-in, the second model repeats the first call, eval
    gives the dropout-free logits."""
    base = {"ms_per_step": 1.0, "peak_gib": 0.0, "peak_above_gib": 0.0}
    got = cs.phase_train_dropout(CPU, base, profile=False)
    steps = cs.TRAIN_K * (1 + cs.TRAIN_DROPOUT_CALLS)
    assert got["launches"] == {cs.dk.KERNEL_NAME: 2 * (1 + 2 * 2 + 2)
                               * steps}
    assert cs.dk.dropout_ref.__name__ == "dropout_ref"      # restored


def test_train_fp16_phase(training_on_cpu, monkeypatch):
    # 256 tokens: the loss gradient's largest entries scale / 256 overflow
    monkeypatch.setattr(cs, "FP16_INIT_SCALE", 2.0 ** 28)
    monkeypatch.setattr(cs, "FP16_STEPS", 14)
    got = cs.phase_train_fp16(CPU)
    assert got["launches"] == {n: 2 * 14 for n in cs.fa.KERNEL_NAMES}
    assert got["skipped"] >= 1


def test_train_fp16_phase_fails_a_changed_parameter(training_on_cpu,
                                                    monkeypatch):
    """A scaler that moves a parameter on a skipped step fails the
    phase."""
    monkeypatch.setattr(cs, "FP16_INIT_SCALE", 2.0 ** 28)
    monkeypatch.setattr(cs, "FP16_STEPS", 4)

    class Leaky(cs.GradScaler):
        def step(self, optimizer):
            if self._found_inf:
                with torch.no_grad():
                    optimizer._parameter_list[0].view(-1)[0] += 1.0
            super().step(optimizer)

    monkeypatch.setattr(cs, "GradScaler", Leaky)
    with pytest.raises(AssertionError, match="skipped step changed"):
        cs.phase_train_fp16(CPU)


def test_remat_phase(training_on_cpu):
    got = cs.phase_remat(CPU)
    assert set(got) == {str(p) for p in cs.REMAT_POLICIES}
    for r in got.values():
        assert r["max_rel_loss_diff"] <= cs.TRAIN_LOSS_RTOL
    # full remat recomputes the attention forward in the backward
    flash_fwd = cs.fa.KERNEL_NAMES[0]
    assert got["True"]["launches"][flash_fwd] > got["False"]["launches"][
        flash_fwd]


def test_adam_lowmem_phase(training_on_cpu, monkeypatch):
    monkeypatch.setattr(cs, "ADAM_XL_CFG", {
        **cs.ADAM_XL_CFG, "vocab_size": 512, "hidden_size": 64,
        "num_hidden_layers": 2, "num_attention_heads": 1,
        "intermediate_size": 256, "max_position_embeddings": 128,
        "loss_chunks": 2})
    monkeypatch.setattr(cs, "ADAM_XL_SEQ", 128)
    got = cs.phase_adam_lowmem(CPU)
    assert got["lowmem"]["state_bytes"] < got["full"]["state_bytes"] / 2


def test_generate_phase(training_on_cpu, monkeypatch):
    monkeypatch.setattr(cs, "GEN_BATCH", 2)
    monkeypatch.setattr(cs, "GEN_PROMPT", 16)
    monkeypatch.setattr(cs, "GEN_NEW", 8)
    got = cs.phase_generate(CPU)
    assert set(got["ms_per_token"]) == {"greedy", "sampled"}


def test_flash_rows_f16(monkeypatch):
    """The float16 flash rows at a small shape: every key of the
    contract, float16 sources in the repository, the bound at the
    16-bit tensor-core rate."""
    fa = cs.fa
    monkeypatch.setattr(cs, "time_cuda", _once)
    monkeypatch.setattr(cs, "FLASH_TRAIN", (1, 2, 96, 96, 64))
    for name in ("fwd", "bwd_dkdv", "bwd_dq"):
        monkeypatch.setattr(fa, f"flash_{name}_cuda",
                            getattr(fa, f"flash_{name}_ref"))
    monkeypatch.setattr(cs.F, "scaled_dot_product_attention",
                        lambda q, k, v, is_causal: fa.flash_fwd_ref(
                            q, k, v, q.shape[-1] ** -0.5, is_causal)[0])
    errors = {(n, "float16"): 1e-3 for n in fa.KERNEL_NAMES}
    rows = cs.flash_rows_f16(CPU, {n: 144 for n in fa.KERNEL_NAMES}, errors)
    root = cs.os.path.dirname(cs.os.path.abspath(cs.__file__))
    for row, name in zip(rows, fa.KERNEL_NAMES):
        assert row["name"] == f"{name}_f16" and row["launches"] == 144
        assert row["source"].endswith("_f16.cu")
        assert cs.os.path.exists(cs.os.path.join(root, row["source"]))
        assert row["dtype"] == "float16" and row["max_abs_err"] == 1e-3
        for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "replaces"):
            assert key in row
    nbytes, flops = cs.flash_work((1, 2, 96, 96, 64), torch.float16)[
        fa.KERNEL_NAMES[0]]
    assert cs.flash_bound(nbytes, flops, torch.float16) == cs.flash_bound(
        nbytes, flops, torch.bfloat16)
