"""A CPU rehearsal of ``chip_smoke.py``'s BERT, incubate, geometric,
Paddle-idiom and audio phases (``tests/_torch_rehearsal.py``):

- the BERT, incubate and geometric phases at CPU sizes (BERT at d 128,
  2 layers, 2 heads of 64, vocab 512; GPT-3 XL's stack cut to the same
  heads, 2 layers, 2 x 128 tokens; an ogbn-arxiv-shaped graph of 600
  nodes and 4000 edges): BERT fine-tuning's first AdamW and Lamb steps
  against themselves (a gradient 5% off fails), its dropout launches
  counted (100 a step at BERT-base's depth, 20 at 2 layers), Lamb and
  LookAhead with ModelAverage (restore bit-exact); BERT inference with
  a flash launch a layer a forward; the fused layers against the
  unfused; every geometric op and the two-hop sampler's properties; the
  incubate tail (ASP, checkpoint, reduce_tensor, Viterbi);
- the Paddle-idiom phase on BERT at 2 layers and d 64: the global
  truncated-normal initializer's bounds and std, ``init_weights``
  through ``set_value``, the first steps against themselves, the hand
  loop's float32 dropout shapes held to the plain version, its losses
  equal to ``TrainStep``'s on the same dropout keys, its dropout
  launches, and every gradient cleared (a gradient left after
  ``clear_gradients`` fails);
- the audio phase on 2 clips of 0.5 s at the PANNs settings: the
  log-mel front end and MFCCs against the CPU float64 run, the fft
  functions, the STFT round trip (a mel bin 1e-3 off fails).
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_rehearsal import (  # noqa: E402,F401
    CPU, audio_on_cpu, bert_on_cpu, cpu_card, cs, idiom_on_cpu, np, paddle,
    training_on_cpu, vision_on_cpu)
from _torch_threads import one_thread  # noqa: E402,F401


def test_bert_finetune_phase(bert_on_cpu):
    got = cs.phase_bert_finetune(CPU)
    for kind in ("AdamW", "Lamb"):
        first = got["first_step"][kind]
        assert first["logits"] == first["loss"] == 0.0
        assert 0.0 < first["grads"] <= 1.0
        assert first["update"] <= cs.BERT_UPDATE_TOL
    assert got["dropout_launches"] == 2 * (2 + 4 * 2) * 3
    assert all(np.isfinite(got["losses"])) and len(got["losses"]) == 6


def test_bert_finetune_phase_fails_a_wrong_gradient(bert_on_cpu,
                                                    monkeypatch):
    """The "card" model's backward 5% off in the first AdamW step (the
    second model built, after the main path's): the first step's
    gradient check fails."""
    make, built = cs.BertForSequenceClassification, []

    def once(*args, **kw):
        model = make(*args, **kw)
        if len(built) == 1:
            for p in model.parameters():
                p.register_hook(lambda g: g * 1.05)
        built.append(model)
        return model

    monkeypatch.setattr(cs, "BertForSequenceClassification", once)
    with pytest.raises(AssertionError, match="'grads': "):
        cs.phase_bert_finetune(CPU)


def test_bert_infer_phase(bert_on_cpu):
    got = cs.phase_bert_infer(CPU)
    assert got["launches"] == 2 * 2 and got["flash_err"] == 0.0
    assert got["pooled_err"] == 0.0 and got["sequences_per_s"] > 0


def test_fused_layers_phase(bert_on_cpu):
    got = cs.phase_fused_layers(CPU)
    assert got["stack_err"] <= cs.FUSED_TOL and got["ln_err"] == 0.0
    assert 0.0 < got["fmt_rms"] <= cs.FMT_TOL and got["launches"] == 2 * 2
    assert got["flash_err"] == 0.0


def test_geometric_phase(bert_on_cpu):
    got = cs.phase_geometric(CPU)
    assert max(got["errs"].values()) == 0.0 and len(got["errs"]) == 15
    assert got["sampled_edges"] > 0 and got["nodes"] >= cs.GEO_SEEDS


def test_incubate_misc_phase(bert_on_cpu):
    got = cs.phase_incubate_misc(CPU)
    assert got["jacobian_err"] == got["hessian_err"] == 0.0
    assert got["attn_errs"] == [0.0, 0.0, 0.0]
    assert got["attn_launches"] == {"flash_attention_fwd": 3,
                                    "flash_attention_bwd_dkdv": 2,
                                    "flash_attention_bwd_dq": 2}
    assert got["viterbi_score_err"] == 0.0 and got["asp_weights"] > 0


def test_paddle_idiom_phase(idiom_on_cpu, monkeypatch):
    held, hold = [], cs.dropout_at_path_shapes

    def recorded(device, cases, seed=70):
        held.extend((tuple(shape), *rest) for _, shape, *rest in cases)
        return hold(device, cases, seed)

    monkeypatch.setattr(cs, "dropout_at_path_shapes", recorded)
    got = cs.phase_paddle_idiom(CPU)
    # the loop's float32 dropout shapes (2 layers, d 64, one head, 4 x 32
    # rows) held to the plain version
    assert ((4, 1, 32, 32), cs.DROPOUT_P) in held
    assert ((4, 32, 64), cs.DROPOUT_P) in held
    assert got["loss_rel"] == 0.0           # the same arithmetic on the CPU
    assert got["dropout_launches"] == 2 * 2 * (2 + 4 * 2) * 4
    assert abs(got["init"]["pooled_std_off"]) <= cs.IDIOM_STD_TOL
    assert got["init"]["entries"] > 100_000
    for kind in ("AdamW", "Lamb"):
        assert got["first"][kind]["logits"] == 0.0
    assert len(got["losses"]) == 4 and all(np.isfinite(got["losses"]))
    # the stand-in events: 1 ms a step
    assert got["timer_ms"] == (float(cs.IDIOM_STEPS),) * 2


def test_paddle_idiom_phase_fails_a_gradient_not_cleared(idiom_on_cpu,
                                                         monkeypatch):
    """``clear_gradients`` that leaves the gradients in place fails the
    check after the first step."""
    monkeypatch.setattr(paddle.optimizer.Optimizer, "clear_gradients",
                        lambda self, set_to_zero=False: None)
    with pytest.raises(AssertionError, match="left"):
        cs.phase_paddle_idiom(CPU)


def test_audio_phase(audio_on_cpu):
    got = cs.phase_audio(CPU)
    assert got["mel_err"] <= cs.AUDIO_MEL_TOL
    assert got["db_err"] <= cs.AUDIO_DB_TOL
    assert len(got["fft_errs"]) == 22
    assert max(got["fft_errs"].values()) == 0.0   # the CPU against itself
    assert got["istft_err"] <= cs.AUDIO_ISTFT_TOL
    assert got["bound_ms"] > 0 and got["clips_per_s"] > 0


def test_audio_phase_fails_a_mel_bin_off(audio_on_cpu, monkeypatch):
    """The "card" front end's filterbank with one mel bin 1e-3 off (the
    first filterbank built) fails the comparison with the float64 run."""
    from paddle_tpu_torch.audio import functional as AF

    make, built = AF.compute_fbank_matrix, []

    def once(*args, **kw):
        fb = make(*args, **kw)
        if not built:
            fb[10] *= 1 + 1e-3
        built.append(fb)
        return fb

    monkeypatch.setattr(AF, "compute_fbank_matrix", once)
    with pytest.raises(AssertionError, match="PANNs front end"):
        cs.phase_audio(CPU)
