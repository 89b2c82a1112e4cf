"""A CPU rehearsal of ``chip_smoke.py``'s sequence, op-surface, vision
and offload phases (``tests/_torch_rehearsal.py``):

- Transformer-base training and decoding cut to d 64 (one head of 64),
  2 + 2 layers (another dropout mask, a wrong gradient, a planted
  dropout bit, a planted decode error and a changed launch count each
  fail), and the LSTM LM (a zeroed LSTM fails);
- the op sweep (every op and every Paddle ``Tensor`` method on the
  "card" against the CPU; ``tpu()`` asked for the card, here the CPU),
  where an op whose result leaves the device fails;
- the vision and offload phases at CPU sizes: MobileNetV3-Large's first
  step against itself and its dropout launches (a gradient 5% off
  fails), two zoo factories, every detection op (SSD300's own maps,
  8732 priors; roi_align 1e-4 off on the card fails), the offload
  optimizer bit-equal to AdamW (a learning rate a few ulps off fails)
  and the tensor checker's raises.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_rehearsal import (  # noqa: E402,F401
    CPU, SEQ_NMT, _OtherMask, _first_built, _zero_output, cpu_card, cs, i8, np,
    paddle, plain_kernels, seq_on_cpu, training_on_cpu, vision_on_cpu)
from _torch_threads import one_thread  # noqa: E402,F401


def test_transformer_train_phase(seq_on_cpu):
    """Eager Adam + Noam steps: finite losses, the first step's logits,
    loss, gradients and update equal to the "CPU" step's, a rerun
    bit-equal, dropout launches and no flash launch (attention dropout),
    the padding mask within tolerance."""
    got = cs.phase_transformer_train(CPU)
    assert len(got["losses"]) == cs.NMT_WARM + cs.NMT_STEPS
    assert got["loss_rel"] == 0.0                 # the CPU against itself
    first = got["first_step"]
    assert first["logits"] == first["grads"] == first["update"] == 0.0
    assert 0.0 < first["update_covered"] <= 1.0
    assert got["launches"]["flash"] == 0 and got["launches"]["dropout"] > 0
    assert got["pad_err"] <= cs.NMT_PAD_TOL and got["busy_share"] is None


def test_transformer_train_phase_fails_another_dropout_mask(seq_on_cpu,
                                                            monkeypatch):
    """The card's embedding dropout drawing another mask (same rate):
    the first step's logits check fails."""
    _first_built(monkeypatch, "make_nmt",
                 lambda m: setattr(m, "drop", _OtherMask(SEQ_NMT["dropout"])))
    with pytest.raises(AssertionError, match="Transformer-base first step"):
        cs.phase_transformer_train(CPU)


def test_transformer_train_phase_fails_a_wrong_gradient(seq_on_cpu,
                                                        monkeypatch):
    """A backward 5% off on the card (the forward right): the first
    step's gradient check fails."""
    def plant(model):
        for p in model.parameters():
            p.register_hook(lambda g: g * 1.05)

    _first_built(monkeypatch, "make_nmt", plant)
    with pytest.raises(AssertionError, match="'grads'"):
        cs.phase_transformer_train(CPU)


def test_transformer_train_phase_fails_a_planted_dropout_bit(seq_on_cpu,
                                                             monkeypatch):
    """The dropout stand-in one bit off: the path-shape check before the
    path fails."""
    kernel = cs.dk.dropout_cuda

    def wrong(x, key, p, mask_shape=None, upscale=True):
        out = kernel(x, key, p, mask_shape, upscale).clone()
        out.view(-1)[3] += 1.0
        return out

    monkeypatch.setattr(cs.dk, "dropout_cuda", wrong)
    with pytest.raises(AssertionError, match="differ from the plain"):
        cs.phase_transformer_train(CPU)


def test_transformer_decode_phase(seq_on_cpu):
    """Greedy decode through Cache: layers x (1 + 2 x steps) flash
    launches, logits equal to the plain route's and the full decoder's."""
    got = cs.phase_transformer_decode(CPU)
    assert got["launches"] == SEQ_NMT["layers"] * (
        1 + 2 * cs.NMT_DECODE_STEPS)
    assert got["step_err"] == 0.0 and got["full_err"] <= cs.NMT_DECODE_TOL


def test_transformer_decode_phase_fails_a_planted_error(seq_on_cpu,
                                                        monkeypatch):
    """The flash stand-in off by 1e-3: the decode's logits check fails."""
    run = cs.fa.flash_fwd_cuda

    def off(*args):
        o, lse = run(*args)
        return o + 1e-3, lse

    monkeypatch.setattr(cs.fa, "flash_fwd_cuda", off)
    with pytest.raises(AssertionError, match="decode logits"):
        cs.phase_transformer_decode(CPU)


def test_transformer_decode_phase_fails_a_changed_launch_count(
        seq_on_cpu, monkeypatch):
    """One decode step without the cache's flash launch (the cached
    self-attention routed elsewhere) changes the count: the phase fails."""
    real = cs.attn._flash_eligible
    monkeypatch.setattr(cs.attn, "_flash_eligible",
                        lambda q, k, m, p: real(q, k, m, p)
                        and q.shape[1] != 1)
    with pytest.raises(AssertionError, match="decode launches"):
        cs.phase_transformer_decode(CPU)


def test_lstm_lm_phase(seq_on_cpu):
    got = cs.phase_lstm_lm(CPU)
    assert got["loss_rel"] == 0.0 and got["dropout_launches"] > 0
    first = got["first_step"]
    assert first["logits"] == first["states"] == 0.0
    assert first["grads"] == first["update"] == 0.0
    assert got["lstm_signal"] > 0.0
    ids = np.asarray(got["beam_ids"])
    assert ids.shape[0] == 1 and ids.shape[2] == cs.BEAM_SIZE


def test_lstm_lm_phase_fails_a_zeroed_lstm(seq_on_cpu, monkeypatch):
    """The card's LSTM giving zeros: the first step's logits check fails
    (its loss alone sits near ln V either way)."""
    _first_built(monkeypatch, "make_lstm_lm", lambda m: _zero_output(m.lstm))
    with pytest.raises(AssertionError, match="LSTM LM first step"):
        cs.phase_lstm_lm(CPU)


def test_op_surface_phase(seq_on_cpu):
    got = cs.phase_op_surface(CPU)
    assert got["ops"] == len(cs.OP_SWEEP)
    assert got["methods"] == len(cs.METHOD_SWEEP) == 51
    assert max(got["worst"].values()) == 0.0       # the CPU against itself
    assert got["int8_launches"] == {i8.INT8_MATMUL_KERNEL: 2,
                                    i8.QUANTIZE_ROWS_KERNEL: 2}


def test_op_surface_phase_fails_an_op_that_leaves_the_device(seq_on_cpu,
                                                             monkeypatch):
    """An op whose result lands on another device than the one asked
    for (here the meta device, standing in for the host) fails."""
    flip = paddle.flip
    monkeypatch.setattr(paddle, "flip",
                        lambda *a, **k: flip(*a, **k).to("meta"))
    with pytest.raises(AssertionError, match="not the card"):
        cs.phase_op_surface(CPU)


def test_vision_train_phase(vision_on_cpu):
    """MobileNetV3-Large: the first step against itself (errors 0), the
    dropout stand-in held to the plain version, two launches a step."""
    got = cs.phase_vision_train(CPU)
    first = got["first_step"]
    assert first["logits"] == first["loss"] == 0.0
    # the "card" step is the float32 CPU step itself: its error against
    # float64 is the CPU's own
    assert first["grads_card"] == first["grads_cpu32"] > 0.0
    assert 0.0 < first["grads"] <= 1.0 and 0.0 < first["update"] <= 1.0
    assert got["dropout_launches"] == 2 * (cs.RESNET_WARMUP + cs.RESNET_STEPS)
    assert all(np.isfinite(got["losses"])) and got["busy_share"] is None


def test_vision_train_phase_fails_a_wrong_gradient(vision_on_cpu,
                                                   monkeypatch):
    """The card's backward 5% off: the first step's gradient check
    fails."""
    make = cs.vmodels.mobilenet_v3_large
    built = []

    def once(*args, **kw):
        model = make(*args, **kw)
        if not built:
            for p in model.parameters():
                p.register_hook(lambda g: g * 1.05)
        built.append(model)
        return model

    monkeypatch.setattr(cs.vmodels, "mobilenet_v3_large", once)
    with pytest.raises(AssertionError, match="'grads': "):
        cs.phase_vision_train(CPU)


def test_vision_zoo_phase(vision_on_cpu):
    got = cs.phase_vision_zoo(CPU)
    assert set(got) == {"squeezenet1_1", "googlenet"}
    assert all(v["logit_err"] == 0.0 and v["images_per_s"] > 0
               for v in got.values())


def test_detection_ops_phase(vision_on_cpu):
    """Every op on the "card" (the CPU) against the CPU: all equal, a
    time for each, SSD300's 8732 priors through multi_box_head."""
    got = cs.phase_detection_ops(CPU)
    assert max(got["errs"].values()) == 0.0
    for name in ("roi_align", "roi_pool", "psroi_pool", "deform_conv2d",
                 "yolo_box", "yolo_loss", "box_coder"):
        assert got["times"][name]["bound_ms"] > 0, name
    for name in ("generate_proposals", "prior_box", "nms", "matrix_nms"):
        assert got["times"][name]["host_ms"] > 0, name
    assert any(k.startswith("multi_box_head") for k in got["errs"])
    assert "decode_jpeg" not in got["errs"] and got["jpeg"].startswith("PIL")


def test_detection_ops_phase_fails_a_planted_error(vision_on_cpu,
                                                   monkeypatch):
    """roi_align 1e-4 off on the first (card) call only: the comparison
    fails."""
    real, calls = cs.vops.roi_align, []

    def off(*args, **kw):
        calls.append(1)
        out = real(*args, **kw)
        return out + 1e-4 if len(calls) == 1 else out

    monkeypatch.setattr(cs.vops, "roi_align", off)
    with pytest.raises(AssertionError, match="roi_align"):
        cs.phase_detection_ops(CPU)


def test_offload_phase(vision_on_cpu):
    got = cs.phase_offload(CPU)
    assert got["copies"]["h2d_bytes"] == got["copies"]["d2h_bytes"] > 0
    assert got["copies"]["device_ms"] is None            # no side stream
    assert all(np.isfinite(got["losses"]))


def test_offload_phase_fails_a_changed_update(vision_on_cpu, monkeypatch):
    """The offload optimizer's learning rate 2^-20 relative off (a few
    float32 ulps): the bit-equality with AdamW fails."""
    lr = cs.HostOffloadAdamW.get_lr
    monkeypatch.setattr(cs.HostOffloadAdamW, "get_lr",
                        lambda self: lr(self) * (1 + 2 ** -20))
    with pytest.raises(AssertionError, match="offload"):
        cs.phase_offload(CPU)


def test_amp_debugging_phase(vision_on_cpu):
    got = cs.phase_amp_debugging(CPU)
    assert got["raised"] == ["eager step", "to_static first call",
                             "to_static second call"]
    assert got["counts"][0] > 0 and got["counts"][1] > 0
