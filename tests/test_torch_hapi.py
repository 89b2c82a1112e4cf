"""The port's high-level training path against the JAX package's, on the CPU.

The same seeded numpy inputs, and the same weights (the JAX layers'
``state_dict`` carried over with ``layer_state_from_jax``), go through
``paddle_tpu`` and ``paddle_tpu_torch``:

- every loss form (``cross_entropy`` with hard ``[N]`` / ``[N, 1]`` /
  ``[N, T]`` labels, ``ignore_index``, class weights, soft labels,
  smoothing, ``use_softmax=False`` and ``axis``; ``softmax_with_cross_
  entropy``, ``nll_loss``, ``mse_loss``, ``l1_loss``, ``smooth_l1_loss``,
  the two binary cross-entropies, ``kl_div``, ``margin_ranking_loss``)
  and each loss layer: values and input gradients at 1e-6 in float32;
- the metrics (``Accuracy`` top-1/5, ``Precision``, ``Recall``, ``Auc``,
  ``accuracy``): equal;
- ``paddle.save`` / ``load``: a file written by each package loads in the
  other (float32, int64, nested containers), bfloat16 round trips in the
  port bit for bit and reads as its float32 values in the JAX package;
  ``set_flags`` / ``get_flags`` and ``FLAGS_check_nan_inf``;
- ``Model`` on the JAX tests' ``ToyData`` and ``Sequential``
  (``tests/test_hapi.py``) with ``shuffle=False``: per-batch losses of
  ``fit`` at 1e-5 (eager and ``jit=True``), ``evaluate`` and ``predict``
  (also ``stack_outputs``), the callback event sequence, early stop and
  the LR decisions (``ReduceLROnPlateau``, ``LRScheduler`` by epoch and
  by step) equal, ``ModelCheckpoint`` files, a ``.pdparams`` written by
  each package's ``Model.save`` loaded by the other's ``Model.load``,
  the logger's lines;
- ``summary`` text and ``flops`` for LeNet and resnet18 equal, and
  ResNet-50's at (1, 3, 224, 224) equal to the figures that
  ``chip_smoke.py`` pins for the card;
- the verify recipe (LeNet over ``FakeData`` through ``DataLoader``).
"""
import contextlib
import hashlib
import io
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import chip_smoke as cs  # noqa: E402
import paddle_tpu as jp  # noqa: E402
import paddle_tpu.metric as jmetric  # noqa: E402
import paddle_tpu.nn as jnn  # noqa: E402
import paddle_tpu.nn.functional as JF  # noqa: E402
import paddle_tpu.nn.initializer as jinit  # noqa: E402
from paddle_tpu.hapi import callbacks as jcb  # noqa: E402
from paddle_tpu.vision.models import LeNet as JLeNet  # noqa: E402
from paddle_tpu.vision.models import resnet as jresnet  # noqa: E402

import paddle_tpu_torch as tp  # noqa: E402
import paddle_tpu_torch.metric as tmetric  # noqa: E402
import paddle_tpu_torch.nn as tnn  # noqa: E402
import paddle_tpu_torch.nn.functional as TF  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.hapi import callbacks as tcb  # noqa: E402
from paddle_tpu_torch.vision.models import LeNet as TLeNet  # noqa: E402
from paddle_tpu_torch.vision.models import layer_state_from_jax  # noqa: E402
from paddle_tpu_torch.vision.models import resnet as tresnet  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

LOSS_TOL = 1e-6
FIT_TOL = 1e-5


@pytest.fixture(autouse=True)
def cpu():
    saved = tdevice._CURRENT[0]
    tp.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


def _arrays(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _carry(jlayer, tlayer):
    return layer_state_from_jax(_arrays(jlayer), tlayer)


# --------------------------------------------------------------- losses ---


_R = np.random.RandomState(0)
LOGITS = _R.randn(6, 5).astype(np.float32)
LOGITS3 = _R.randn(2, 4, 5).astype(np.float32)
LABELS = np.array([0, 3, 4, 1, 2, 4], np.int64)
LABELS_IGN = np.array([0, -100, 4, 1, -100, 4], np.int64)
SOFT = np.abs(_R.randn(6, 5)).astype(np.float32)
SOFT /= SOFT.sum(-1, keepdims=True)
WEIGHT = np.array([0.5, 1.0, 2.0, 0.25, 1.5], np.float32)
PROBS = (1 / (1 + np.exp(-_R.randn(6, 5)))).astype(np.float32)
BIN = (_R.rand(6, 5) > 0.5).astype(np.float32)
A, B = _R.randn(6).astype(np.float32), _R.randn(6).astype(np.float32)
SIGN = np.sign(_R.randn(6)).astype(np.float32)
POSW = np.abs(_R.randn(5)).astype(np.float32)
LABELS3 = _R.randint(0, 5, (2, 4)).astype(np.int64)


# name -> (fn(F, *tensors), [arrays]); the first array takes a gradient
LOSSES = {
    "ce_mean": (lambda F, x, y: F.cross_entropy(x, y), [LOGITS, LABELS]),
    "ce_sum": (lambda F, x, y: F.cross_entropy(x, y, reduction="sum"),
               [LOGITS, LABELS]),
    "ce_none": (lambda F, x, y: F.cross_entropy(x, y, reduction="none"),
                [LOGITS, LABELS]),
    "ce_n1_labels": (lambda F, x, y: F.cross_entropy(x, y),
                     [LOGITS, LABELS[:, None]]),
    "ce_ignore": (lambda F, x, y: F.cross_entropy(x, y),
                  [LOGITS, LABELS_IGN]),
    "ce_all_ignored": (lambda F, x, y: F.cross_entropy(x, y * 0 - 100),
                       [LOGITS, LABELS]),
    "ce_weight_mean": (lambda F, x, y, w: F.cross_entropy(x, y, weight=w),
                       [LOGITS, LABELS_IGN, WEIGHT]),
    "ce_weight_sum": (lambda F, x, y, w: F.cross_entropy(
        x, y, weight=w, reduction="sum"), [LOGITS, LABELS, WEIGHT]),
    "ce_weight_none": (lambda F, x, y, w: F.cross_entropy(
        x, y, weight=w, reduction="none"), [LOGITS, LABELS, WEIGHT]),
    "ce_smooth": (lambda F, x, y: F.cross_entropy(x, y,
                                                  label_smoothing=0.1),
                  [LOGITS, LABELS_IGN]),
    "ce_soft": (lambda F, x, y: F.cross_entropy(x, y, soft_label=True),
                [LOGITS, SOFT]),
    "ce_soft_smooth_weight": (lambda F, x, y, w: F.cross_entropy(
        x, y, soft_label=True, label_smoothing=0.2, weight=w,
        reduction="sum"), [LOGITS, SOFT, WEIGHT]),
    "ce_no_softmax": (lambda F, x, y: F.cross_entropy(
        x, y, use_softmax=False), [PROBS, LABELS]),
    "ce_axis1": (lambda F, x, y: F.cross_entropy(x, y, axis=1),
                 [LOGITS, LABELS]),
    "ce_3d": (lambda F, x, y: F.cross_entropy(x, y), [LOGITS3, LABELS3]),
    "swce": (lambda F, x, y: F.softmax_with_cross_entropy(x, y[:, None]),
             [LOGITS, LABELS]),
    "swce_softmax": (lambda F, x, y: F.softmax_with_cross_entropy(
        x, y[:, None], return_softmax=True)[1], [LOGITS, LABELS]),
    "nll_mean": (lambda F, x, y: F.nll_loss(x, y), [LOGITS, LABELS_IGN]),
    "nll_weight": (lambda F, x, y, w: F.nll_loss(x, y, weight=w),
                   [LOGITS, LABELS_IGN, WEIGHT]),
    "nll_sum": (lambda F, x, y: F.nll_loss(x, y, reduction="sum"),
                [LOGITS, LABELS]),
    "nll_none_weight": (lambda F, x, y, w: F.nll_loss(
        x, y, weight=w, reduction="none"), [LOGITS, LABELS, WEIGHT]),
    "mse": (lambda F, x, y: F.mse_loss(x, y), [LOGITS, SOFT]),
    "mse_none": (lambda F, x, y: F.mse_loss(x, y, reduction="none"),
                 [LOGITS, SOFT]),
    "l1_sum": (lambda F, x, y: F.l1_loss(x, y, reduction="sum"),
               [LOGITS, SOFT]),
    "smooth_l1": (lambda F, x, y: F.smooth_l1_loss(x, y, delta=0.5),
                  [LOGITS, SOFT]),
    "smooth_l1_none": (lambda F, x, y: F.smooth_l1_loss(
        x, y, reduction="none"), [LOGITS, SOFT]),
    "bce": (lambda F, x, y: F.binary_cross_entropy(x, y), [PROBS, BIN]),
    "bce_weight_none": (lambda F, x, y, w: F.binary_cross_entropy(
        x, y, weight=w, reduction="none"), [PROBS, BIN, WEIGHT]),
    "bce_logits": (lambda F, x, y: F.binary_cross_entropy_with_logits(x, y),
                   [LOGITS, BIN]),
    "bce_logits_pos_weight": (lambda F, x, y, w, pw:
                              F.binary_cross_entropy_with_logits(
                                  x, y, weight=w, pos_weight=pw,
                                  reduction="sum"),
                              [LOGITS, BIN, WEIGHT, POSW]),
    "kl_mean": (lambda F, x, y: F.kl_div(x, y), [LOGITS, SOFT]),
    "kl_batchmean": (lambda F, x, y: F.kl_div(x, y, reduction="batchmean"),
                     [LOGITS, SOFT * (SOFT > 0.2)]),
    "kl_sum": (lambda F, x, y: F.kl_div(x, y, reduction="sum"),
               [LOGITS, SOFT]),
    "margin_ranking": (lambda F, a, b, y: F.margin_ranking_loss(
        a, b, y, margin=0.3), [A, B, SIGN]),
    "margin_ranking_none": (lambda F, a, b, y: F.margin_ranking_loss(
        a, b, y, reduction="none"), [A, B, SIGN]),
}


def _run_loss(pkg, fn, arrays):
    F = JF if pkg is jp else TF
    ts = [pkg.to_tensor(a) for a in arrays]
    ts[0].stop_gradient = False
    out = fn(F, *ts)
    total = out.sum() if pkg is tp else jp.sum(out)
    total.backward()
    return np.asarray(out.numpy()), np.asarray(ts[0].grad.numpy())


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_jax(name):
    fn, arrays = LOSSES[name]
    jv, jg = _run_loss(jp, fn, arrays)
    tv, tg = _run_loss(tp, fn, arrays)
    assert tv.shape == jv.shape
    np.testing.assert_allclose(tv, jv, rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(tg, jg, rtol=LOSS_TOL, atol=LOSS_TOL)


LAYERS = {
    "CrossEntropyLoss": (lambda n: n.CrossEntropyLoss(ignore_index=1,
                                                      reduction="sum"),
                         [LOGITS, LABELS]),
    "MSELoss": (lambda n: n.MSELoss("sum"), [LOGITS, SOFT]),
    "L1Loss": (lambda n: n.L1Loss(), [LOGITS, SOFT]),
    "SmoothL1Loss": (lambda n: n.SmoothL1Loss(delta=2.0), [LOGITS, SOFT]),
    "NLLLoss": (lambda n: n.NLLLoss(ignore_index=4), [LOGITS, LABELS]),
    "BCELoss": (lambda n: n.BCELoss(), [PROBS, BIN]),
    "BCEWithLogitsLoss": (lambda n: n.BCEWithLogitsLoss(reduction="none"),
                          [LOGITS, BIN]),
    "KLDivLoss": (lambda n: n.KLDivLoss("batchmean"), [LOGITS, SOFT]),
    "MarginRankingLoss": (lambda n: n.MarginRankingLoss(0.1),
                          [A, B, SIGN]),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_loss_layer_matches_jax(name):
    build, arrays = LAYERS[name]
    jv, jg = _run_loss(jp, lambda F, *t: build(jnn)(*t), arrays)
    tv, tg = _run_loss(tp, lambda F, *t: build(tnn)(*t), arrays)
    np.testing.assert_allclose(tv, jv, rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(tg, jg, rtol=LOSS_TOL, atol=LOSS_TOL)


def test_loss_under_o2_is_float32():
    x = tp.to_tensor(LOGITS).astype("bfloat16")
    with tp.amp.auto_cast(level="O2", dtype="bfloat16"):
        loss = TF.cross_entropy(x, tp.to_tensor(LABELS))
        mse = TF.mse_loss(x, tp.to_tensor(SOFT))
    assert loss.dtype == mse.dtype == torch.float32


# -------------------------------------------------------------- metrics ---


def test_metrics_match_jax():
    rng = np.random.RandomState(3)
    pred = rng.randn(40, 10).astype(np.float32)
    label = rng.randint(0, 10, (40, 1)).astype(np.int64)
    probs = rng.rand(40).astype(np.float32)
    bins = (rng.rand(40) > 0.4).astype(np.int64)
    got = []
    for pkg, m in ((jp, jmetric), (tp, tmetric)):
        acc = m.Accuracy(topk=(1, 5))
        out = [acc.update(acc.compute(pkg.to_tensor(pred[i:i + 8]),
                                      pkg.to_tensor(label[i:i + 8])))
               for i in range(0, 40, 8)]
        prec, rec, auc = m.Precision(), m.Recall(), m.Auc()
        for metric in (prec, rec, auc):
            metric.update(probs, bins)
        auc2 = m.Auc(num_thresholds=31)
        auc2.update(np.stack([1 - probs, probs], 1), bins)
        one = float(m.accuracy(pkg.to_tensor(pred), pkg.to_tensor(label),
                               k=3).numpy())
        got.append((out, acc.accumulate(), acc.name(), prec.accumulate(),
                    rec.accumulate(), auc.accumulate(), auc2.accumulate(),
                    one))
    assert got[0] == got[1]
    t = tmetric.accuracy(tp.to_tensor(pred), tp.to_tensor(label))
    assert isinstance(t, tp.Tensor) and t.dtype == torch.float32


# ------------------------------------------------------ save, load, flags ---


def _nest(pkg):
    return {"w": pkg.to_tensor(LOGITS),
            "step": pkg.to_tensor(np.array([7, 8], np.int64)),
            "inner": [pkg.to_tensor(A), (1, "a")], "lr": 0.5}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pdparams_interchange(tmp_path, writer):
    path = str(tmp_path / "sub" / "state.pdparams")
    (jp if writer == "jax" else tp).save(_nest(jp if writer == "jax"
                                               else tp), path)
    for pkg in (jp, tp):
        got = pkg.load(path)
        np.testing.assert_array_equal(got["w"].numpy(), LOGITS)
        assert got["step"].numpy().tolist() == [7, 8]
        np.testing.assert_array_equal(got["inner"][0].numpy(), A)
        assert got["inner"][1] == (1, "a") and got["lr"] == 0.5
    raw = tp.load(path, return_numpy=True)
    assert isinstance(raw["w"], np.ndarray)


def test_bfloat16_save_load(tmp_path):
    x = tp.to_tensor(LOGITS).astype("bfloat16")
    tp.save({"x": x}, str(tmp_path / "b.pdparams"))
    back = tp.load(str(tmp_path / "b.pdparams"))["x"]
    assert back.dtype == torch.bfloat16 and torch.equal(back, x)
    jx = jp.load(str(tmp_path / "b.pdparams"))["x"]
    np.testing.assert_array_equal(np.asarray(jx.numpy()), x.float().numpy())
    # a JAX bfloat16 file unpickles where ml_dtypes is installed
    jp.save({"x": jp.to_tensor(LOGITS).astype("bfloat16")},
            str(tmp_path / "j.pdparams"))
    got = tp.load(str(tmp_path / "j.pdparams"))["x"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, x)


def test_flags(monkeypatch):
    assert tp.get_flags() == jp.get_flags()
    with pytest.raises(ValueError):
        tp.get_flags("FLAGS_nope")
    with pytest.raises(ValueError):
        tp.set_flags({"nope": 1})
    saved = torch.backends.cudnn.deterministic
    bad = np.array([1.0, -1.0], np.float32)
    try:
        tp.set_flags({"FLAGS_check_nan_inf": True,
                      "FLAGS_cudnn_deterministic": True})
        jp.set_flags({"FLAGS_check_nan_inf": True})
        assert torch.backends.cudnn.deterministic
        for pkg in (jp, tp):
            with pytest.raises(FloatingPointError, match="nan/inf"):
                pkg.log(pkg.to_tensor(bad))
        with pytest.raises(FloatingPointError):
            torch.sqrt(tp.to_tensor(bad))
        assert float(tp.log(tp.to_tensor([2.0])).numpy()[0]) > 0
    finally:
        tp.set_flags({"FLAGS_check_nan_inf": False,
                      "FLAGS_cudnn_deterministic": saved})
        jp.set_flags({"FLAGS_check_nan_inf": False})
    assert np.isnan(tp.log(tp.to_tensor(bad)).numpy()[1])


# ---------------------------------------------------------------- hapi ----


class _Toy:
    """The JAX tests' ``ToyData`` (``tests/test_hapi.py``)."""

    def __init__(self, n=64, seed=0):
        rng = np.random.default_rng(seed)
        self.x = rng.normal(size=(n, 8)).astype("float32")
        w = rng.normal(size=(8, 3)).astype("float32")
        self.y = (self.x @ w).argmax(-1).astype("int64")

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def _toy(pkg, **kw):
    base = (jp.io.Dataset if pkg is jp else tp.io.Dataset)
    return type("ToyData", (_Toy, base), {})(**kw)


def _pair(lr=1e-2, metrics=True, jit=False, sched=None):
    """A JAX and a port ``Model`` of the JAX tests' Sequential, the same
    weights, Adam, CrossEntropyLoss and Accuracy."""
    jnet = jnn.Sequential(jnn.Linear(8, 32), jnn.ReLU(), jnn.Linear(32, 3))
    tnet = tnn.Sequential(tnn.Linear(8, 32), tnn.ReLU(), tnn.Linear(32, 3))
    _carry(jnet, tnet)
    out = []
    for pkg, net, nn in ((jp, jnet, jnn), (tp, tnet, tnn)):
        rate = sched(pkg) if sched is not None else lr
        opt = pkg.optimizer.Adam(rate, parameters=net.parameters())
        m = pkg.Model(net)
        m.prepare(opt, nn.CrossEntropyLoss(),
                  (jmetric if pkg is jp else tmetric).Accuracy()
                  if metrics else None, jit=jit)
        out.append(m)
    return out


@pytest.mark.parametrize("jit", [False, True])
def test_fit_evaluate_predict_match_jax(jit):
    jm, tm = _pair(jit=jit)
    hist = [m.fit(_toy(pkg), epochs=2, batch_size=16, shuffle=False,
                  verbose=0) for pkg, m in ((jp, jm), (tp, tm))]
    np.testing.assert_allclose(hist[1]["loss"], hist[0]["loss"],
                               rtol=FIT_TOL, atol=FIT_TOL)
    assert len(hist[1]["loss"]) == 8
    res = [m.evaluate(_toy(pkg, seed=1), batch_size=16, verbose=0)
           for pkg, m in ((jp, jm), (tp, tm))]
    assert res[0]["acc"] == res[1]["acc"]
    np.testing.assert_allclose(res[1]["loss"], res[0]["loss"], rtol=FIT_TOL)
    outs = [m.predict(_toy(pkg, seed=2), batch_size=16)
            for pkg, m in ((jp, jm), (tp, tm))]
    assert len(outs[1]) == 4
    for j, t in zip(*outs):
        np.testing.assert_allclose(t.numpy(), np.asarray(j.numpy()),
                                   rtol=FIT_TOL, atol=FIT_TOL)
    stacked = tm.predict(_toy(tp, seed=2), batch_size=16,
                         stack_outputs=True)
    assert list(stacked[0].shape) == [64, 3]
    assert torch.equal(stacked[0], torch.cat(outs[1]))


def _spy(cb_mod, events):
    cls = type("Spy", (cb_mod.Callback,), {
        name: (lambda n: lambda self, *a, **k: self._rec(n, *a, **k))(name)
        for name in dir(cb_mod.Callback) if name.startswith("on_")})

    def rec(self, name, *args, logs=None):
        step = args[0] if args and not isinstance(args[0], dict) else None
        if logs is None and args and isinstance(args[-1], dict):
            logs = args[-1]
        events.append((name, step, sorted(logs or {})))
    cls._rec = rec
    return cls()


def test_callback_events_match_jax():
    events = ([], [])
    jm, tm = _pair()
    for pkg, m, cb, ev in ((jp, jm, jcb, events[0]), (tp, tm, tcb, events[1])):
        m.fit(_toy(pkg, n=32), eval_data=_toy(pkg, n=32), epochs=2,
              batch_size=16, shuffle=False, verbose=0,
              callbacks=[_spy(cb, ev)])
        m.predict(_toy(pkg, n=32), batch_size=16, callbacks=[_spy(cb, ev)])
    assert events[0] == events[1]
    assert events[1][0][0] == "on_train_begin"
    assert sum(e[0] == "on_train_batch_end" for e in events[1]) == 4


def _lr_trace(cb_mod, m, trace):
    class Trace(cb_mod.Callback):
        def on_epoch_end(self, epoch, logs=None):
            trace.append(m._optimizer.get_lr())
    return Trace()


def test_early_stop_and_lr_decisions_match_jax():
    got = []
    jm, tm = _pair()
    for pkg, m, cb in ((jp, jm, jcb), (tp, tm, tcb)):
        trace = []
        es = cb.EarlyStopping(monitor="acc", patience=2, verbose=0,
                              save_best_model=False)
        rl = cb.ReduceLROnPlateau(monitor="acc", factor=0.5, patience=1,
                                  verbose=0)
        hist = m.fit(_toy(pkg), eval_data=_toy(pkg, seed=1), epochs=12,
                     batch_size=16, shuffle=False, verbose=0,
                     callbacks=[es, rl, _lr_trace(cb, m, trace)])
        got.append((len(hist["loss"]), m.stop_training, trace, es.wait,
                    rl.wait, es.best))
    assert got[0] == got[1]
    assert got[1][2] != [got[1][2][0]] * len(got[1][2])  # the LR moved


@pytest.mark.parametrize("by", ["epoch", "step"])
def test_lr_scheduler_callback_matches_jax(by):
    def sched(pkg):
        return pkg.optimizer.lr.StepDecay(learning_rate=0.1, step_size=1,
                                          gamma=0.5)
    traces = []
    jm, tm = _pair(sched=sched)
    for pkg, m, cb in ((jp, jm, jcb), (tp, tm, tcb)):
        trace = []
        m.fit(_toy(pkg, n=32), epochs=2, batch_size=16, shuffle=False,
              verbose=0, callbacks=[cb.LRScheduler(by_step=by == "step",
                                                   by_epoch=by == "epoch"),
                                    _lr_trace(cb, m, trace)])
        traces.append(trace)
    assert traces[0] == traces[1]
    assert traces[1][-1] == pytest.approx(0.1 * 0.5 ** (2 if by == "epoch"
                                                        else 4))


def test_checkpoints_and_save_load_interchange(tmp_path):
    jm, tm = _pair()
    for pkg, m, d in ((jp, jm, "j"), (tp, tm, "t")):
        m.fit(_toy(pkg, n=32), epochs=2, batch_size=16, shuffle=False,
              verbose=0, save_dir=str(tmp_path / d), save_freq=1)
        for name in ("0", "1", "final"):
            assert (tmp_path / d / f"{name}.pdparams").exists()
        assert (tmp_path / d / "final.pdopt").exists()
    x = np.random.RandomState(9).randn(5, 8).astype(np.float32)
    want_j = np.asarray(jm.network(jp.to_tensor(x)).numpy())
    want_t = tm.network(tp.to_tensor(x)).detach().numpy()
    # each package's checkpoint loads in the other
    fresh_j, fresh_t = _pair(lr=0.0)
    fresh_j.load(str(tmp_path / "t" / "final"))
    fresh_t.load(str(tmp_path / "j" / "final"))
    np.testing.assert_allclose(
        np.asarray(fresh_j.network(jp.to_tensor(x)).numpy()), want_t,
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        fresh_t.network(tp.to_tensor(x)).detach().numpy(), want_j,
        rtol=1e-6, atol=1e-6)
    # the port's own round trip is bit-equal
    tm.save(str(tmp_path / "again"))
    fresh_t.load(str(tmp_path / "again"))
    assert torch.equal(fresh_t.network(tp.to_tensor(x)),
                       tm.network(tp.to_tensor(x)))
    opt = tp.load(str(tmp_path / "again.pdopt"))
    assert opt["global_step"] == 4 and "param_0.moment1" in opt


def test_visualdl_and_logger_match_jax():
    jm, tm = _pair()
    scalars, logs = [], []
    for pkg, m, cb in ((jp, jm, jcb), (tp, tm, tcb)):
        vdl = cb.VisualDL()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            m.fit(_toy(pkg, n=32), eval_data=_toy(pkg, n=32), epochs=2,
                  batch_size=16, shuffle=False, verbose=2, log_freq=1,
                  callbacks=[vdl])
        scalars.append(vdl.scalars)
        # values and seconds vary in their last digits
        logs.append(re.sub(r"\d+\.\d+", "N", buf.getvalue()))
    assert logs[0] == logs[1] and logs[1].count("step") == 4
    assert set(scalars[0]) == set(scalars[1])
    for tag in scalars[0]:
        j, t = np.array(scalars[0][tag]), np.array(scalars[1][tag])
        np.testing.assert_allclose(t, j, rtol=FIT_TOL, atol=FIT_TOL)


# -------------------------------------------------------- summary, flops ---


def _zero_init(mp):
    """The JAX initializers as zeros: the counts do not read the weights,
    and ``jax.random`` compiles a draw for every parameter shape."""
    for name in dir(jinit):
        cls = getattr(jinit, name)
        if isinstance(cls, type) and issubclass(cls, jinit.Initializer):
            mp.setattr(cls, "__call__", lambda self, shape, dtype=None:
                       jnp.zeros(tuple(shape), "float32"))


def _summary(pkg, net, size):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        info = pkg.summary(net, size)
    return buf.getvalue(), info


NETS = {
    "lenet": (lambda: JLeNet(), lambda: TLeNet(), (1, 1, 28, 28)),
    "resnet18": (lambda: jresnet.resnet18(num_classes=10),
                 lambda: tresnet.resnet18(num_classes=10), (1, 3, 32, 32)),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_summary_and_flops_match_jax(name, monkeypatch):
    jbuild, tbuild, size = NETS[name]
    _zero_init(monkeypatch)
    jnet, tnet = jbuild(), tbuild()
    jtext, jinfo = _summary(jp, jnet, size)
    ttext, tinfo = _summary(tp, tnet, size)
    assert ttext == jtext and tinfo == jinfo
    assert tp.flops(tnet, list(size)) == jp.flops(jnet, list(size))
    assert tnet.training  # the traced forward put it back in train mode
    no_shapes = [_summary(pkg, net, None) for pkg, net in ((jp, jnet),
                                                           (tp, tnet))]
    assert no_shapes[0] == no_shapes[1]


def test_resnet50_counts_pinned_for_the_card(monkeypatch):
    """The JAX package's ResNet-50 summary and flops at (1, 3, 224, 224):
    the figures ``chip_smoke.phase_hapi_resnet`` holds the port to."""
    _zero_init(monkeypatch)
    net = jresnet.resnet50(num_classes=1000)
    text, info = _summary(jp, net, cs.RESNET_COUNT_SIZE)
    assert info == {"total_params": cs.RESNET50_COUNTS["total_params"],
                    "trainable_params":
                        cs.RESNET50_COUNTS["trainable_params"]}
    assert hashlib.sha256(text.encode()).hexdigest() == \
        cs.RESNET50_COUNTS["summary_sha256"]
    assert jp.flops(net, list(cs.RESNET_COUNT_SIZE)) == \
        cs.RESNET50_COUNTS["flops"]


# ------------------------------------------------------------- the recipe ---


def test_verify_recipe_lenet_fake_data(monkeypatch):
    """The verify recipe's port form: LeNet over FakeData through the
    DataLoader, eager Adam steps, then ``Model.fit``; before training,
    the port's LeNet gives the JAX LeNet's logits on the same weights
    (1e-5; the JAX initializers drawn with numpy for speed)."""
    rng = np.random.RandomState(5)
    for name in dir(jinit):
        cls = getattr(jinit, name)
        if isinstance(cls, type) and issubclass(cls, jinit.Initializer):
            monkeypatch.setattr(cls, "__call__", lambda self, shape, dtype=None:
                                jnp.asarray(0.2 * rng.randn(*shape),
                                            "float32"))
    jnet, tnet = JLeNet(), TLeNet()
    _carry(jnet, tnet)
    x = tp.vision.datasets.FakeData(num_samples=1)[0][0][None]
    np.testing.assert_allclose(
        tnet(tp.to_tensor(x)).detach().numpy(),
        np.asarray(jnet(jp.to_tensor(x)).numpy()), rtol=FIT_TOL,
        atol=FIT_TOL)
    opt = tp.optimizer.Adam(1e-3, parameters=tnet.parameters())
    losses = []
    for x, y in tp.io.DataLoader(tp.vision.datasets.FakeData(
            num_samples=64), batch_size=32):
        loss = TF.cross_entropy(tnet(x), y.squeeze(-1))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.item()))
    assert len(losses) == 2 and all(np.isfinite(losses))
    m = tp.Model(tnet).prepare(tp.optimizer.Adam(
        1e-3, parameters=tnet.parameters()), tnn.CrossEntropyLoss(),
        tmetric.Accuracy(topk=(1, 5)), jit=True)
    hist = m.fit(tp.vision.datasets.FakeData(num_samples=64), batch_size=32,
                 verbose=0)
    assert len(hist["loss"]) == 2 and all(np.isfinite(hist["loss"]))
