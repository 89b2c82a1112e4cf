"""The port's ``fft``, ``signal`` and ``audio`` against the JAX package's,
on the CPU.

The fourteen cases of ``tests/test_fft_signal_audio.py``, each run
through ``paddle_tpu`` and ``paddle_tpu_torch`` on the same numpy
inputs (and against numpy where that test holds the JAX package to
numpy), plus every one of the 24 ``paddle.fft`` functions against the
JAX package's, gradients through ``rfft`` equal to JAX's, and WAV files
written by either package read back equal by the other. Tolerances:
transforms within rtol / atol 1e-4 of the largest magnitude's scale
(pocketfft against XLA's FFT, float32), windows, filterbanks and DCT
matrices within 1e-6 (the same float64 numpy, cast), features within
1e-4 relative to each output's largest magnitude (log-mel: 1e-3 dB).
"""
import math
import wave

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp  # noqa: E402
from paddle_tpu import audio as jaudio  # noqa: E402
from paddle_tpu import fft as jfft  # noqa: E402
from paddle_tpu import signal as jsignal  # noqa: E402

import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch import audio as taudio  # noqa: E402
from paddle_tpu_torch import fft as tfft  # noqa: E402
from paddle_tpu_torch import signal as tsignal  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TOL = 1e-4


@pytest.fixture(autouse=True)
def cpu():
    saved = tdevice._CURRENT[0]
    tp.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(a) for a in x]
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _same(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _both(fn, *arrays, **kw):
    """``fn(package, module)`` for each package, the arrays as tensors."""
    out = []
    for p, f in ((jp, jfft), (tp, tfft)):
        out.append(fn(p, f, *[p.to_tensor(a) for a in arrays], **kw))
    return out


# --------------------------------------------------------------- fft --


def _data(seed):
    r = np.random.default_rng(seed)
    real = r.standard_normal((4, 6, 8)).astype("float32")
    cplx = (r.standard_normal((4, 6, 8))
            + 1j * r.standard_normal((4, 6, 8))).astype("complex64")
    return real, cplx


FFT_CASES = {
    "fft": ("c", {"n": 10, "axis": 1}), "ifft": ("c", {"norm": "ortho"}),
    "rfft": ("r", {"axis": 0}), "irfft": ("c", {"n": 14}),
    "hfft": ("c", {"norm": "forward"}), "ihfft": ("r", {}),
    "fft2": ("c", {}), "ifft2": ("c", {"axes": (0, 2)}),
    "rfft2": ("r", {"s": (4, 6)}), "irfft2": ("c", {}),
    "hfft2": ("c", {}), "ihfft2": ("r", {}),
    "fftn": ("c", {}), "ifftn": ("c", {"axes": [1, 2], "norm": "ortho"}),
    "rfftn": ("r", {}), "irfftn": ("c", {"s": (4, 6, 10)}),
    "hfftn": ("c", {"axes": (1, 2)}), "ihfftn": ("r", {}),
    "fftshift": ("r", {"axes": [1]}), "ifftshift": ("r", {}),
}


@pytest.mark.parametrize("name", sorted(FFT_CASES))
def test_fft_function_matches_jax(name):
    kind, kw = FFT_CASES[name]
    real, cplx = _data(len(name))
    a = real if kind == "r" else cplx
    j, t = _both(lambda p, f, x: getattr(f, name)(x, **kw), a)
    _same(t, j)


def test_fft_frequencies_match_jax():
    for name in ("fftfreq", "rfftfreq"):
        for n, d in ((8, 0.5), (9, 2.0)):
            _same(getattr(tfft, name)(n, d), getattr(jfft, name)(n, d), 1e-6)
    assert tfft.fftfreq(8, dtype="float64").dtype == torch.float64
    assert len(tfft.__all__) == len(jfft.__all__) == 22


def test_fft_matches_numpy():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(32).astype(np.float32)
    xc = (rng.standard_normal(32)
          + 1j * rng.standard_normal(32)).astype(np.complex64)
    r = np.fft.rfft(x).astype(np.complex64)
    for name, arg, ref in (("fft", xc, np.fft.fft(xc)),
                           ("ifft", xc, np.fft.ifft(xc)),
                           ("rfft", x, np.fft.rfft(x)),
                           ("irfft", r, np.fft.irfft(r)),
                           ("hfft", r, np.fft.hfft(r))):
        j, t = _both(lambda p, f, a: getattr(f, name)(a), arg)
        _same(t, ref, 1e-4)
        _same(t, j)
    for norm in ("backward", "ortho", "forward"):
        j, t = _both(lambda p, f, a: f.fft(a, norm=norm), xc)
        _same(t, np.fft.fft(xc, norm=norm))
        _same(t, j)
    for f in (jfft, tfft):
        with pytest.raises(ValueError):
            f.fft(tp.to_tensor(xc) if f is tfft else jp.to_tensor(xc),
                  norm="bad")


def test_fft2_fftn_shift_freq():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 8, 8))
         + 1j * rng.standard_normal((4, 8, 8))).astype(np.complex64)
    xr = rng.standard_normal((6, 10)).astype(np.float32)
    for name, arg, ref in (("fft2", x, np.fft.fft2(x)),
                           ("fftn", x, np.fft.fftn(x)),
                           ("rfft2", xr, np.fft.rfft2(xr)),
                           ("fftshift", xr, np.fft.fftshift(xr)),
                           ("ifftshift", xr, np.fft.ifftshift(xr))):
        j, t = _both(lambda p, f, a: getattr(f, name)(a), arg)
        _same(t, ref, 1e-3)
        _same(t, j)
    _same(tfft.fftfreq(8, 0.5), np.fft.fftfreq(8, 0.5), 1e-6)
    _same(tfft.rfftfreq(8, 0.5), np.fft.rfftfreq(8, 0.5), 1e-6)


def test_fft_grad_matches_jax():
    grads = []
    for p, f in ((jp, jfft), (tp, tfft)):
        x = p.to_tensor(np.arange(8, dtype=np.float32), stop_gradient=False)
        y = f.rfft(x)
        (y.abs() ** 2).sum().backward()
        grads.append(_np(x.grad))
    assert np.isfinite(grads[1]).all()
    _same(grads[1], grads[0])


# ------------------------------------------------------------ signal --


def test_frame_overlap_add_roundtrip():
    x = np.arange(16, dtype=np.float32)
    xb = np.stack([x, x + 1])
    for p, s in ((jp, jsignal), (tp, tsignal)):
        f = s.frame(p.to_tensor(x), frame_length=4, hop_length=4)
        assert list(f.shape) == [4, 4]
        _same(s.overlap_add(f, hop_length=4), x, 1e-6)
        assert list(s.frame(p.to_tensor(xb), 8, 2).shape) == [2, 8, 5]
    j = jsignal.frame(jp.to_tensor(xb), 8, 2)
    t = tsignal.frame(tp.to_tensor(xb), 8, 2)
    _same(t, j, 1e-6)
    _same(tsignal.overlap_add(t, 2), jsignal.overlap_add(j, 2), 1e-6)


def test_frame_overlap_add_axis0():
    x = np.arange(16, dtype=np.float32)
    xb = np.stack([x, x + 100], axis=-1)
    outs = []
    for p, s in ((jp, jsignal), (tp, tsignal)):
        f = s.frame(p.to_tensor(x), frame_length=6, hop_length=5, axis=0)
        assert list(f.shape) == [3, 6]
        _same(_np(f)[1], x[5:11], 1e-6)
        f2 = s.frame(p.to_tensor(x), 4, 4, axis=0)
        _same(s.overlap_add(f2, hop_length=4, axis=0), x, 1e-6)
        back2 = _np(s.overlap_add(f, hop_length=5, axis=0))
        assert back2.shape == (16,)
        np.testing.assert_allclose(back2[5], x[5] * 2, rtol=1e-6)
        fb = s.frame(p.to_tensor(xb), 4, 4, axis=0)
        assert list(fb.shape) == [4, 4, 2]
        _same(s.overlap_add(fb, hop_length=4, axis=0), xb, 1e-6)
        outs.append((f, back2, fb))
    for a, b in zip(outs[1], outs[0]):
        _same(a, b, 1e-6)


def test_istft_rejects_onesided_complex():
    for p, s in ((jp, jsignal), (tp, tsignal)):
        spec = p.to_tensor(np.zeros((65, 4), dtype=np.complex64))
        with pytest.raises(ValueError):
            s.istft(spec, 128, return_complex=True)


def test_signal_validation():
    for p, s in ((jp, jsignal), (tp, tsignal)):
        x = p.to_tensor(np.zeros((2, 3, 16), np.float32))
        with pytest.raises(ValueError):
            s.frame(x, frame_length=4, hop_length=2, axis=1)
        with pytest.raises(ValueError):
            s.overlap_add(x, hop_length=2, axis=1)
        with pytest.raises(ValueError):
            s.stft(p.to_tensor(np.zeros(64, np.float32)), n_fft=32,
                   win_length=64)


@pytest.mark.parametrize("kw", [{}, {"center": False},
                                {"win_length": 96, "normalized": True},
                                {"onesided": False}])
def test_stft_istft_roundtrip(kw):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 512)).astype(np.float32)
    n_fft, out = 128, []
    for p, s, a in ((jp, jsignal, jaudio), (tp, tsignal, taudio)):
        win = a.functional.get_window("hann", kw.get("win_length", n_fft))
        spec = s.stft(p.to_tensor(x), n_fft, hop_length=32, window=win,
                      **kw)
        rows = n_fft if kw.get("onesided") is False else n_fft // 2 + 1
        frames = (1 + 512 // 32) if kw.get("center", True) else \
            1 + (512 - n_fft) // 32
        assert list(spec.shape) == [2, rows, frames]
        back = s.istft(spec, n_fft, hop_length=32, window=win,
                       length=512 if kw.get("center", True) else None,
                       **{k: v for k, v in kw.items()})
        out.append((spec, back))
    _same(out[1][0], out[0][0])
    _same(out[1][1], out[0][1])
    if kw.get("center", True):
        _same(out[1][1], x)


def test_stft_matches_manual_dft():
    x = np.random.default_rng(3).standard_normal(64).astype(np.float32)
    for p, s in ((jp, jsignal), (tp, tsignal)):
        spec = _np(s.stft(p.to_tensor(x[None]), 64, hop_length=64,
                          center=False))[0, :, 0]
        np.testing.assert_allclose(spec, np.fft.rfft(x), rtol=1e-3,
                                   atol=1e-3)


# ------------------------------------------------------------- audio --


def test_windows():
    for name in ("hann", "hamming", "blackman", "bartlett", "triang",
                 ("gaussian", 2.0), "rect"):
        for fftbins in (True, False):
            _same(taudio.functional.get_window(name, 16, fftbins),
                  jaudio.functional.get_window(name, 16, fftbins), 1e-6)
    w = taudio.functional.get_window("hann", 8).numpy()
    np.testing.assert_allclose(
        w, 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(8) / 8), atol=1e-6)
    w = taudio.functional.get_window("hamming", 16).numpy()
    np.testing.assert_allclose(
        w, 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(16) / 16), atol=1e-6)


def test_mel_scale():
    F, JF = taudio.functional, jaudio.functional
    f = np.array([0.0, 440.0, 1000.0, 4000.0, 8000.0])
    for htk in (False, True):
        np.testing.assert_allclose(F.mel_to_hz(F.hz_to_mel(f, htk), htk), f,
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(F.hz_to_mel(f, htk),
                                      JF.hz_to_mel(f, htk))
        assert F.hz_to_mel(440.0, htk) == JF.hz_to_mel(440.0, htk)
        assert F.hz_to_mel(tp.to_tensor(f), htk).shape == (5,)
        _same(F.mel_frequencies(16, 20.0, 8000.0, htk),
              JF.mel_frequencies(16, 20.0, 8000.0, htk), 1e-6)
    np.testing.assert_allclose(F.hz_to_mel(1000.0, htk=True),
                               2595 * math.log10(1 + 1000 / 700), rtol=1e-6)
    _same(F.fft_frequencies(16000, 512), JF.fft_frequencies(16000, 512),
          1e-6)


def test_fbank_and_dct_shapes():
    F, JF = taudio.functional, jaudio.functional
    fb = F.compute_fbank_matrix(16000, 512, n_mels=40).numpy()
    assert fb.shape == (40, 257) and (fb >= 0).all()
    assert (fb.sum(1) > 0).all()
    for kw in ({}, {"htk": True, "norm": None, "f_min": 50.0,
                    "f_max": 7000.0}):
        _same(F.compute_fbank_matrix(16000, 512, n_mels=40, **kw),
              JF.compute_fbank_matrix(16000, 512, n_mels=40, **kw), 1e-6)
    dct = F.create_dct(13, 40).numpy()
    assert dct.shape == (40, 13)
    np.testing.assert_allclose(dct.T @ dct, np.eye(13), atol=1e-5)
    for norm in ("ortho", None):
        _same(F.create_dct(13, 40, norm), JF.create_dct(13, 40, norm), 1e-6)


def test_feature_layers():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 2048)).astype(np.float32)
    layers = (
        ("Spectrogram", {"n_fft": 256}, 129),
        ("MelSpectrogram", {"sr": 16000, "n_fft": 256, "n_mels": 40}, 40),
        ("LogMelSpectrogram", {"sr": 16000, "n_fft": 256, "n_mels": 40,
                               "top_db": 80.0}, 40),
        ("MFCC", {"sr": 16000, "n_mfcc": 13, "n_fft": 256, "n_mels": 40},
         13))
    for name, kw, rows in layers:
        j = getattr(jaudio, name)(**kw)(jp.to_tensor(x))
        t = getattr(taudio, name)(**kw)(tp.to_tensor(x))
        assert list(t.shape[:2]) == [2, rows] and list(t.shape) == \
            list(j.shape)
        assert np.isfinite(_np(t)).all()
        _same(t, j)


def test_power_to_db():
    F, JF = taudio.functional, jaudio.functional
    for top_db, want in ((None, [0.0, 10.0, 20.0]), (15.0, [5.0, 10.0, 20.0])):
        x = np.array([1.0, 10.0, 100.0], dtype=np.float32)
        db = F.power_to_db(tp.to_tensor(x), top_db=top_db).numpy()
        np.testing.assert_allclose(db, want, atol=1e-5)
        _same(db, JF.power_to_db(jp.to_tensor(x), top_db=top_db), 1e-6)
    x = np.array([0.0, 1e-12, 2.0], "float32")
    _same(F.power_to_db(tp.to_tensor(x), ref_value=2.0, amin=1e-9),
          JF.power_to_db(jp.to_tensor(x), ref_value=2.0, amin=1e-9), 1e-6)


# ------------------------------------------------------------ backends --


def _tone(n, channels):
    t = np.arange(n) / 8000.0
    wav = np.stack([np.sin(2 * np.pi * 440 * (c + 1) * t) * 0.5
                    for c in range(channels)])
    return wav.astype("float32")


@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("channels", [1, 2])
def test_wav_files_cross_between_the_packages(tmp_path, bits, channels):
    wav = _tone(400, channels)
    tpath, jpath = str(tmp_path / "t.wav"), str(tmp_path / "j.wav")
    taudio.save(tpath, tp.to_tensor(wav), 8000, bits_per_sample=bits)
    jaudio.save(jpath, jp.to_tensor(wav), 8000, bits_per_sample=bits)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    for path in (tpath, jpath):
        tw, tsr = taudio.load(path)
        jw, jsr = jaudio.load(path)
        assert tsr == jsr == 8000
        np.testing.assert_array_equal(_np(tw), _np(jw))
        np.testing.assert_allclose(_np(tw), wav, atol=2.0 ** (1 - bits) * 2)
        ti, ji = taudio.info(path), jaudio.info(path)
        assert vars(ti) == vars(ji)
    part, _ = taudio.load(tpath, frame_offset=100, num_frames=50)
    np.testing.assert_array_equal(_np(part), _np(jaudio.load(
        jpath, frame_offset=100, num_frames=50)[0]))
    with wave.open(tpath) as w:
        assert w.getnchannels() == channels and w.getsampwidth() == bits // 8


def test_audio_datasets_over_local_folders(tmp_path):
    for name in ("1-100-A-7.wav", "2-101-A-3.wav"):
        jaudio.save(str(tmp_path / name), jp.to_tensor(_tone(80, 1)), 8000)
    t, j = taudio.datasets.ESC50(str(tmp_path)), jaudio.datasets.ESC50(
        str(tmp_path))
    assert len(t) == len(j) == 2 and t.labels == j.labels == ["3", "7"]
    for i in range(2):
        (tw, ty), (jw, jy) = t[i], j[i]
        np.testing.assert_array_equal(_np(tw), _np(jw))
        np.testing.assert_array_equal(ty, jy)
    for mod in (taudio, jaudio):
        with pytest.raises(RuntimeError):
            mod.datasets.TESS(str(tmp_path / "missing"))
    assert taudio.backends.list_available_backends() == ["wave"]
