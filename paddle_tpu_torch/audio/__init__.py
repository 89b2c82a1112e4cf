"""``paddle.audio``: feature layers, their functional pieces, a WAV codec
and the local audio datasets (counterpart of ``paddle_tpu/audio``)."""
from . import backends, datasets, features, functional
from .backends import info, load, save
from .features import LogMelSpectrogram, MFCC, MelSpectrogram, Spectrogram

__all__ = ["features", "functional", "Spectrogram", "MelSpectrogram",
           "LogMelSpectrogram", "MFCC", "backends", "datasets", "info",
           "load", "save"]
