"""``paddle.audio.datasets``: TESS and ESC-50 over an extracted local
folder (nothing is downloaded), yielding ``(waveform, label)``
(counterpart of ``paddle_tpu/audio/datasets.py``)."""
from __future__ import annotations

import os

import numpy as np

from ..io import Dataset
from . import backends

__all__ = ["TESS", "ESC50"]


class _FolderAudioDataset(Dataset):
    def __init__(self, root, label_fn, feat=None, sample_rate=None,
                 archive=None):
        if root is None or not os.path.isdir(root):
            raise RuntimeError(
                f"{type(self).__name__}: nothing is downloaded; pass the "
                "extracted dataset directory")
        self._files = []
        for dirpath, _, names in os.walk(root):
            for n in sorted(names):
                if n.lower().endswith(".wav"):
                    self._files.append(os.path.join(dirpath, n))
        self._label_fn = label_fn
        self.labels = sorted({label_fn(f) for f in self._files})
        self._label_idx = {l: i for i, l in enumerate(self.labels)}

    def __len__(self):
        return len(self._files)

    def __getitem__(self, idx):
        wav, sr = backends.load(self._files[idx])
        y = self._label_idx[self._label_fn(self._files[idx])]
        return wav, np.asarray([y], np.int64)


class TESS(_FolderAudioDataset):
    """Toronto emotional speech set: label = emotion suffix of the file
    name."""

    def __init__(self, root=None, mode="train", n_folds=5, split=1,
                 feat_type="raw", archive=None, **kwargs):
        super().__init__(
            root, lambda f: os.path.basename(f).rsplit("_", 1)[-1][:-4])


class ESC50(_FolderAudioDataset):
    """ESC-50 environmental sounds: label = target field of the filename
    ``{fold}-{id}-{take}-{target}.wav``."""

    def __init__(self, root=None, mode="train", split=1, feat_type="raw",
                 archive=None, **kwargs):
        super().__init__(
            root, lambda f: os.path.basename(f)[:-4].split("-")[-1])
