"""Vision datasets (counterpart of ``paddle_tpu/vision/datasets/``;
reference: ``python/paddle/vision/datasets/``).

Nothing is downloaded: the loaders read local files (``image_path`` /
``label_path``, ``data_file``, a folder) and raise, as the JAX package's
do, when none is given. ``FakeData`` makes deterministic samples from
the index (the JAX package's draws, bit for bit), in float32 or, without
``ml_dtypes``, bfloat16 as ``core.dtypes.BFLOAT16_NP`` bits.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile

import numpy as np

from ...core import dtypes as _dt
from ...io.dataloader import Dataset

__all__ = ["FakeData", "MNIST", "FashionMNIST", "Cifar10", "Cifar100",
           "DatasetFolder", "ImageFolder", "Flowers", "VOC2012"]


class FakeData(Dataset):
    """Synthetic dataset, deterministic by index: ``RandomState(idx)``'s
    standard normals of ``image_shape`` and the label ``[idx %
    num_classes]`` (int64). ``dtype="bfloat16"`` rounds the float32
    draws to nearest even, as ``ml_dtypes`` does."""

    def __init__(self, num_samples=1000, image_shape=(1, 28, 28),
                 num_classes=10, dtype="float32"):
        self.num_samples = num_samples
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.dtype = dtype

    def __getitem__(self, idx):
        rng = np.random.RandomState(idx)
        img = rng.standard_normal(self.image_shape)
        if self.dtype == "bfloat16":
            img = _dt.bfloat16_bits(img.astype(np.float32))
        else:
            img = img.astype(self.dtype)
        label = np.array([idx % self.num_classes], dtype=np.int64)
        return img, label

    def __len__(self):
        return self.num_samples


class MNIST(Dataset):
    """MNIST from local IDX files (no download in this environment)."""

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        self.transform = transform
        if image_path is None or not os.path.exists(image_path):
            raise RuntimeError(
                "MNIST: provide local image_path/label_path (no egress); "
                "use vision.datasets.FakeData for synthetic data"
            )
        with gzip.open(image_path, "rb") as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            self.images = np.frombuffer(f.read(), dtype=np.uint8).reshape(
                n, 1, rows, cols
            ).astype(np.float32) / 255.0
        with gzip.open(label_path, "rb") as f:
            magic, n = struct.unpack(">II", f.read(8))
            self.labels = np.frombuffer(f.read(), dtype=np.uint8).astype(np.int64)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, np.array([self.labels[idx]])

    def __len__(self):
        return len(self.labels)


FashionMNIST = MNIST


class Cifar10(Dataset):
    """CIFAR-10 from a local copy of the python archive
    (``cifar-10-python.tar.gz``: pickled ``data_batch_*`` / ``test_batch``
    dicts of ``data`` [N, 3072] uint8 and ``labels``): float32 CHW images
    in [0, 1] and int64 labels ``[1]``. Raises without a local file."""

    _PREFIX = {"train": "data_batch", "test": "test_batch"}
    _LABELS = b"labels"

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        if data_file is None or not os.path.exists(data_file):
            raise RuntimeError(
                f"{type(self).__name__}: no egress; point data_file at a "
                "local copy")
        self.transform = transform
        images, labels = [], []
        with tarfile.open(data_file) as tar:
            for m in sorted(tar.getmembers(), key=lambda m: m.name):
                if self._PREFIX[mode] not in os.path.basename(m.name):
                    continue
                batch = pickle.load(tar.extractfile(m), encoding="bytes")
                images.append(np.asarray(batch[b"data"], np.uint8))
                labels.extend(batch[self._LABELS])
        self.images = (np.concatenate(images).reshape(-1, 3, 32, 32)
                       .astype(np.float32) / 255.0)
        self.labels = np.asarray(labels, np.int64)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, np.array([self.labels[idx]])

    def __len__(self):
        return len(self.labels)


class Cifar100(Cifar10):
    """CIFAR-100 from a local ``cifar-100-python.tar.gz`` (``train`` /
    ``test`` members, fine labels)."""

    _PREFIX = {"train": "train", "test": "test"}
    _LABELS = b"fine_labels"


IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                  ".tiff", ".webp", ".npy")


def _default_loader(path):
    """Load an image file to a float32 HWC array in [0, 1].

    Prefers PIL when available; ``.npy`` arrays always work (the
    no-image-codec path for this environment).
    """
    if path.endswith(".npy"):
        arr = np.load(path)
        if np.issubdtype(arr.dtype, np.integer):
            return arr.astype(np.float32) / 255.0  # honor the [0,1] contract
        return arr.astype(np.float32)
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            "PIL is unavailable; store images as .npy arrays or pass a "
            "custom loader=") from e
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), np.float32) / 255.0


class DatasetFolder(Dataset):
    """Generic folder dataset: ``root/class_x/xxx.ext`` (reference
    ``python/paddle/vision/datasets/folder.py::DatasetFolder``)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.loader = loader or _default_loader
        self.transform = transform
        extensions = tuple(extensions) if extensions else IMG_EXTENSIONS
        classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise RuntimeError(f"no class folders under {root!r}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        if is_valid_file is None:
            def is_valid_file(p):
                return p.lower().endswith(extensions)
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for dirpath, _dirs, files in sorted(os.walk(cdir)):
                for fname in sorted(files):
                    p = os.path.join(dirpath, fname)
                    if is_valid_file(p):
                        self.samples.append((p, self.class_to_idx[c]))
        if not self.samples:
            raise RuntimeError(
                f"no valid files under {root!r} (extensions {extensions})")
        self.targets = [t for _p, t in self.samples]

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    """Unlabeled image folder (reference ``folder.py::ImageFolder``):
    flat or nested files, yields [img] per sample."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.loader = loader or _default_loader
        self.transform = transform
        extensions = tuple(extensions) if extensions else IMG_EXTENSIONS
        if is_valid_file is None:
            def is_valid_file(p):
                return p.lower().endswith(extensions)
        self.samples = []
        for dirpath, _dirs, files in sorted(os.walk(root)):
            for fname in sorted(files):
                p = os.path.join(dirpath, fname)
                if is_valid_file(p):
                    self.samples.append(p)
        if not self.samples:
            raise RuntimeError(f"no valid files under {root!r}")

    def __getitem__(self, idx):
        img = self.loader(self.samples[idx])
        if self.transform is not None:
            img = self.transform(img)
        return [img]

    def __len__(self):
        return len(self.samples)


class Flowers(Dataset):
    """Oxford-102 flowers (reference ``datasets/flowers.py``): images tgz +
    ``imagelabels.mat`` + ``setid.mat``. Local files only (no egress)."""

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True, backend=None):
        import tarfile

        for f, n in ((data_file, "data_file (102flowers.tgz)"),
                     (label_file, "label_file (imagelabels.mat)"),
                     (setid_file, "setid_file (setid.mat)")):
            if f is None or not os.path.exists(f):
                raise RuntimeError(
                    f"Flowers: no egress; pass a local {n}")
        from scipy.io import loadmat

        labels = loadmat(label_file)["labels"].reshape(-1)
        ids = loadmat(setid_file)[
            {"train": "trnid", "valid": "valid", "test": "tstid"}[mode]
        ].reshape(-1)
        self._tar = tarfile.open(data_file)
        self._names = {}
        for m in self._tar.getmembers():
            base = os.path.basename(m.name)
            if base.startswith("image_") and base.endswith(".jpg"):
                self._names[int(base[6:11])] = m.name
        self._ids = [int(i) for i in ids]
        self._labels = {i: int(labels[i - 1]) - 1 for i in self._ids}
        self.transform = transform

    def __len__(self):
        return len(self._ids)

    def __getitem__(self, idx):
        import io as _io

        i = self._ids[idx]
        raw = self._tar.extractfile(self._names[i]).read()
        try:
            from PIL import Image

            img = np.asarray(
                Image.open(_io.BytesIO(raw)).convert("RGB"),
                np.float32) / 255.0
        except ImportError as e:
            raise RuntimeError("Flowers needs PIL to decode jpg") from e
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray([self._labels[i]], np.int64)


class VOC2012(Dataset):
    """Pascal VOC2012 segmentation (reference ``datasets/voc2012.py``):
    (image, segmentation-mask) pairs from the local trainval tar."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        import tarfile

        if data_file is None or not os.path.exists(data_file):
            raise RuntimeError(
                "VOC2012: no egress; pass a local VOCtrainval tar")
        self._tar = tarfile.open(data_file)
        names = {m.name for m in self._tar.getmembers()}
        seg_dir = next((os.path.dirname(n) for n in names
                        if "/SegmentationClass/" in n), None)
        if seg_dir is None:
            raise ValueError("archive has no SegmentationClass/")
        root = seg_dir.rsplit("/SegmentationClass", 1)[0]
        split_file = (f"{root}/ImageSets/Segmentation/"
                      + {"train": "train.txt", "valid": "val.txt",
                         "test": "val.txt", "trainval": "trainval.txt"}[mode])
        ids = self._tar.extractfile(split_file).read().decode().split()
        self._pairs = [
            (f"{root}/JPEGImages/{i}.jpg",
             f"{root}/SegmentationClass/{i}.png") for i in ids
        ]
        self.transform = transform

    def __len__(self):
        return len(self._pairs)

    def __getitem__(self, idx):
        import io as _io

        img_n, seg_n = self._pairs[idx]
        try:
            from PIL import Image
        except ImportError as e:
            raise RuntimeError("VOC2012 needs PIL to decode images") from e
        img = np.asarray(Image.open(
            _io.BytesIO(self._tar.extractfile(img_n).read())).convert("RGB"),
            np.float32) / 255.0
        seg = np.asarray(Image.open(
            _io.BytesIO(self._tar.extractfile(seg_n).read())), np.int64)
        if self.transform is not None:
            img = self.transform(img)
        return img, seg
