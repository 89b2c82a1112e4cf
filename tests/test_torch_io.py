"""The port's data path against the JAX package's, on the CPU.

The same seeded inputs go through ``paddle_tpu`` and ``paddle_tpu_torch``:

- samplers (sequence, random with and without replacement, weighted,
  batch, distributed) and ``random_split``: equal index orders from one
  ``np.random.seed``;
- ``FakeData``: float32 samples and bfloat16 bits equal (the port's
  ``BFLOAT16_NP`` against ``ml_dtypes``), labels equal;
- every transform: ``Resize`` (and ``RandomResizedCrop``, which resizes)
  within 1e-5 of ``jax.image.resize``'s antialiased triangle filter, the
  rest equal, the random ones from one ``np.random.seed``;
- MNIST from IDX files written to ``tmp_path``, ``DatasetFolder`` /
  ``ImageFolder`` over ``.npy`` files: equal; Cifar10 from a local
  archive (the port reads one; both raise without a file);
- ``DataLoader`` batches with 0 workers (thread prefetch and inline)
  and 2 ``fork`` workers over the native ring: equal values and bits,
  bfloat16 included, in the sampler's order (int64 labels: the JAX
  package holds them as int32, the port as int64); the ring refuses a message
  over its 64 MiB in both packages (``ValueError``, reported by the
  parent as the worker's error); user collate, worker info, iterable
  datasets, composed and chained datasets.
"""
import gzip
import os
import pickle
import struct
import tarfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ml_dtypes  # noqa: E402

import paddle_tpu.io as jio  # noqa: E402
import paddle_tpu.vision.datasets as jds  # noqa: E402
import paddle_tpu.vision.transforms as jtf  # noqa: E402
from paddle_tpu.core import native as jnative  # noqa: E402

import paddle_tpu_torch as tp  # noqa: E402
import paddle_tpu_torch.io as tio  # noqa: E402
import paddle_tpu_torch.vision.datasets as tds  # noqa: E402
import paddle_tpu_torch.vision.transforms as ttf  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.core import dtypes as tdt  # noqa: E402
from paddle_tpu_torch.core import native as tnative  # noqa: E402
from paddle_tpu_torch.io import dataloader as tdl  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

RESIZE_TOL = 1e-5


@pytest.fixture(autouse=True)
def cpu():
    saved = tdevice._CURRENT[0]
    tp.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


def _np(x):
    """A batch entry of either package as numpy, bfloat16 as its bits."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return torch.Tensor.numpy(t.as_subclass(torch.Tensor))
    arr = np.asarray(x.numpy() if hasattr(x, "numpy") else x)
    if arr.dtype == ml_dtypes.bfloat16 or arr.dtype == tdt.BFLOAT16_NP:
        return arr.view(np.uint16)
    return arr


def _same(a, b):
    """Equal shapes, dtypes and values; an int64 batch of the JAX package
    is int32 (JAX runs without 64-bit types), the port's int64."""
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype == np.int32 and b.dtype == np.int64:
        a = a.astype(np.int64)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _same_batches(jb, tb):
    assert len(jb) == len(tb)
    for j, t in zip(jb, tb):
        if isinstance(j, (list, tuple)):
            assert len(j) == len(t)
            for a, b in zip(j, t):
                _same(a, b)
        else:
            _same(j, t)


# ------------------------------------------------------------ samplers ---


class _Range:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.array([i], np.int64)


SAMPLERS = {
    "sequence": lambda m: m.SequenceSampler(_Range(13)),
    "random": lambda m: m.RandomSampler(_Range(13)),
    "random_replacement": lambda m: m.RandomSampler(
        _Range(13), replacement=True, num_samples=20),
    "random_num_samples": lambda m: m.RandomSampler(_Range(13),
                                                    num_samples=5),
    "weighted": lambda m: m.WeightedRandomSampler(
        [0.1, 0.5, 0.2, 0.2, 1.0], 12),
    "weighted_no_replacement": lambda m: m.WeightedRandomSampler(
        [0.1, 0.5, 0.2, 0.2, 1.0], 4, replacement=False),
    "batch_shuffle": lambda m: m.BatchSampler(_Range(13), shuffle=True,
                                              batch_size=4),
    "batch_drop_last": lambda m: m.BatchSampler(_Range(13), batch_size=4,
                                                drop_last=True),
    "distributed": lambda m: m.DistributedBatchSampler(
        _Range(13), 3, num_replicas=2, rank=1, shuffle=True),
}


@pytest.mark.parametrize("kind", sorted(SAMPLERS))
def test_sampler_orders_are_equal(kind):
    orders = []
    for mod in (jio, tio):
        np.random.seed(7)
        s = SAMPLERS[kind](mod)
        orders.append([list(s), list(s), len(s)])
    assert orders[0] == orders[1]


def test_random_split_is_equal():
    out = []
    for mod in (jio, tio):
        np.random.seed(3)
        parts = mod.random_split(_Range(10), [3, 7])
        out.append([p.indices for p in parts])
    assert out[0] == out[1]
    with pytest.raises(ValueError):
        tio.random_split(_Range(10), [3, 3])


# ------------------------------------------------------------- FakeData ---


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_data_bits(dtype):
    kw = dict(num_samples=9, image_shape=(3, 5, 7), num_classes=4,
              dtype=dtype)
    j, t = jds.FakeData(**kw), tds.FakeData(**kw)
    assert len(j) == len(t) == 9
    for i in range(9):
        (ji, jl), (ti, tl) = j[i], t[i]
        _same(ji, ti)
        _same(jl, tl)


def test_bfloat16_bits_match_ml_dtypes_everywhere():
    x = np.random.RandomState(0).standard_normal(200_000).astype(np.float32)
    x[:5] = [np.nan, np.inf, -np.inf, 3.4e38, 1.0 + 2.0 ** -8]
    want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(tdt.bfloat16_bits(x).view(np.uint16), want)
    got = tp.to_tensor(tdt.bfloat16_bits(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy().view(np.uint16), want)


# ----------------------------------------------------------- transforms ---


_RNG = np.random.default_rng(0)
CHW = _RNG.random((3, 20, 24)).astype(np.float32)
HWC = _RNG.random((16, 12, 3)).astype(np.float32)
HWC_U8 = (_RNG.random((16, 12, 3)) * 255).astype(np.uint8)

# name -> (builder of the transform from a module, input)
TRANSFORMS = {
    "ToTensor_u8": (lambda m: m.ToTensor(), HWC_U8),
    "ToTensor_chw": (lambda m: m.ToTensor(), CHW),
    "Normalize": (lambda m: m.Normalize([0.4, 0.5, 0.6], [0.2, 0.3, 0.4]),
                  CHW),
    "Normalize_hwc": (lambda m: m.Normalize(0.5, 0.25, data_format="HWC"),
                      HWC),
    "RandomHorizontalFlip": (lambda m: m.RandomHorizontalFlip(0.5), CHW),
    "RandomVerticalFlip": (lambda m: m.RandomVerticalFlip(0.5), CHW),
    "RandomCrop": (lambda m: m.RandomCrop(8, padding=2), CHW),
    "CenterCrop": (lambda m: m.CenterCrop((10, 12)), CHW),
    "Pad": (lambda m: m.Pad(3, fill=1.5), CHW),
    "Pad_reflect": (lambda m: m.Pad((1, 2), padding_mode="reflect"), CHW),
    "Grayscale_chw": (lambda m: m.Grayscale(3), CHW),
    "Grayscale_hwc": (lambda m: m.Grayscale(1), HWC),
    "Transpose": (lambda m: m.Transpose(), HWC),
    "Brightness": (lambda m: m.BrightnessTransform(0.4), CHW),
    "Contrast": (lambda m: m.ContrastTransform(0.4), CHW),
    "Saturation": (lambda m: m.SaturationTransform(0.4), CHW),
    "ColorJitter": (lambda m: m.ColorJitter(0.3, 0.3, 0.3), CHW),
    "Hue": (lambda m: m.HueTransform(0.3), HWC),
    "RandomRotation": (lambda m: m.RandomRotation(30, fill=0.5), HWC),
    "RandomAffine": (lambda m: m.RandomAffine(
        20, translate=(0.1, 0.2), scale=(0.8, 1.2), shear=10), HWC),
    "RandomPerspective": (lambda m: m.RandomPerspective(prob=1.0), HWC),
    "RandomErasing": (lambda m: m.RandomErasing(prob=1.0, value=0.25), HWC),
    "Compose": (lambda m: m.Compose([m.CenterCrop(16), m.Normalize(
        0.5, 0.5), m.RandomHorizontalFlip(1.0)]), CHW),
}

RESAMPLED = {
    "Resize_down": (lambda m: m.Resize((7, 11)), CHW),
    "Resize_up": (lambda m: m.Resize(33), CHW),
    "Resize_hwc": (lambda m: m.Resize((9, 30)), HWC),
    "Resize_2d": (lambda m: m.Resize((5, 40)), CHW[0]),
    "RandomResizedCrop": (lambda m: m.RandomResizedCrop(9), CHW),
    "resize_fn": (lambda m: (lambda x: m.resize(x, (6, 6))), CHW),
}

FUNCTIONS = {
    "hflip": lambda m, x: m.hflip(x),
    "vflip": lambda m, x: m.vflip(x),
    "crop": lambda m, x: m.crop(x, 2, 3, 5, 6),
    "center_crop": lambda m, x: m.center_crop(x, 8),
    "pad": lambda m, x: m.pad(x, (1, 2, 3, 4), fill=2),
    "pad_edge": lambda m, x: m.pad(x, 2, padding_mode="edge"),
    "erase": lambda m, x: m.erase(x, 1, 2, 3, 4, 0.5),
    "to_grayscale": lambda m, x: m.to_grayscale(x, 3),
    "adjust_brightness": lambda m, x: m.adjust_brightness(x, 1.3),
    "adjust_contrast": lambda m, x: m.adjust_contrast(x, 0.7),
    "adjust_hue": lambda m, x: m.adjust_hue(x, 0.2),
    "affine": lambda m, x: m.affine(x, 15, (2, -1), 1.1, (5.0, 3.0)),
    "rotate": lambda m, x: m.rotate(x, 33, fill=1),
    "perspective": lambda m, x: m.perspective(
        x, [(0, 0), (11, 0), (11, 15), (0, 15)],
        [(1, 2), (10, 1), (11, 14), (2, 15)]),
    "to_tensor": lambda m, x: m.to_tensor(x),
    "normalize": lambda m, x: m.normalize(x, 0.5, 0.2, "HWC"),
}


def _apply_both(build, x, seed=11):
    outs = []
    for mod in (jtf, ttf):
        np.random.seed(seed)
        outs.append(np.asarray(build(mod)(x.copy())))
    return outs


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_is_equal(name):
    build, x = TRANSFORMS[name]
    for seed in (1, 2, 3):
        j, t = _apply_both(build, x, seed)
        assert j.dtype == t.dtype
        np.testing.assert_array_equal(j, t)


@pytest.mark.parametrize("name", sorted(RESAMPLED))
def test_resampling_transform_within_tolerance(name):
    build, x = RESAMPLED[name]
    for seed in (1, 2):
        j, t = _apply_both(build, x, seed)
        assert j.shape == t.shape and t.dtype == np.float32
        np.testing.assert_allclose(t, j, rtol=0, atol=RESIZE_TOL)


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
@pytest.mark.parametrize("img", ["float", "uint8"])
def test_functional_transform_is_equal(name, img):
    x = HWC if img == "float" else HWC_U8
    j = np.asarray(FUNCTIONS[name](jtf, x.copy()))
    t = np.asarray(FUNCTIONS[name](ttf, x.copy()))
    assert j.dtype == t.dtype
    np.testing.assert_array_equal(j, t)


# ------------------------------------------------------------- datasets ---


def _write_idx(tmp_path, n=6, rows=4, cols=5):
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (n, rows, cols), dtype=np.uint8)
    labels = rng.integers(0, 10, n, dtype=np.uint8)
    ip, lp = tmp_path / "img.gz", tmp_path / "lab.gz"
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, rows, cols) + imgs.tobytes())
    with gzip.open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return str(ip), str(lp)


@pytest.mark.parametrize("cls", ["MNIST", "FashionMNIST"])
def test_mnist_from_idx_files(tmp_path, cls):
    ip, lp = _write_idx(tmp_path)
    tf = [lambda m: None, lambda m: m.Normalize(0.5, 0.5)]
    for make_tf in tf:
        j = getattr(jds, cls)(ip, lp, transform=make_tf(jtf))
        t = getattr(tds, cls)(ip, lp, transform=make_tf(ttf))
        assert len(j) == len(t) == 6
        for i in range(6):
            for a, b in zip(j[i], t[i]):
                _same(a, b)
    for mod in (jds, tds):
        with pytest.raises(RuntimeError, match="no egress"):
            getattr(mod, cls)()


def test_folder_datasets(tmp_path):
    rng = np.random.default_rng(1)
    for c in ("cat", "dog"):
        (tmp_path / c / "sub").mkdir(parents=True)
        for k in range(3):
            d = tmp_path / c / ("sub" if k == 2 else "")
            np.save(d / f"{k}.npy", rng.random((4, 4, 3)).astype(np.float32))
        np.save(tmp_path / c / "u8.npy",
                rng.integers(0, 256, (4, 4, 3), dtype=np.uint8))
        (tmp_path / c / "skip.txt").write_text("x")
    j = jds.DatasetFolder(str(tmp_path))
    t = tds.DatasetFolder(str(tmp_path))
    assert j.classes == t.classes and j.samples == t.samples
    assert j.targets == t.targets
    for i in range(len(j)):
        _same(j[i][0], t[i][0])
        assert j[i][1] == t[i][1]
    ji, ti = jds.ImageFolder(str(tmp_path)), tds.ImageFolder(str(tmp_path))
    assert ji.samples == ti.samples
    _same(ji[1][0], ti[1][0])
    for mod in (jds, tds):
        with pytest.raises(RuntimeError):
            mod.DatasetFolder(str(tmp_path / "cat" / "sub"))


def test_cifar_and_archive_datasets_need_local_files(tmp_path):
    for mod in (jds, tds):
        for cls in ("Cifar10", "Cifar100", "Flowers", "VOC2012"):
            with pytest.raises(RuntimeError, match="no egress"):
                getattr(mod, cls)()
    # the port reads a local CIFAR-10 python archive
    rng = np.random.default_rng(2)
    data = rng.integers(0, 256, (5, 3072), dtype=np.uint8)
    labels = [3, 1, 4, 1, 5]
    batch = tmp_path / "data_batch_1"
    with open(batch, "wb") as f:
        pickle.dump({b"data": data, b"labels": labels}, f)
    arc = tmp_path / "cifar-10-python.tar.gz"
    with tarfile.open(arc, "w:gz") as tar:
        tar.add(batch, arcname="cifar-10-batches-py/data_batch_1")
    ds = tds.Cifar10(str(arc))
    assert len(ds) == 5
    img, lab = ds[2]
    np.testing.assert_array_equal(
        img, data[2].reshape(3, 32, 32).astype(np.float32) / 255.0)
    assert lab.tolist() == [4] and lab.dtype == np.int64


# ----------------------------------------------------------- DataLoader ---


class _Pairs:
    """(float32 [3, 4], int64 scalar, dict) samples."""

    def __len__(self):
        return 10

    def __getitem__(self, i):
        x = np.random.RandomState(i).rand(3, 4).astype(np.float32)
        return x, np.int64(i), {"w": float(i) / 2}


def _loader_batches(mod, dataset, **kw):
    return [b for b in mod.DataLoader(dataset, **kw)]


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dataloader_fake_data_batches_are_equal(workers, dtype):
    kw = dict(num_samples=20, image_shape=(2, 6, 6), num_classes=3,
              dtype=dtype)
    got = []
    for mod, dsm in ((jio, jds), (tio, tds)):
        np.random.seed(4)
        got.append(_loader_batches(mod, dsm.FakeData(**kw), batch_size=6,
                                   shuffle=True, num_workers=workers))
    _same_batches(*got)
    assert len(got[1]) == 4
    x = got[1][0][0]
    assert isinstance(x, tp.Tensor) and x.device.type == "cpu"
    assert x.dtype == (torch.bfloat16 if dtype == "bfloat16"
                       else torch.float32)


@pytest.mark.parametrize("workers", [0, 2])
def test_dataloader_nested_samples(workers):
    got = [_loader_batches(mod, _Pairs(), batch_size=4,
                           num_workers=workers) for mod in (jio, tio)]
    for jb, tb in zip(*got):
        _same(jb[0], tb[0])
        _same(jb[1], tb[1])
        _same(jb[2]["w"], tb[2]["w"])


def test_dataloader_inline_equals_prefetch():
    ds = tds.FakeData(num_samples=7, image_shape=(1, 3, 3))
    a = _loader_batches(tio, ds, batch_size=3, use_buffer_reader=False)
    b = _loader_batches(tio, ds, batch_size=3, num_workers=2)
    c = _loader_batches(tio, ds, batch_size=3)
    _same_batches(a, b)
    _same_batches(a, c)
    assert len(tio.DataLoader(ds, batch_size=3)) == 3


def test_ring_path_runs_with_workers():
    assert tnative.available()
    it = iter(tio.DataLoader(tds.FakeData(num_samples=4), batch_size=2,
                             num_workers=2))
    assert isinstance(it, tdl._MultiprocessIterator)
    assert len(list(it)) == 2
    assert tdl._default_start_method() in ("fork", os.environ.get(
        "PADDLE_TPU_WORKER_START"))


@pytest.mark.parametrize("tier", ["native", "python"])
def test_blocking_queue_matches_jax(tier, monkeypatch):
    """The in-process byte queue of both packages, on the native tier and
    on its ``queue.Queue`` fallback: FIFO objects, the length, a timeout
    on an empty queue and on a full one, and ``Closed`` after close."""
    got = []
    for native in (jnative, tnative):
        queues = __import__(native.__name__ + ".queues", fromlist=["x"])
        if tier == "python":
            monkeypatch.setattr(native, "load", lambda: None)
        q = native.BlockingQueue(capacity=2)
        assert (q._lib is None) == (tier == "python")
        q.push_obj({"a": 1})
        q.push(b"raw")
        events = [len(q)]
        with pytest.raises(queues.Timeout):
            q.push(b"full", timeout=0.05)
        events += [q.pop_obj(), q.pop(timeout=1.0), len(q)]
        with pytest.raises(queues.Timeout):
            q.pop(timeout=0.05)
        q.close()
        with pytest.raises(queues.Closed):
            q.pop(timeout=0.05)
        got.append(events)
        monkeypatch.undo()
    assert got[0] == got[1] == [2, {"a": 1}, b"raw", 0]


class _Zeros:
    """One sample of 68 MiB of zeros: over the 64 MiB ring."""

    def __len__(self):
        return 1

    def __getitem__(self, i):
        return np.zeros((17, 1024, 1024), np.float32)


def test_ring_refuses_a_message_over_64_mib():
    big = b"\0" * ((64 << 20) + 1)
    for native in (jnative, tnative):
        ring = native.ShmRingQueue.create()
        try:
            with pytest.raises(ValueError, match="exceeds ring capacity"):
                ring.push(big)
            ring.push_obj("fits")
            assert ring.pop_obj(timeout=5.0) == "fits"
        finally:
            ring.destroy()
    for mod in (jio, tio):
        with pytest.raises(RuntimeError, match="ValueError: message of"):
            _loader_batches(mod, _Zeros(), batch_size=1, num_workers=1)


class _WhoAmI:
    def __init__(self, mod):
        self.mod = mod

    def __len__(self):
        return 8

    def __getitem__(self, i):
        info = self.mod.get_worker_info()
        return np.array([-1 if info is None else info.id,
                         -1 if info is None else info.num_workers])


def test_worker_info_and_user_collate():
    ids = [[b.tolist() for b in _loader_batches(
        mod, _WhoAmI(mod), batch_size=2, num_workers=2)]
        for mod in (jio.dataloader, tdl)]
    assert ids[0] == ids[1]
    assert {row[0] for b in ids[1] for row in b} == {0, 1}
    assert tio.get_worker_info() is None

    def collate(batch):
        return np.stack(batch).sum()

    got = [_loader_batches(mod, _WhoAmI(mod), batch_size=2, num_workers=2,
                           collate_fn=collate)
           for mod in (jio.dataloader, tdl)]
    assert [int(v) for v in got[0]] == [int(v) for v in got[1]]


class _Stream:
    def __init__(self, mod, n):
        self.base = mod.IterableDataset
        self.n = n

    def __iter__(self):
        for i in range(self.n):
            yield np.full((2,), i, np.float32), np.int64(i)


def _iterable(mod, n):
    cls = type("Stream", (_Stream, mod.IterableDataset), {})
    return cls(mod, n)


@pytest.mark.parametrize("drop_last", [False, True])
def test_iterable_and_composed_datasets(drop_last):
    got = [_loader_batches(mod, _iterable(mod, 7), batch_size=3,
                           drop_last=drop_last) for mod in (jio, tio)]
    _same_batches(*got)
    assert len(got[1]) == (2 if drop_last else 3)
    for mod in (jio, tio):
        with pytest.raises(TypeError):
            len(mod.DataLoader(_iterable(mod, 7), batch_size=3))
    a = np.arange(12, dtype=np.float32).reshape(6, 2)
    b = np.arange(6, dtype=np.int64)
    outs = []
    for mod in (jio, tio):
        ds = mod.ComposeDataset([mod.TensorDataset([a, b]),
                                 mod.Subset(mod.TensorDataset([a * 2]),
                                            [5, 4, 3, 2, 1, 0])])
        # iterated, not list()ed: an IterableDataset's len() raises
        chain = [s for s in mod.ChainDataset([_iterable(mod, 2),
                                              _iterable(mod, 3)])]
        outs.append(([ds[i] for i in range(len(ds))], chain))
    for (jrow, trow) in zip(outs[0][0], outs[1][0]):
        for x, y in zip(jrow, trow):
            _same(x, y)
    assert [int(s[1]) for s in outs[0][1]] == [int(s[1]) for s in outs[1][1]]
