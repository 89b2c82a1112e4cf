"""The port's ``vision.ops`` and the ``static.nn`` helpers built on it,
against the JAX package's, on the CPU.

The same seeded numpy inputs go through both packages, in float32:

- ``roi_align`` (aligned or not, ``sampling_ratio`` -1 and 3, boxes
  partly and wholly outside the image), ``roi_pool`` (empty bins give
  -inf in both; its gradient at tied maxima shared as JAX shares it),
  ``psroi_pool`` and ``deform_conv2d`` (v1 and v2,
  groups, deformable groups, stride, padding, dilation) with their
  layers; ``yolo_box`` and ``yolo_loss`` (a ground truth of zero size,
  two ground truths in one cell); forward within 1e-5, and the
  gradients of ``roi_align`` (x), ``deform_conv2d`` (x, offset, mask,
  weight, bias) and ``yolo_loss`` (x) within 1e-5 of each tensor's
  largest value;
- the host ops: ``nms`` (with equal scores, categories and ``top_k``),
  ``matrix_nms`` (linear and Gaussian decay), ``generate_proposals``
  (equal scores), ``distribute_fpn_proposals``: indices and counts
  exact, boxes and scores within 1e-5; ``prior_box`` and ``box_coder``
  (encode, decode on either axis); ``read_file`` and ``decode_jpeg``
  (where PIL imports; without it, the JAX package's ``RuntimeError``);
- ``static.nn.deform_conv2d`` and ``multi_box_head`` with the JAX
  initializers and the port's drawing the same numpy weights.
"""
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jp  # noqa: E402
import paddle_tpu.nn.initializer as jinit  # noqa: E402
import paddle_tpu.static.nn as jsnn  # noqa: E402
from paddle_tpu.vision import ops as jops  # noqa: E402

import paddle_tpu_torch as tp  # noqa: E402
import paddle_tpu_torch.nn.initializer as tinit  # noqa: E402
import paddle_tpu_torch.static.nn as tsnn  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.vision import ops as tops  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TOL = 1e-5


@pytest.fixture(autouse=True)
def cpu():
    saved = tdevice._CURRENT[0]
    tp.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(_np(t), _np(j), rtol=tol, atol=tol)


def _grad_close(t, j, tol=TOL):
    """Within ``tol`` of the JAX gradient's largest value."""
    t, j = _np(t), _np(j)
    scale = max(float(np.abs(j).max()), 1e-30)
    np.testing.assert_allclose(t / scale, j / scale, rtol=0, atol=tol)


def _pair(a, grad=False):
    """The array as a JAX and a port tensor."""
    j, t = jp.to_tensor(a), tp.to_tensor(a)
    if grad:
        j.stop_gradient = t.stop_gradient = False
    return j, t


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        "float32")


def _backward(jy, ty, seed):
    w = _rand(tuple(ty.shape), seed)
    (jy * jp.to_tensor(w)).sum().backward()
    (ty * tp.to_tensor(w)).sum().backward()


def test_exports_every_jax_name():
    import paddle_tpu.amp.debugging as jdbg
    import paddle_tpu_torch.amp.debugging as tdbg

    assert set(jops.__all__) <= set(tops.__all__)
    assert set(jdbg.__all__) <= set(tdbg.__all__)
    assert tp.vision.ops is tops
    assert tp.optimizer.HostOffloadAdamW.__module__.startswith(
        "paddle_tpu_torch.optimizer")


# boxes over a 2-image batch of 9 x 11 maps (in pixels at scale 1): a
# box inside, one across the edge, one wholly outside, a point box
BOXES = np.array([[1.0, 1.5, 7.2, 6.0], [-3.0, -2.0, 4.0, 5.5],
                  [12.0, 10.0, 15.0, 14.0], [2.0, 2.0, 9.5, 8.8],
                  [3.0, 3.0, 3.0, 3.0]], "float32")
BOXES_NUM = np.array([3, 2], "int32")


@pytest.mark.parametrize("aligned,sr,scale", [
    (True, -1, 1.0), (False, -1, 1.0), (True, 3, 0.5), (False, 2, 0.75)])
def test_roi_align_matches_jax(aligned, sr, scale):
    jx, tx = _pair(_rand((2, 3, 9, 11), 0), grad=True)
    jy = jops.roi_align(jx, jp.to_tensor(BOXES), BOXES_NUM, (3, 2), scale,
                        sr, aligned)
    ty = tops.roi_align(tx, tp.to_tensor(BOXES), tp.to_tensor(BOXES_NUM),
                        (3, 2), scale, sr, aligned)
    assert tuple(ty.shape) == (5, 3, 3, 2)
    _close(ty, jy)
    _backward(jy, ty, 1)
    _grad_close(tx.grad, jx.grad)


def test_roi_align_chunks_agree(monkeypatch):
    """Chunked over RoIs (one RoI a chunk) the values are the same."""
    x = tp.to_tensor(_rand((2, 3, 9, 11), 0))
    whole = tops.roi_align(x, tp.to_tensor(BOXES), BOXES_NUM, 2)
    monkeypatch.setattr(tops, "CHUNK_BYTES", 1)
    np.testing.assert_array_equal(
        _np(tops.roi_align(x, tp.to_tensor(BOXES), BOXES_NUM, 2)),
        _np(whole))


@pytest.mark.parametrize("out,scale", [(2, 1.0), ((3, 4), 0.5), (5, 1.0)])
def test_roi_pool_matches_jax_with_empty_bins(out, scale):
    x = _rand((2, 3, 9, 11), 2)
    jy = jops.roi_pool(jp.to_tensor(x), jp.to_tensor(BOXES), BOXES_NUM, out,
                       scale)
    ty = tops.roi_pool(tp.to_tensor(x), tp.to_tensor(BOXES), BOXES_NUM, out,
                       scale)
    want = _np(jy)
    assert np.isneginf(want).any()        # the box outside: empty bins
    np.testing.assert_array_equal(_np(ty), want)


def test_roi_pool_gradient_reaches_each_bins_max(monkeypatch):
    """The gradient of each non-empty bin lands on its max (checked
    against ``torch.autograd`` through a per-RoI masked max), chunked
    one RoI at a time."""
    monkeypatch.setattr(tops, "CHUNK_BYTES", 1)
    x = tp.to_tensor(_rand((2, 3, 9, 11), 3), stop_gradient=False)
    y = tops.roi_pool(x, tp.to_tensor(BOXES[:2]), [1, 1], 3)
    w = torch.from_numpy(_rand(tuple(y.shape), 4))
    (torch.where(torch.isfinite(y), y, 0.0) * w).sum().backward()
    # the same bins read with the JAX function's dense masks
    x2 = x.detach().clone().requires_grad_(True)
    jy = jops.roi_pool(jp.to_tensor(_np(x)), jp.to_tensor(BOXES[:2]),
                       [1, 1], 3)
    np.testing.assert_array_equal(_np(y.detach()), _np(jy))
    mask = (x2.detach().reshape(2, 3, 1, 1, 99)
            == y.detach().reshape(2, 3, 3, 3, 1))
    flat = x2.reshape(2, 3, 1, 1, 99)
    ref = torch.where(mask, flat, 0.0).sum(-1)
    (torch.where(torch.isfinite(y.detach()), ref, 0.0) * w).sum().backward()
    np.testing.assert_allclose(_np(x.grad), _np(x2.grad), rtol=0, atol=1e-6)


def test_roi_pool_gradient_splits_ties_as_jax():
    """A ReLU'd map rounded to tenths (many equal maxima, zero-filled
    bins): the gradient shares each bin's among its tied maxima as the
    JAX max does."""
    a = np.round(np.maximum(_rand((2, 3, 9, 11), 40), 0.0), 1)
    jx, tx = _pair(a.astype("float32"), grad=True)
    jy = jops.roi_pool(jx, jp.to_tensor(BOXES), BOXES_NUM, 3)
    ty = tops.roi_pool(tx, tp.to_tensor(BOXES), BOXES_NUM, 3)
    np.testing.assert_array_equal(_np(ty), _np(jy))
    w = _rand(tuple(ty.shape), 41)
    fin = np.isfinite(_np(jy))
    (jp.where(jp.to_tensor(fin), jy, jp.zeros_like(jy))
     * jp.to_tensor(w)).sum().backward()
    (torch.where(torch.from_numpy(fin), ty, 0.0)
     * torch.from_numpy(w)).sum().backward()
    _grad_close(tx.grad, jx.grad)


def test_psroi_pool_matches_jax():
    x = _rand((2, 2 * 3 * 4, 7, 8), 5)
    boxes = np.array([[0.5, 1.0, 6.5, 5.0], [2.0, 0.0, 9.0, 9.0],
                      [-2.0, -1.0, 1.0, 0.5]], "float32")
    jy = jops.psroi_pool(jp.to_tensor(x), jp.to_tensor(boxes),
                         jp.to_tensor(np.array([2, 1], "int32")), (3, 4),
                         0.9)
    ty = tops.psroi_pool(tp.to_tensor(x), tp.to_tensor(boxes),
                         tp.to_tensor(np.array([2, 1], "int32")), (3, 4),
                         0.9)
    assert tuple(ty.shape) == (3, 2, 3, 4)
    _close(ty, jy)


def test_roi_layers_match_the_functions():
    x = tp.to_tensor(_rand((2, 4 * 4, 9, 11), 6))
    b = tp.to_tensor(BOXES)
    for layer, fn in ((tops.RoIAlign(2, 0.5), tops.roi_align),
                      (tops.RoIPool(2, 0.5), tops.roi_pool),
                      (tops.PSRoIPool(2, 0.5), tops.psroi_pool)):
        assert isinstance(layer, tp.nn.Layer)
        np.testing.assert_array_equal(_np(layer(x, b, BOXES_NUM)),
                                      _np(fn(x, b, BOXES_NUM, 2, 0.5)))
    jx = jp.to_tensor(_np(x))
    _close(tops.RoIAlign(2, 0.5)(x, b, BOXES_NUM),
           jops.RoIAlign(2, 0.5)(jx, jp.to_tensor(BOXES), BOXES_NUM))


DEFORM_CASES = {
    "v1": dict(C=4, Cout=6, k=3, stride=1, padding=1, dilation=1, dg=1,
               groups=1, mask=False, bias=True),
    "v2": dict(C=4, Cout=6, k=3, stride=1, padding=1, dilation=1, dg=1,
               groups=1, mask=True, bias=True),
    "groups": dict(C=4, Cout=6, k=3, stride=2, padding=1, dilation=1, dg=2,
                   groups=2, mask=True, bias=False),
    "dilated": dict(C=2, Cout=3, k=(2, 3), stride=1, padding=(1, 2),
                    dilation=2, dg=2, groups=1, mask=True, bias=True),
}


@pytest.mark.parametrize("case", list(DEFORM_CASES))
def test_deform_conv2d_matches_jax(case):
    c = DEFORM_CASES[case]
    kh, kw = (c["k"], c["k"]) if isinstance(c["k"], int) else c["k"]
    H, W = 7, 9
    ph, pw = ((c["padding"],) * 2 if isinstance(c["padding"], int)
              else c["padding"])
    Ho = (H + 2 * ph - c["dilation"] * (kh - 1) - 1) // c["stride"] + 1
    Wo = (W + 2 * pw - c["dilation"] * (kw - 1) - 1) // c["stride"] + 1
    arrays = [_rand((2, c["C"], H, W), 7),
              _rand((2, 2 * c["dg"] * kh * kw, Ho, Wo), 8, 1.5),
              _rand((c["Cout"], c["C"] // c["groups"], kh, kw), 9)]
    if c["mask"]:
        arrays.append(np.random.RandomState(10).rand(
            2, c["dg"] * kh * kw, Ho, Wo).astype("float32"))
    if c["bias"]:
        arrays.append(_rand((c["Cout"],), 11))
    pairs = [_pair(a, grad=True) for a in arrays]
    kw_ = dict(stride=c["stride"], padding=c["padding"],
               dilation=c["dilation"], deformable_groups=c["dg"],
               groups=c["groups"])

    def call(ops, ts):
        mask = ts[3] if c["mask"] else None
        bias = ts[-1] if c["bias"] else None
        return ops.deform_conv2d(ts[0], ts[1], ts[2], bias=bias, mask=mask,
                                 **kw_)

    jy = call(jops, [p[0] for p in pairs])
    ty = call(tops, [p[1] for p in pairs])
    assert tuple(ty.shape) == (2, c["Cout"], Ho, Wo)
    _close(ty, jy)
    _backward(jy, ty, 12)
    for j, t in pairs:
        _grad_close(t.grad, j.grad)


def test_deform_conv2d_layer_and_image_chunks(monkeypatch):
    layer = tops.DeformConv2D(4, 6, 3, padding=1, deformable_groups=2)
    assert [n for n, _ in layer.named_parameters()] == ["weight", "bias"]
    x = tp.to_tensor(_rand((2, 4, 5, 6), 13))
    off = tp.to_tensor(_rand((2, 36, 5, 6), 14))
    y = layer(x, off)
    want = tops.deform_conv2d(x, off, layer.weight, layer.bias, padding=1,
                              deformable_groups=2)
    np.testing.assert_array_equal(_np(y.detach()), _np(want.detach()))
    monkeypatch.setattr(tops, "CHUNK_BYTES", 1)     # one image a chunk
    np.testing.assert_allclose(_np(layer(x, off).detach()),
                               _np(y.detach()), rtol=1e-6, atol=1e-6)


ANCHORS = [10, 13, 16, 30, 33, 23]


@pytest.mark.parametrize("clip,scale_xy", [(True, 1.0), (False, 1.05)])
def test_yolo_box_matches_jax(clip, scale_xy):
    x = _rand((2, 3 * (5 + 4), 5, 6), 15, 2.0)
    img = np.array([[160, 192], [100, 90]], "int32")
    jb, js = jops.yolo_box(jp.to_tensor(x), img, ANCHORS, 4, 0.3, 32, clip,
                           scale_xy)
    tb, ts = tops.yolo_box(tp.to_tensor(x), tp.to_tensor(img), ANCHORS, 4,
                           0.3, 32, clip, scale_xy)
    zeroed = (_np(js) == 0).all(-1)
    assert zeroed.any() and not zeroed.all()
    _close(tb, jb, 1e-4 if not clip else TOL)
    _close(ts, js)


def test_yolo_loss_matches_jax():
    """Two images, five ground truths each: one of zero size (invalid),
    two sharing a cell and anchor (the later one's targets win in
    both), labels 0-3; the loss per image and its gradient."""
    gt = np.array([[[0.31, 0.42, 0.20, 0.30], [0.32, 0.44, 0.22, 0.31],
                    [0.80, 0.15, 0.50, 0.60], [0.0, 0.0, 0.0, 0.0],
                    [0.55, 0.70, 0.05, 0.08]],
                   [[0.10, 0.90, 0.12, 0.10], [0.60, 0.40, 0.90, 0.80],
                    [0.45, 0.55, 0.06, 0.04], [0.95, 0.05, 0.30, 0.20],
                    [0.0, 0.0, 0.0, 0.0]]], "float32")
    label = np.array([[1, 2, 0, 3, 1], [0, 3, 2, 1, 0]], "int32")
    jx, tx = _pair(_rand((2, 3 * (5 + 4), 5, 6), 16), grad=True)
    args = (ANCHORS + [59, 119, 116, 90, 156, 198], [0, 1, 2], 4, 0.7, 32)
    jl = jops.yolo_loss(jx, jp.to_tensor(gt), jp.to_tensor(label), *args)
    tl = tops.yolo_loss(tx, tp.to_tensor(gt), tp.to_tensor(label), *args)
    assert tuple(tl.shape) == (2,)
    _close(tl, jl)
    _backward(jl, tl, 17)
    _grad_close(tx.grad, jx.grad)


# ------------------------------------------------------------ host ops ---

def _boxes(n, seed, size=50.0):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, size, (n, 2))
    wh = rng.uniform(2, size / 3, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype("float32")


@pytest.mark.parametrize("kw", [
    dict(), dict(top_k=5), dict(iou_threshold=0.5, cats=True)],
    ids=["plain", "top_k", "categories"])
def test_nms_matches_jax_with_equal_scores(kw):
    kw = dict(kw)
    boxes = _boxes(40, 18)
    scores = np.round(np.random.RandomState(19).rand(40), 1).astype(
        "float32")                                   # many equal scores
    cats = np.random.RandomState(20).randint(0, 3, 40).astype("int64") \
        if kw.pop("cats", False) else None
    jk = jops.nms(jp.to_tensor(boxes), scores=jp.to_tensor(scores),
                  category_idxs=None if cats is None else jp.to_tensor(cats),
                  **kw)
    tk = tops.nms(tp.to_tensor(boxes), scores=tp.to_tensor(scores),
                  category_idxs=None if cats is None else tp.to_tensor(cats),
                  **kw)
    assert tk.dtype == torch.int64 and isinstance(tk, tp.Tensor)
    np.testing.assert_array_equal(_np(tk), _np(jk))


@pytest.mark.parametrize("gaussian", [False, True])
def test_matrix_nms_matches_jax(gaussian):
    boxes = np.stack([_boxes(30, 21 + i, 1.0) for i in range(2)])
    scores = np.random.RandomState(23).rand(2, 4, 30).astype("float32")
    scores[0, 2, :5] = 0.75                           # equal scores
    kw = dict(score_threshold=0.3, post_threshold=0.1, nms_top_k=20,
              keep_top_k=25, use_gaussian=gaussian, return_index=True)
    jo, ji, jn = jops.matrix_nms(jp.to_tensor(boxes), jp.to_tensor(scores),
                                 **kw)
    to, ti, tn = tops.matrix_nms(tp.to_tensor(boxes), tp.to_tensor(scores),
                                 **kw)
    np.testing.assert_array_equal(_np(ti), _np(ji))
    np.testing.assert_array_equal(_np(tn), _np(jn))
    _close(to, jo)


def test_generate_proposals_matches_jax():
    A, H, W = 3, 4, 5
    rng = np.random.RandomState(24)
    scores = np.round(rng.rand(2, A, H, W), 1).astype("float32")
    deltas = (0.3 * rng.randn(2, 4 * A, H, W)).astype("float32")
    anchors = np.concatenate([_boxes(H * W * A, 25, 40.0)]).reshape(
        H, W, A, 4)
    var = np.full((H, W, A, 4), 0.5, "float32")
    img = np.array([[40.0, 45.0], [30.0, 50.0]], "float32")
    kw = dict(pre_nms_top_n=40, post_nms_top_n=12, nms_thresh=0.6,
              min_size=1.0, return_rois_num=True)
    jr, js, jn = jops.generate_proposals(
        jp.to_tensor(scores), jp.to_tensor(deltas), jp.to_tensor(img),
        jp.to_tensor(anchors), jp.to_tensor(var), **kw)
    tr, ts, tn = tops.generate_proposals(
        tp.to_tensor(scores), tp.to_tensor(deltas), tp.to_tensor(img),
        tp.to_tensor(anchors), tp.to_tensor(var), **kw)
    np.testing.assert_array_equal(_np(tn), _np(jn))
    _close(tr, jr)
    _close(ts, js)


def test_distribute_fpn_proposals_matches_jax():
    rois = np.concatenate([_boxes(20, 26, 30.0), _boxes(20, 27, 400.0)])
    jo, jr, jn = jops.distribute_fpn_proposals(
        jp.to_tensor(rois), 2, 5, 4, 224, rois_num=jp.to_tensor([40]))
    to, tr, tn = tops.distribute_fpn_proposals(
        tp.to_tensor(rois), 2, 5, 4, 224, rois_num=tp.to_tensor([40]))
    np.testing.assert_array_equal(_np(tr), _np(jr))
    for t, j in zip(to, jo):
        _close(t, j)
    for t, j in zip(tn, jn):
        np.testing.assert_array_equal(_np(t), _np(j))


@pytest.mark.parametrize("kw", [
    dict(min_sizes=[30.0], max_sizes=[60.0], aspect_ratios=[2.0],
         flip=True, clip=True),
    dict(min_sizes=[20.0, 40.0], aspect_ratios=[2.0, 3.0], flip=True,
         min_max_aspect_ratios_order=True, max_sizes=[40.0, 80.0],
         offset=0.4),
    dict(min_sizes=[16.0], steps=(8.0, 10.0))])
def test_prior_box_matches_jax(kw):
    feat, image = np.zeros((1, 2, 5, 6), "float32"), np.zeros(
        (1, 3, 50, 60), "float32")
    jb, jv = jops.prior_box(jp.to_tensor(feat), jp.to_tensor(image), **kw)
    tb, tv = tops.prior_box(tp.to_tensor(feat), tp.to_tensor(image), **kw)
    _close(tb, jb)
    _close(tv, jv)


@pytest.mark.parametrize("code_type,normalized,axis", [
    ("encode_center_size", True, 0), ("encode_center_size", False, 0),
    ("decode_center_size", True, 0), ("decode_center_size", False, 1)])
def test_box_coder_matches_jax(code_type, normalized, axis):
    priors = _boxes(6, 28, 1.0 if normalized else 40.0)
    pvar = np.random.RandomState(29).uniform(0.1, 0.3, (6, 4)).astype(
        "float32")
    if code_type == "encode_center_size":
        target = _boxes(5, 30, 1.0 if normalized else 40.0)
    else:
        target = _rand((6, 6, 4), 31, 0.5)
    jy = jops.box_coder(jp.to_tensor(priors), jp.to_tensor(pvar),
                        jp.to_tensor(target), code_type, normalized, axis)
    ty = tops.box_coder(tp.to_tensor(priors), tp.to_tensor(pvar),
                        tp.to_tensor(target), code_type, normalized, axis)
    _close(ty, jy)


def test_read_file_and_decode_jpeg(tmp_path):
    path = tmp_path / "x.bin"
    path.write_bytes(bytes(range(256)) * 3)
    np.testing.assert_array_equal(_np(tops.read_file(str(path))),
                                  _np(jops.read_file(str(path))))
    try:
        from PIL import Image
    except ImportError:
        with pytest.raises(RuntimeError, match="decode_jpeg needs PIL"):
            tops.decode_jpeg(tops.read_file(str(path)))
        return
    buf = io.BytesIO()
    Image.fromarray(np.random.RandomState(32).randint(
        0, 255, (12, 10, 3)).astype("uint8")).save(buf, format="JPEG")
    path.write_bytes(buf.getvalue())
    for mode in ("unchanged", "gray"):
        t = tops.decode_jpeg(tops.read_file(str(path)), mode)
        j = jops.decode_jpeg(jops.read_file(str(path)), mode)
        assert t.dtype == torch.uint8
        np.testing.assert_array_equal(_np(t), _np(j))


def test_decode_jpeg_without_pil(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(RuntimeError, match="decode_jpeg needs PIL"):
        tops.decode_jpeg(tp.to_tensor(np.zeros(4, "uint8")))


# --------------------------------------------------------- static.nn ---

@pytest.fixture
def same_draws(monkeypatch):
    """The JAX and the port's initializers draw the same numpy weights,
    shape by shape in call order."""
    rngs = {}

    def draw(key):
        def call(self, shape, dtype=None, device=None):
            rng = rngs.setdefault(key, np.random.RandomState(33))
            arr = (0.3 * rng.randn(*shape)).astype("float32")
            return jnp.asarray(arr) if key == "jax" else torch.from_numpy(arr)
        return call

    for mod, key in ((jinit, "jax"), (tinit, "port")):
        for name in dir(mod):
            cls = getattr(mod, name)
            if isinstance(cls, type) and issubclass(cls, mod.Initializer):
                monkeypatch.setattr(cls, "__call__", draw(key))


@pytest.mark.parametrize("with_mask", [True, False])
def test_static_deform_conv2d_matches_jax(same_draws, with_mask):
    x = _rand((2, 4, 6, 7), 34)
    off = _rand((2, 18, 6, 7), 35)
    m = np.random.RandomState(36).rand(2, 9, 6, 7).astype("float32")
    jy = jsnn.deform_conv2d(jp.to_tensor(x), jp.to_tensor(off),
                            jp.to_tensor(m) if with_mask else None, 5, 3,
                            padding=1)
    ty = tsnn.deform_conv2d(tp.to_tensor(x), tp.to_tensor(off),
                            tp.to_tensor(m) if with_mask else None, 5, 3,
                            padding=1)
    _close(ty, jy)


def test_static_multi_box_head_matches_jax(same_draws):
    feats = [_rand((2, 3, 6, 6), 37), _rand((2, 4, 3, 3), 38),
             _rand((2, 4, 2, 2), 39)]
    image = np.zeros((2, 3, 48, 48), "float32")
    kw = dict(base_size=48, num_classes=5, aspect_ratios=[[2.0], [2.0, 3.0],
                                                          [2.0]],
              min_ratio=20, max_ratio=90, flip=True)
    jouts = jsnn.multi_box_head([jp.to_tensor(f) for f in feats],
                                jp.to_tensor(image), **kw)
    touts = tsnn.multi_box_head([tp.to_tensor(f) for f in feats],
                                tp.to_tensor(image), **kw)
    for t, j in zip(touts, jouts):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t, j)
