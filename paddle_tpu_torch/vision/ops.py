"""Vision detection ops (counterpart of ``paddle_tpu/vision/ops.py``;
reference: ``python/paddle/vision/ops.py``).

They compute the JAX functions, not torchvision's or Paddle-CUDA's:
``roi_align`` with ``sampling_ratio=-1`` samples a fixed 2 x 2 grid per
bin, its bilinear sample is zero outside ``(-1, H) x (-1, W)`` and clamps
its indices inside; an empty ``roi_pool`` bin is ``-inf``; ``yolo_box``
clips x1 and y1 at 0 and x2 and y2 at ``img - 1``.

The differentiable ops run on the input's device and differentiate
through autograd. Where the JAX package loops over RoIs, images and
groups in Python, the port batches:

- ``roi_align``: one gather of the four corners of every sample of a
  chunk of RoIs from the channels-last feature map, then the weights;
- ``roi_pool``: one gather of every bin's cells within a window of the
  largest bin's extent (read on the host), then a masked max over it;
  its gradient splits evenly among tied maxima, as JAX's does;
- ``psroi_pool``: each bin's mean from a float64 integral image (four
  reads), with the JAX package's bin edges computed on the host;
- ``deform_conv2d``: one bilinear gather for all images and deformable
  groups, then one grouped matmul with the kernel.

Chunks of RoIs or images keep every intermediate under ``CHUNK_BYTES``.

The data-dependent ops (``nms``, ``matrix_nms``, ``generate_proposals``,
``distribute_fpn_proposals``) and ``prior_box`` run the JAX package's
numpy algorithm on the host (its unstable ``np.argsort(-s)`` included,
so ties break as there) and return tensors on the input's device.
``box_coder`` is device math. ``decode_jpeg`` needs PIL.
"""
from __future__ import annotations

import io as _io
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as TF

from .. import nn
from ..core.device import current_device
from ..core.tensor import Tensor, to_numpy, to_tensor, to_tensor_arg

__all__ = ["nms", "roi_align", "roi_pool", "deform_conv2d", "yolo_box",
           "DeformConv2D", "RoIAlign", "RoIPool", "PSRoIPool", "psroi_pool",
           "prior_box", "box_coder", "matrix_nms",
           "distribute_fpn_proposals", "generate_proposals", "yolo_loss",
           "read_file", "decode_jpeg"]

# the largest intermediate a batched op makes for one chunk of RoIs or
# images
CHUNK_BYTES = 256 << 20


def _wrap(t: torch.Tensor) -> Tensor:
    return t if isinstance(t, Tensor) else t.as_subclass(Tensor)


def _host(x) -> np.ndarray:
    """``x`` (a tensor on any device, an array or a list) as numpy."""
    if isinstance(x, torch.Tensor):
        return to_numpy(x)
    return np.asarray(x)


def _device_of(x) -> torch.device:
    return x.device if isinstance(x, torch.Tensor) else current_device()


def _on(arr, device) -> Tensor:
    """A host result as a ``Tensor`` on ``device``."""
    return _wrap(torch.from_numpy(np.array(arr)).to(device))


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _div(num: torch.Tensor, den) -> torch.Tensor:
    """``num / den`` by a true division (a CUDA tensor over a Python
    number is otherwise a multiply by its reciprocal, an ulp off, and
    bin edges are floored and ceiled)."""
    return torch.div(num, torch.full_like(num, den))


def _chunks(total: int, item_bytes: int) -> List[Tuple[int, int]]:
    step = max(1, CHUNK_BYTES // max(int(item_bytes), 1))
    return [(a, min(a + step, total)) for a in range(0, total, step)]


def _images_of(boxes_num, k: int, device) -> torch.Tensor:
    """The image of each of ``k`` boxes from the per-image counts
    ``boxes_num`` (prefix counts, reference semantics)."""
    if isinstance(boxes_num, torch.Tensor):
        counts = boxes_num.detach().to(device=device, dtype=torch.int64)
    else:
        counts = torch.as_tensor(np.asarray(boxes_num, np.int64),
                                 device=device)
    return torch.repeat_interleave(
        torch.arange(counts.numel(), device=device), counts.reshape(-1),
        output_size=k)


# ----------------------------------------------------------------- nms ---

def _iou_matrix(boxes):
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = (x2 - x1) * (y2 - y1)
    xx1 = np.maximum(x1[:, None], x1[None, :])
    yy1 = np.maximum(y1[:, None], y1[None, :])
    xx2 = np.minimum(x2[:, None], x2[None, :])
    yy2 = np.minimum(y2[:, None], y2[None, :])
    inter = np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
    union = area[:, None] + area[None, :] - inter
    return inter / np.maximum(union, 1e-10)


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """Greedy hard NMS on the host; the kept indices (int64) on the boxes'
    device."""
    b = _host(boxes)
    n = b.shape[0]
    order = np.arange(n) if scores is None else np.argsort(-_host(scores))
    cats = (np.zeros(n, dtype=np.int64) if category_idxs is None
            else _host(category_idxs))
    iou = _iou_matrix(b)
    keep = []
    suppressed = np.zeros(n, dtype=bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        suppressed |= (iou[i] > iou_threshold) & (cats == cats[i])
        suppressed[i] = True
    keep = np.asarray(keep, dtype=np.int64)
    if top_k is not None:
        keep = keep[:top_k]
    return _on(keep, _device_of(boxes))


# ------------------------------------------------------------ roi ops ---

def _bilinear(table, base, H: int, W: int, y, x):
    """Bilinear samples of a channels-last feature table ``[rows, C]``
    (row ``base + yi * W + xi``) at ``y``/``x`` (one shape, float): the
    JAX ``_bilinear`` (zero outside ``(-1, H) x (-1, W)``, indices clamped
    inside). Returns ``[*y.shape, C]``."""
    y0, x0 = torch.floor(y), torch.floor(x)
    y1, x1 = y0 + 1, x0 + 1
    wy1, wx1 = y - y0, x - x0
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1

    def at(yy, xx):
        yi = yy.to(torch.int64).clamp(0, H - 1)
        xi = xx.to(torch.int64).clamp(0, W - 1)
        rows = table.index_select(0, (base + yi * W + xi).reshape(-1))
        return rows.reshape(*yy.shape, table.shape[1])

    valid = ((y > -1.0) & (y < H) & (x > -1.0) & (x < W)).to(table.dtype)
    out = (at(y0, x0) * (wy0 * wx0)[..., None]
           + at(y0, x1) * (wy0 * wx1)[..., None]
           + at(y1, x0) * (wy1 * wx0)[..., None]
           + at(y1, x1) * (wy1 * wx1)[..., None])
    return out * valid[..., None]


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True):
    """[N,C,H,W] features + [K,4] boxes -> [K,C,ph,pw]; ``boxes_num``
    assigns the boxes to images (prefix counts)."""
    ph, pw = _pair(output_size)
    x = to_tensor_arg(x)
    boxes = to_tensor_arg(boxes).to(x.device)
    N, C, H, W = x.shape
    K = boxes.shape[0]
    if K == 0:
        return _wrap(x.new_zeros((0, C, ph, pw)))
    img = _images_of(boxes_num, K, x.device)
    sr = sampling_ratio if sampling_ratio > 0 else 2
    r = boxes * spatial_scale - (0.5 if aligned else 0.0)
    x1, y1, x2, y2 = r.unbind(1)
    rw, rh = x2 - x1, y2 - y1
    if not aligned:
        rw, rh = torch.clamp(rw, min=1.0), torch.clamp(rh, min=1.0)
    bin_h, bin_w = _div(rh, ph), _div(rw, pw)
    # the sample offsets in bins, in float32 on the host as JAX forms them
    step = (np.arange(sr, dtype=np.float32) + np.float32(0.5)) / np.float32(sr)
    iy = torch.from_numpy(np.arange(ph, dtype=np.float32)[:, None] + step)
    ix = torch.from_numpy(np.arange(pw, dtype=np.float32)[:, None] + step)
    iy, ix = iy.to(r.device, r.dtype), ix.to(r.device, r.dtype)
    ys = y1[:, None, None] + iy * bin_h[:, None, None]       # [K, ph, sr]
    xs = x1[:, None, None] + ix * bin_w[:, None, None]       # [K, pw, sr]
    table = x.permute(0, 2, 3, 1).reshape(N * H * W, C)
    shape = (ph, pw, sr, sr)
    outs = []
    for a, b in _chunks(K, 6 * ph * pw * sr * sr * C * x.element_size()):
        k = b - a
        y = ys[a:b, :, None, :, None].expand(k, *shape)
        xx = xs[a:b, None, :, None, :].expand(k, *shape)
        base = (img[a:b] * (H * W)).reshape(k, 1, 1, 1, 1)
        s = _bilinear(table, base, H, W, y, xx)     # [k, ph, pw, sr, sr, C]
        outs.append(s.reshape(k, ph, pw, sr * sr, C).mean(dim=3)
                    .permute(0, 3, 1, 2))
    return _wrap(torch.cat(outs))


def _bin_edges(start, size, bins: int, limit: int):
    """The JAX roi_pool's bins along one axis as integer ranges ``[lo,
    hi)`` clamped to ``[0, limit)``: cells ``h >= floor(s)`` and ``h <
    max(ceil(e), s + 1)``, ``s``/``e`` a bin's float start and end."""
    i = torch.arange(bins, device=start.device, dtype=start.dtype)
    s = start[:, None] + i * size[:, None]
    e = start[:, None] + (i + 1) * size[:, None]
    lo = torch.floor(s)
    hi = torch.ceil(torch.maximum(torch.ceil(e), s + 1))
    return (lo.clamp(0, limit).to(torch.int64),
            hi.clamp(0, limit).to(torch.int64))


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0):
    """Quantized max-pool RoI (the JAX roi_pool: integer boxes from
    ``round(box * spatial_scale)``, an empty bin is -inf)."""
    ph, pw = _pair(output_size)
    x = to_tensor_arg(x)
    boxes = to_tensor_arg(boxes).to(x.device)
    N, C, H, W = x.shape
    K = boxes.shape[0]
    if K == 0:
        return _wrap(x.new_zeros((0, C, ph, pw)))
    img = _images_of(boxes_num, K, x.device)
    r = torch.round(boxes * spatial_scale)
    x1, y1, x2, y2 = r.unbind(1)
    rh = torch.clamp(y2 - y1 + 1, min=1.0)
    rw = torch.clamp(x2 - x1 + 1, min=1.0)
    h_lo, h_hi = _bin_edges(y1, _div(rh, ph), ph, H)
    w_lo, w_hi = _bin_edges(x1, _div(rw, pw), pw, W)
    # every bin's cells within a window of the largest bin's extent
    # (one host read), read from the channels-last map
    lh = int((h_hi - h_lo).max().clamp(min=1))
    lw = int((w_hi - w_lo).max().clamp(min=1))
    dev = x.device
    rows = h_lo[:, :, None] + torch.arange(lh, device=dev)    # [K, ph, lh]
    cols = w_lo[:, :, None] + torch.arange(lw, device=dev)    # [K, pw, lw]
    inside = ((rows < h_hi[:, :, None])[:, :, None, :, None]
              & (cols < w_hi[:, :, None])[:, None, :, None, :])
    cells = ((img[:, None, None] * H + rows.clamp(max=H - 1)) * W)[
        :, :, None, :, None] + cols.clamp(max=W - 1)[:, None, :, None, :]
    table = x.permute(0, 2, 3, 1).reshape(N * H * W, C)
    neg = torch.tensor(-float("inf"), dtype=x.dtype, device=dev)
    outs = []
    for a, b in _chunks(K, 2 * ph * pw * lh * lw * C * x.element_size()):
        k = b - a
        vals = table.index_select(0, cells[a:b].reshape(-1)).reshape(
            k, ph, pw, lh * lw, C)
        vals = torch.where(inside[a:b].reshape(k, ph, pw, lh * lw, 1), vals,
                           neg)
        outs.append(vals.amax(dim=3).permute(0, 3, 1, 2))   # [k, C, ph, pw]
    return _wrap(torch.cat(outs))


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
               name=None):
    """Position-sensitive RoI pooling: the C = oh * ow * c_out channels
    are partitioned so each output bin (i, j) averages its own channel
    group over its cells (0 where it has none). The bin edges are the
    JAX package's, computed on the host in float64."""
    oh, ow = _pair(output_size)
    x = to_tensor_arg(x)
    N, C, H, W = x.shape
    if C % (oh * ow):
        raise ValueError(f"channels {C} must divide {oh}x{ow}")
    c_out = C // (oh * ow)
    b = _host(boxes).astype(np.float64) * spatial_scale
    counts = _host(boxes_num).reshape(-1).astype(np.int64)
    img = np.repeat(np.arange(len(counts)), counts)
    K = b.shape[0]
    x1, y1, x2, y2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]

    def edges(start, end, bins, limit):
        size = np.maximum(end - start, 1e-3) / bins
        i = np.arange(bins)
        lo = np.floor(start[:, None] + i * size[:, None]).astype(np.int64)
        hi = np.maximum(np.ceil(start[:, None] + (i + 1) * size[:, None])
                        .astype(np.int64), lo + 1)
        return np.clip(lo, 0, limit), np.clip(hi, 0, limit)

    hs, he = edges(y1, y2, oh, H)
    ws, we = edges(x1, x2, ow, W)
    corners = np.stack(np.broadcast_arrays(
        hs[:, :, None], he[:, :, None], ws[:, None, :], we[:, None, :]))
    corners = torch.from_numpy(corners).to(x.device)        # [4, K, oh, ow]
    hs_, he_, ws_, we_ = corners
    ch = (torch.arange(oh * ow, device=x.device).reshape(oh, ow, 1) * c_out
          + torch.arange(c_out, device=x.device))            # [oh, ow, c_out]
    plane = (torch.from_numpy(img).to(x.device)[:, None, None, None] * C
             + ch) * ((H + 1) * (W + 1))                    # [K, oh, ow, c]
    sat = TF.pad(x.double().cumsum(2).cumsum(3), (1, 0, 1, 0)).reshape(-1)

    def at(h, w):
        return sat[plane + (h * (W + 1) + w)[..., None]]

    total = at(he_, we_) - at(hs_, we_) - at(he_, ws_) + at(hs_, ws_)
    area = ((he_ - hs_) * (we_ - ws_)).clamp(min=0)[..., None]
    out = torch.where(area > 0, total / area.clamp(min=1), 0.0)
    return _wrap(out.to(x.dtype).permute(0, 3, 1, 2).reshape(K, c_out, oh,
                                                             ow))


class RoIAlign(nn.Layer):
    """Layer of ``roi_align`` (reference ``vision/ops.py RoIAlign``)."""

    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_align(x, boxes, boxes_num, self.output_size,
                         self.spatial_scale)


class RoIPool(nn.Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self.output_size,
                        self.spatial_scale)


class PSRoIPool(nn.Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return psroi_pool(x, boxes, boxes_num, self.output_size,
                          self.spatial_scale)


# ------------------------------------------------------- deform_conv2d ---

def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None):
    """Deformable convolution v1 / v2 (``mask``), NCHW: every tap
    bilinear-sampled at its offset-shifted place (the JAX ``_bilinear``),
    then one grouped matmul with the kernel."""
    x, offset, weight = (to_tensor_arg(t) for t in (x, offset, weight))
    sh, sw = _pair(stride)
    pad_h, pad_w = _pair(padding)
    dh, dw = _pair(dilation)
    N, C, H, W = x.shape
    Cout, cin_g, kh, kw = weight.shape
    dg = deformable_groups
    Ho = (H + 2 * pad_h - dh * (kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pad_w - dw * (kw - 1) - 1) // sw + 1
    dev, dt = x.device, offset.dtype
    oy = torch.arange(Ho, device=dev) * sh - pad_h
    ox = torch.arange(Wo, device=dev) * sw - pad_w
    base_y = (oy[:, None, None, None]
              + (torch.arange(kh, device=dev) * dh)[:, None]).to(dt)
    base_x = (ox[None, :, None, None]
              + torch.arange(kw, device=dev) * dw).to(dt)
    # offsets [N, 2 dg kh kw, Ho, Wo] -> [N, dg, Ho, Wo, kh, kw] each
    off = offset.reshape(N, dg, kh, kw, 2, Ho, Wo).permute(4, 0, 1, 5, 6, 2, 3)
    m = (None if mask is None else to_tensor_arg(mask)
         .reshape(N, dg, kh, kw, Ho, Wo).permute(0, 1, 4, 5, 2, 3))
    cpg = C // dg
    table = x.reshape(N, dg, cpg, H, W).permute(0, 1, 3, 4, 2) \
        .reshape(N * dg * H * W, cpg)
    taps = Ho * Wo * kh * kw
    outs = []
    for a, b in _chunks(N, 8 * dg * taps * cpg * x.element_size()):
        n = b - a
        ys = base_y + off[0, a:b]
        xs = base_x + off[1, a:b]
        base = (torch.arange(a * dg, b * dg, device=dev) * (H * W)) \
            .reshape(n, dg, 1, 1, 1, 1)
        s = _bilinear(table, base, H, W, ys, xs)  # [n, dg, Ho, Wo, kh, kw, cpg]
        if m is not None:
            s = s * m[a:b, ..., None]
        # columns [n, groups, C / groups * kh * kw, Ho * Wo], channel-major
        col = s.permute(0, 1, 6, 4, 5, 2, 3).reshape(
            n, groups, (C // groups) * kh * kw, Ho * Wo)
        w = weight.reshape(groups, Cout // groups, cin_g * kh * kw)
        outs.append(torch.matmul(w, col).reshape(n, Cout, Ho, Wo))
    y = torch.cat(outs)
    if bias is not None:
        y = y + to_tensor_arg(bias)[None, :, None, None]
    return _wrap(y)


class DeformConv2D(nn.Layer):
    """Layer of ``deform_conv2d`` (reference ``vision/ops.py
    DeformConv2D``): ``weight [out, in / groups, kh, kw]`` Xavier-uniform
    and ``bias [out]`` zeros, unless ``bias_attr=False``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        k = _pair(kernel_size)
        self._conv = dict(stride=stride, padding=padding, dilation=dilation,
                          deformable_groups=deformable_groups, groups=groups)
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, k[0], k[1]])
        self.bias = (None if bias_attr is False else
                     self.create_parameter([out_channels], is_bias=True))

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.bias, mask=mask,
                             **self._conv)


# ---------------------------------------------------------------- yolo ---

def _sigmoid(v):
    return 1.0 / (1.0 + torch.exp(-v))


def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01,
             downsample_ratio=32, clip_bbox=True, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5):
    """Decode a YOLO head ``[N, A (5 + classes), H, W]`` into boxes
    ``[N, A H W, 4]`` and scores ``[N, A H W, classes]``; both zero where
    the objectness is under ``conf_thresh``."""
    x = to_tensor_arg(x)
    anchors = np.asarray(anchors, dtype=np.float32).reshape(-1, 2)
    A = anchors.shape[0]
    N, _, H, W = x.shape
    dt, dev = x.dtype, x.device
    img = torch.as_tensor(_host(img_size) if not isinstance(
        img_size, torch.Tensor) else img_size.detach(), device=dev).to(dt)
    xa = x.reshape(N, A, 5 + class_num, H, W)
    gx = torch.arange(W, dtype=dt, device=dev)
    gy = torch.arange(H, dtype=dt, device=dev)
    sx = _sigmoid(xa[:, :, 0]) * scale_x_y - (scale_x_y - 1.0) / 2.0
    sy = _sigmoid(xa[:, :, 1]) * scale_x_y - (scale_x_y - 1.0) / 2.0
    bx = _div(gx + sx, W)
    by = _div(gy[:, None] + sy, H)
    anc = torch.as_tensor(anchors, dtype=dt, device=dev)
    bw = _div(torch.exp(xa[:, :, 2]) * anc[None, :, 0, None, None],
              W * downsample_ratio)
    bh = _div(torch.exp(xa[:, :, 3]) * anc[None, :, 1, None, None],
              H * downsample_ratio)
    conf = _sigmoid(xa[:, :, 4])
    probs = _sigmoid(xa[:, :, 5:]) * conf[:, :, None]
    imgh = img[:, 0].reshape(N, 1, 1, 1)
    imgw = img[:, 1].reshape(N, 1, 1, 1)
    x1 = (bx - bw / 2) * imgw
    y1 = (by - bh / 2) * imgh
    x2 = (bx + bw / 2) * imgw
    y2 = (by + bh / 2) * imgh
    if clip_bbox:
        x1, y1 = torch.clamp(x1, min=0), torch.clamp(y1, min=0)
        x2, y2 = torch.minimum(x2, imgw - 1), torch.minimum(y2, imgh - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1).reshape(N, -1, 4)
    scores = probs.permute(0, 1, 3, 4, 2).reshape(N, -1, class_num)
    keep = (conf.reshape(N, -1) >= conf_thresh)[..., None]
    return _wrap(boxes * keep), _wrap(scores * keep)


def _bce(z, t):
    return torch.clamp(z, min=0) - z * t + torch.log1p(torch.exp(-z.abs()))


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """The JAX YOLOv3 loss, per image ``[N]``: every ground truth marks
    the cell under its centre at its best anchor by width/height IoU;
    box terms and classes there, objectness everywhere. Where two ground
    truths mark one cell, the later one's box targets win (the JAX
    scatter's order) and the objectness and class targets take the
    max."""
    x, gt_box = to_tensor_arg(x), to_tensor_arg(gt_box)
    gt_label = to_tensor_arg(gt_label).to(x.device)
    an = [(anchors[2 * i], anchors[2 * i + 1]) for i in anchor_mask]
    N, _, H, W = x.shape
    A, C = len(an), class_num
    dev = x.device
    xr = x.reshape(N, A, 5 + C, H, W)
    px, py = torch.sigmoid(xr[:, :, 0]), torch.sigmoid(xr[:, :, 1])
    pobj, pcls = xr[:, :, 4], xr[:, :, 5:]
    in_w, in_h = W * downsample_ratio, H * downsample_ratio
    gx, gy = gt_box[..., 0] * W, gt_box[..., 1] * H
    gw, gh = gt_box[..., 2] * in_w, gt_box[..., 3] * in_h
    gi = gx.to(torch.int32).clamp(0, W - 1)
    gj = gy.to(torch.int32).clamp(0, H - 1)
    aw = torch.tensor([a[0] for a in an], dtype=torch.float32, device=dev)
    ah = torch.tensor([a[1] for a in an], dtype=torch.float32, device=dev)
    inter = (torch.minimum(gw[..., None], aw)
             * torch.minimum(gh[..., None], ah))
    iou_a = inter / (gw[..., None] * gh[..., None] + aw * ah - inter + 1e-10)
    best_a = torch.argmax(iou_a, dim=-1)                      # [N, G]
    valid = (gt_box[..., 2] > 0) & (gt_box[..., 3] > 0)
    vm = valid.to(torch.float32)
    cells = N * A * H * W
    cell = (((torch.arange(N, device=dev)[:, None] * A + best_a) * H
             + gj.long()) * W + gi.long()).reshape(-1)
    # the last ground truth (in the JAX scatter's row-major order) to
    # mark each cell writes the box targets; the others write to a spare
    # slot past the grid
    order = torch.arange(cell.numel(), device=dev)
    last = torch.full((cells,), -1, dtype=torch.int64, device=dev) \
        .scatter_reduce(0, cell, order, "amax")
    slot = torch.where(last[cell] == order, cell, cells)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def put(values):
        buf = torch.zeros(cells + 1, dtype=torch.float32, device=dev)
        return buf.index_put((slot,), values.reshape(-1).float())[:cells] \
            .reshape(N, A, H, W)

    tx = put(torch.where(valid, gx - gi, zero))
    ty = put(torch.where(valid, gy - gj, zero))
    tw = put(torch.where(valid, torch.log(torch.clamp(gw, min=1e-9)
                                          / aw[best_a]), zero))
    th = put(torch.where(valid, torch.log(torch.clamp(gh, min=1e-9)
                                          / ah[best_a]), zero))
    tobj = torch.zeros(cells, device=dev).scatter_reduce(
        0, cell, vm.reshape(-1), "amax").reshape(N, A, H, W)
    onehot = (gt_label.long()[..., None]
              == torch.arange(C, device=dev)).float() * vm[..., None]
    tcls = torch.zeros(cells, C, device=dev).scatter_reduce(
        0, cell[:, None].expand(-1, C), onehot.reshape(-1, C), "amax") \
        .reshape(N, A, H, W, C)
    box_scale = 2.0 - (torch.exp(tw) * aw[None, :, None, None] / in_w) \
        * (torch.exp(th) * ah[None, :, None, None] / in_h)
    lxy = tobj * box_scale * ((px - tx) ** 2 + (py - ty) ** 2)
    lwh = tobj * box_scale * ((xr[:, :, 2] - tw) ** 2
                              + (xr[:, :, 3] - th) ** 2)
    lobj = _bce(pobj, tobj)
    lcls = tobj[..., None] * _bce(torch.movedim(pcls, 2, -1), tcls)
    return _wrap(lxy.sum(dim=(1, 2, 3)) + lwh.sum(dim=(1, 2, 3))
                 + lobj.sum(dim=(1, 2, 3)) + lcls.sum(dim=(1, 2, 3, 4)))


# ----------------------------------------------------------- SSD / RPN ---

def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),  # noqa: A002
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5,
              min_max_aspect_ratios_order=False, name=None):
    """SSD prior boxes: per feature-map cell, boxes of each (size,
    aspect ratio) in ``[0, 1]`` image coordinates. Returns (boxes ``[H,
    W, P, 4]``, variances the same shape), on ``input``'s device."""
    fh, fw = int(input.shape[2]), int(input.shape[3])
    ih, iw = int(image.shape[2]), int(image.shape[3])
    step_h = steps[1] if steps and steps[1] else ih / fh
    step_w = steps[0] if steps and steps[0] else iw / fw

    ars = [1.0]
    for ar in aspect_ratios:
        if not any(abs(ar - a) < 1e-6 for a in ars):
            ars.append(float(ar))
            if flip:
                ars.append(1.0 / float(ar))

    whs = []
    for ms in min_sizes:
        if min_max_aspect_ratios_order:
            whs.append((ms, ms))
            if max_sizes:
                mx = max_sizes[min_sizes.index(ms)]
                whs.append((np.sqrt(ms * mx), np.sqrt(ms * mx)))
            for ar in ars:
                if abs(ar - 1.0) < 1e-6:
                    continue
                whs.append((ms * np.sqrt(ar), ms / np.sqrt(ar)))
        else:
            for ar in ars:
                whs.append((ms * np.sqrt(ar), ms / np.sqrt(ar)))
            if max_sizes:
                mx = max_sizes[min_sizes.index(ms)]
                whs.append((np.sqrt(ms * mx), np.sqrt(ms * mx)))
    boxes = np.zeros((fh, fw, len(whs), 4), np.float32)
    for i in range(fh):
        cy = (i + offset) * step_h
        for j in range(fw):
            cx = (j + offset) * step_w
            for p, (w, h) in enumerate(whs):
                boxes[i, j, p] = [(cx - w / 2) / iw, (cy - h / 2) / ih,
                                  (cx + w / 2) / iw, (cy + h / 2) / ih]
    if clip:
        boxes = np.clip(boxes, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variance, np.float32), boxes.shape)
    dev = _device_of(input)
    return _on(boxes, dev), _on(var, dev)


def box_coder(prior_box, prior_box_var, target_box,  # noqa: A002
              code_type="encode_center_size", box_normalized=True, axis=0,
              name=None):
    """Encode boxes against priors (``[N targets, M priors, 4]``) or
    decode deltas ``[N, M, 4]`` (``axis`` names the target axis the
    priors broadcast along), on the priors' device."""
    pb = to_tensor_arg(prior_box)
    dev = pb.device
    pbv = torch.as_tensor(_host(prior_box_var) if not isinstance(
        prior_box_var, torch.Tensor) else prior_box_var, device=dev)
    tb = to_tensor_arg(target_box).to(dev)
    norm = 0.0 if box_normalized else 1.0
    pw = pb[..., 2] - pb[..., 0] + norm
    ph = pb[..., 3] - pb[..., 1] + norm
    pcx = pb[..., 0] + pw / 2
    pcy = pb[..., 1] + ph / 2
    if code_type == "encode_center_size":
        tw = tb[..., 2] - tb[..., 0] + norm
        th = tb[..., 3] - tb[..., 1] + norm
        tcx = tb[..., 0] + tw / 2
        tcy = tb[..., 1] + th / 2
        dx = (tcx[:, None] - pcx[None]) / pw[None]
        dy = (tcy[:, None] - pcy[None]) / ph[None]
        dw = torch.log(tw[:, None] / pw[None])
        dh = torch.log(th[:, None] / ph[None])
        return _wrap(torch.stack([dx, dy, dw, dh], dim=-1) / pbv[None])
    if axis == 0:
        pw_, ph_, pcx_, pcy_ = (v[:, None] for v in (pw, ph, pcx, pcy))
        v = pbv[:, None] if pbv.dim() > 1 else pbv
    else:
        pw_, ph_, pcx_, pcy_ = (v[None] for v in (pw, ph, pcx, pcy))
        v = pbv[None]
    d = tb * v
    cx = d[..., 0] * pw_ + pcx_
    cy = d[..., 1] * ph_ + pcy_
    w = torch.exp(d[..., 2]) * pw_
    h = torch.exp(d[..., 3]) * ph_
    return _wrap(torch.stack([cx - w / 2, cy - h / 2, cx + w / 2 - norm,
                              cy + h / 2 - norm], dim=-1))


def matrix_nms(bboxes, scores, score_threshold, post_threshold=0.0,
               nms_top_k=400, keep_top_k=200, use_gaussian=False,
               gaussian_sigma=2.0, background_label=0, normalized=True,
               return_index=False, return_rois_num=True, name=None):
    """Matrix NMS on the host: each box's score decays by its IoU with
    the higher-scored boxes of its class. Returns ``[M, 6]`` detections
    (class, score, box), with the kept indices and the per-image counts
    as asked, on the boxes' device."""
    bb, sc = _host(bboxes), _host(scores)
    outs, idxs, nums = [], [], []
    for n in range(bb.shape[0]):
        dets, det_idx = [], []
        for c in range(sc.shape[1]):
            if c == background_label:
                continue
            s = sc[n, c]
            keep = np.where(s > score_threshold)[0]
            if keep.size == 0:
                continue
            order = keep[np.argsort(-s[keep])][:nms_top_k]
            boxes_c = bb[n, order]
            s_c = s[order]
            x1 = np.maximum(boxes_c[:, None, 0], boxes_c[None, :, 0])
            y1 = np.maximum(boxes_c[:, None, 1], boxes_c[None, :, 1])
            x2 = np.minimum(boxes_c[:, None, 2], boxes_c[None, :, 2])
            y2 = np.minimum(boxes_c[:, None, 3], boxes_c[None, :, 3])
            inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
            area = ((boxes_c[:, 2] - boxes_c[:, 0])
                    * (boxes_c[:, 3] - boxes_c[:, 1]))
            iou = inter / np.maximum(area[:, None] + area[None] - inter,
                                     1e-10)
            iou = np.triu(iou, 1)
            iou_cmax = iou.max(0)
            if use_gaussian:
                decay = np.exp((iou_cmax ** 2 - iou ** 2) / gaussian_sigma)
                decay = decay.min(0)
            else:
                decay = ((1 - iou) / np.maximum(1 - iou_cmax[:, None],
                                                1e-10)).min(0)
            ds = s_c * decay
            for k in np.where(ds > post_threshold)[0]:
                dets.append([c, ds[k], *boxes_c[k]])
                det_idx.append(order[k])
        if dets:
            dets = np.asarray(dets, np.float32)
            order = np.argsort(-dets[:, 1])[:keep_top_k]
            dets = dets[order]
            det_idx = np.asarray(det_idx)[order]
        else:
            dets = np.zeros((0, 6), np.float32)
            det_idx = np.zeros((0,), np.int64)
        outs.append(dets)
        idxs.append(det_idx + n * bb.shape[1])
        nums.append(len(dets))
    dev = _device_of(bboxes)
    out = _on(np.concatenate(outs, 0) if outs
              else np.zeros((0, 6), np.float32), dev)
    res = [out]
    if return_index:
        res.append(_on(np.concatenate(idxs).astype(np.int64), dev))
    if return_rois_num:
        res.append(_on(np.asarray(nums, np.int32), dev))
    return tuple(res) if len(res) > 1 else out


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False,
                             rois_num=None, name=None):
    """Assign RoIs to FPN levels by scale, ``floor(refer_level +
    log2(sqrt(area) / refer_scale))`` clipped to the levels, on the host.
    Returns (the RoIs of each level, the restore index ``[K, 1]``, each
    level's count when ``rois_num`` is given), on the RoIs' device."""
    rois = _host(fpn_rois)
    dev = _device_of(fpn_rois)
    off = 1.0 if pixel_offset else 0.0
    w = rois[:, 2] - rois[:, 0] + off
    h = rois[:, 3] - rois[:, 1] + off
    scale = np.sqrt(np.maximum(w * h, 1e-10))
    lvl = np.floor(refer_level + np.log2(scale / refer_scale + 1e-8))
    lvl = np.clip(lvl, min_level, max_level).astype(np.int64)
    outs, restore, nums = [], [], []
    for level in range(min_level, max_level + 1):
        idx = np.where(lvl == level)[0]
        outs.append(_on(rois[idx], dev))
        restore.append(idx)
        nums.append(_on(np.asarray([len(idx)], np.int32), dev))
    restore_all = np.concatenate(restore) if restore else np.zeros(0, int)
    order = np.empty_like(restore_all)
    order[restore_all] = np.arange(len(restore_all))
    return (outs, _on(order.reshape(-1, 1).astype(np.int32), dev),
            nums if rois_num is not None else None)


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=False, return_rois_num=False,
                       name=None):
    """RPN proposals on the host, per image: the ``pre_nms_top_n`` best
    anchors decoded by their deltas, clipped to the image, the small
    ones dropped, then NMS to ``post_nms_top_n``. Returns (RoIs, scores
    [, per-image counts]) on the scores' device."""
    sc, bd = _host(scores), _host(bbox_deltas)        # [N, A, H, W], 4A
    an = _host(anchors).reshape(-1, 4)
    va = _host(variances).reshape(-1, 4)
    im = _host(img_size)
    off = 1.0 if pixel_offset else 0.0
    all_rois, all_scores, nums = [], [], []
    for n in range(sc.shape[0]):
        s = sc[n].transpose(1, 2, 0).reshape(-1)
        d = bd[n].reshape(-1, 4, sc.shape[2], sc.shape[3]) \
            .transpose(2, 3, 0, 1).reshape(-1, 4)
        order = np.argsort(-s)[:pre_nms_top_n]
        s, d, a, v = s[order], d[order], an[order], va[order]
        aw = a[:, 2] - a[:, 0] + off
        ah = a[:, 3] - a[:, 1] + off
        acx = a[:, 0] + aw / 2
        acy = a[:, 1] + ah / 2
        cx = v[:, 0] * d[:, 0] * aw + acx
        cy = v[:, 1] * d[:, 1] * ah + acy
        w = np.exp(np.minimum(v[:, 2] * d[:, 2], 10.0)) * aw
        h = np.exp(np.minimum(v[:, 3] * d[:, 3], 10.0)) * ah
        boxes = np.stack([cx - w / 2, cy - h / 2,
                          cx + w / 2 - off, cy + h / 2 - off], axis=1)
        H, W = im[n][0], im[n][1]
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, W - off)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, H - off)
        keep = ((boxes[:, 2] - boxes[:, 0] + off >= min_size)
                & (boxes[:, 3] - boxes[:, 1] + off >= min_size))
        boxes, s = boxes[keep], s[keep]
        sel = []
        order2 = np.argsort(-s)
        while order2.size and len(sel) < post_nms_top_n:
            i = order2[0]
            sel.append(i)
            if order2.size == 1:
                break
            rest = order2[1:]
            xx1 = np.maximum(boxes[i, 0], boxes[rest, 0])
            yy1 = np.maximum(boxes[i, 1], boxes[rest, 1])
            xx2 = np.minimum(boxes[i, 2], boxes[rest, 2])
            yy2 = np.minimum(boxes[i, 3], boxes[rest, 3])
            inter = (np.clip(xx2 - xx1 + off, 0, None)
                     * np.clip(yy2 - yy1 + off, 0, None))
            ai = ((boxes[i, 2] - boxes[i, 0] + off)
                  * (boxes[i, 3] - boxes[i, 1] + off))
            ar = ((boxes[rest, 2] - boxes[rest, 0] + off)
                  * (boxes[rest, 3] - boxes[rest, 1] + off))
            iou = inter / np.maximum(ai + ar - inter, 1e-10)
            order2 = rest[iou <= nms_thresh]
        all_rois.append(boxes[sel])
        all_scores.append(s[sel])
        nums.append(len(sel))
    dev = _device_of(scores)
    rois = _on(np.concatenate(all_rois, 0).astype(np.float32), dev)
    rs = _on(np.concatenate(all_scores, 0).astype(np.float32), dev)
    if return_rois_num:
        return rois, rs, _on(np.asarray(nums, np.int32), dev)
    return rois, rs


# ------------------------------------------------------------------ io ---

def read_file(filename, name=None):
    """A file's bytes as a uint8 tensor on the current device."""
    with open(filename, "rb") as f:
        data = f.read()
    return to_tensor(np.frombuffer(data, np.uint8).copy())


def decode_jpeg(x, mode="unchanged", name=None):
    """A JPEG byte tensor decoded to CHW uint8 on the host (PIL), on
    ``x``'s device; raises ``RuntimeError`` without PIL."""
    raw = bytes(_host(x).astype(np.uint8))
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("decode_jpeg needs PIL") from e
    img = Image.open(_io.BytesIO(raw))
    if mode == "gray":
        arr = np.asarray(img.convert("L"), np.uint8)[None]
    else:
        arr = np.asarray(img.convert("RGB"), np.uint8).transpose(2, 0, 1)
    return _on(arr, _device_of(x))
