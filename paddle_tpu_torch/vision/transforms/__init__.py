"""Vision transforms over numpy HWC/CHW arrays (counterpart of
``paddle_tpu/vision/transforms/__init__.py``; reference:
``python/paddle/vision/transforms/``).

They run on the host in numpy, in the DataLoader's workers or its
prefetch thread, and draw from numpy's global generator as the JAX
package's do. ``Resize`` is the JAX package's ``jax.image.resize(...,
method="linear")`` rewritten in numpy (:func:`_resize_linear`): a
triangle kernel, widened by the scale when an axis shrinks (its
default antialiasing), each output's weights normalised to sum to 1.
"""
from __future__ import annotations

import numbers

import numpy as np


def _linear_weights(in_size: int, out_size: int) -> np.ndarray:
    """``[in_size, out_size]`` float32 weights of one axis: the JAX
    package's ``compute_weight_mat`` for the triangle kernel with
    antialiasing, scale ``out / in`` and no translation."""
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
              * inv_scale - np.float32(0.5))
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]
               ) / kernel_scale
    w = np.maximum(np.float32(0), np.float32(1) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    eps = np.float32(1000.0 * np.finfo(np.float32).eps)
    w = np.where(np.abs(total) > eps,
                 w / np.where(total != 0, total, np.float32(1)),
                 np.float32(0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, np.float32(0)).astype(np.float32)


def _resize_linear(arr: np.ndarray, out_shape) -> np.ndarray:
    """``arr`` (float32) resampled to ``out_shape`` axis by axis; an
    axis whose size stays is left as it is."""
    out = arr
    for axis, (n_in, n_out) in enumerate(zip(arr.shape, out_shape)):
        if n_in == n_out:
            continue
        w = _linear_weights(n_in, n_out)
        out = np.moveaxis(np.tensordot(out, w, axes=([axis], [0])), -1, axis)
    return out.astype(np.float32)


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class BaseTransform:
    def __call__(self, x):
        raise NotImplementedError


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        self.data_format = data_format

    def __call__(self, img):
        arr = np.asarray(img)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[None]
        elif arr.ndim == 3 and self.data_format == "CHW" and arr.shape[-1] in (1, 3, 4):
            arr = arr.transpose(2, 0, 1)
        return arr.astype(np.float32)


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False, keys=None):
        if isinstance(mean, numbers.Number):
            mean = [mean]
        if isinstance(std, numbers.Number):
            std = [std]
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def __call__(self, img):
        arr = np.asarray(img, np.float32)
        if self.data_format == "CHW":
            m = self.mean.reshape(-1, 1, 1)
            s = self.std.reshape(-1, 1, 1)
        else:
            m, s = self.mean, self.std
        return (arr - m) / s


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        arr = np.asarray(img, np.float32)
        chw = arr.ndim == 3 and arr.shape[0] in (1, 3, 4)
        if chw:
            out_shape = (arr.shape[0],) + self.size
        else:
            out_shape = self.size + ((arr.shape[-1],) if arr.ndim == 3 else ())
        return _resize_linear(arr, out_shape)


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            return np.ascontiguousarray(np.flip(img, axis=-1))
        return img


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, keys=None):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def __call__(self, img):
        arr = np.asarray(img)
        h, w = arr.shape[-2], arr.shape[-1]
        th, tw = self.size
        if self.padding:
            p = self.padding
            pad = [(0, 0)] * (arr.ndim - 2) + [(p, p), (p, p)]
            arr = np.pad(arr, pad)
            h, w = arr.shape[-2], arr.shape[-1]
        i = np.random.randint(0, h - th + 1)
        j = np.random.randint(0, w - tw + 1)
        return arr[..., i:i + th, j:j + tw]


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        arr = np.asarray(img)
        h, w = arr.shape[-2], arr.shape[-1]
        th, tw = self.size
        i, j = (h - th) // 2, (w - tw) // 2
        return arr[..., i:i + th, j:j + tw]


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            return np.ascontiguousarray(np.flip(img, axis=-2))
        return img


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        if isinstance(padding, int):
            padding = (padding, padding, padding, padding)  # l, t, r, b
        elif len(padding) == 2:
            padding = (padding[0], padding[1], padding[0], padding[1])
        self.padding = padding
        self.fill = fill
        self.mode = padding_mode

    def __call__(self, img):
        arr = np.asarray(img)
        l, t, r, b = self.padding
        pad = [(0, 0)] * (arr.ndim - 2) + [(t, b), (l, r)]
        if self.mode == "constant":
            return np.pad(arr, pad, constant_values=self.fill)
        return np.pad(arr, pad, mode=self.mode)


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        self.num_output_channels = num_output_channels

    def __call__(self, img):
        arr = np.asarray(img, np.float32)
        if arr.ndim == 3 and arr.shape[0] == 3:  # CHW
            g = (0.299 * arr[0] + 0.587 * arr[1] + 0.114 * arr[2])[None]
        elif arr.ndim == 3 and arr.shape[-1] == 3:  # HWC
            g = (arr @ np.array([0.299, 0.587, 0.114], np.float32))[..., None]
        else:
            g = arr
        if self.num_output_channels == 3:
            g = np.repeat(g, 3, axis=0 if g.ndim == 3 and g.shape[0] == 1 else -1)
        return g


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        self.order = tuple(order)

    def __call__(self, img):
        return np.asarray(img).transpose(self.order)


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3), keys=None):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio

    def __call__(self, img):
        arr = np.asarray(img)
        h, w = arr.shape[-2], arr.shape[-1]
        area = h * w
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            ar = np.exp(np.random.uniform(*np.log(self.ratio)))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                i = np.random.randint(0, h - ch + 1)
                j = np.random.randint(0, w - cw + 1)
                crop = arr[..., i:i + ch, j:j + cw]
                return Resize(self.size)(crop)
        return Resize(self.size)(CenterCrop(min(h, w))(arr))


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = value

    def __call__(self, img):
        f = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        return np.asarray(img, np.float32) * f


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = value

    def __call__(self, img):
        arr = np.asarray(img, np.float32)
        f = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        return (arr - arr.mean()) * f + arr.mean()


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = value

    def __call__(self, img):
        arr = np.asarray(img, np.float32)
        f = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        gray = Grayscale(3)(arr)
        return arr * f + gray * (1 - f)


class ColorJitter(BaseTransform):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0, keys=None):
        self.ts = []
        if brightness:
            self.ts.append(BrightnessTransform(brightness))
        if contrast:
            self.ts.append(ContrastTransform(contrast))
        if saturation:
            self.ts.append(SaturationTransform(saturation))

    def __call__(self, img):
        order = np.random.permutation(len(self.ts)) if self.ts else []
        for i in order:
            img = self.ts[i](img)
        return img


def to_tensor(img, data_format="CHW"):
    return ToTensor(data_format)(img)


def normalize(img, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size)(img)


# -------------------------------------------------------- functional tail --
# Reference ``vision/transforms/functional.py`` over numpy HWC arrays.


def hflip(img):
    return np.ascontiguousarray(img[:, ::-1])


def vflip(img):
    return np.ascontiguousarray(img[::-1])


def crop(img, top, left, height, width):
    return np.ascontiguousarray(img[top:top + height, left:left + width])


def center_crop(img, output_size):
    if isinstance(output_size, numbers.Number):
        output_size = (int(output_size), int(output_size))
    h, w = img.shape[0], img.shape[1]
    th, tw = output_size
    return crop(img, (h - th) // 2, (w - tw) // 2, th, tw)


def pad(img, padding, fill=0, padding_mode="constant"):
    if isinstance(padding, numbers.Number):
        pl = pr = pt = pb = int(padding)
    elif len(padding) == 2:
        pl = pr = int(padding[0])
        pt = pb = int(padding[1])
    else:
        pl, pt, pr, pb = (int(v) for v in padding)
    mode = {"constant": "constant", "edge": "edge",
            "reflect": "reflect", "symmetric": "symmetric"}[padding_mode]
    widths = [(pt, pb), (pl, pr)] + [(0, 0)] * (img.ndim - 2)
    kw = {"constant_values": fill} if mode == "constant" else {}
    return np.pad(img, widths, mode=mode, **kw)


def erase(img, i, j, h, w, v, inplace=False):
    out = img if inplace else img.copy()
    out[i:i + h, j:j + w] = v
    return out


def to_grayscale(img, num_output_channels=1):
    g = (0.299 * img[..., 0] + 0.587 * img[..., 1]
         + 0.114 * img[..., 2])
    g = g.astype(img.dtype)
    return np.stack([g] * num_output_channels, axis=-1)


def adjust_brightness(img, brightness_factor):
    hi = 255 if np.issubdtype(img.dtype, np.integer) else 1.0
    return np.clip(img.astype(np.float32) * brightness_factor, 0,
                   hi).astype(img.dtype)


def adjust_contrast(img, contrast_factor):
    hi = 255 if np.issubdtype(img.dtype, np.integer) else 1.0
    mean = to_grayscale(img)[..., 0].mean()
    out = mean + contrast_factor * (img.astype(np.float32) - mean)
    return np.clip(out, 0, hi).astype(img.dtype)


def adjust_hue(img, hue_factor):
    """Shift hue by hue_factor (in [-0.5, 0.5]) via HSV roundtrip
    (reference ``functional_cv2.adjust_hue``)."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    is_int = np.issubdtype(img.dtype, np.integer)
    x = img.astype(np.float32) / (255.0 if is_int else 1.0)
    mx = x.max(-1)
    mn = x.min(-1)
    diff = mx - mn + 1e-12
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    h = np.where(mx == r, ((g - b) / diff) % 6,
                 np.where(mx == g, (b - r) / diff + 2,
                          (r - g) / diff + 4)) / 6.0
    s = np.where(mx > 0, diff / (mx + 1e-12), 0.0)
    v = mx
    h = (h + hue_factor) % 1.0
    c = v * s
    hp = h * 6.0
    xcomp = c * (1 - np.abs(hp % 2 - 1))
    z = np.zeros_like(c)
    idx = np.floor(hp).astype(np.int32) % 6
    rgbs = np.stack([
        np.stack([c, xcomp, z], -1), np.stack([xcomp, c, z], -1),
        np.stack([z, c, xcomp], -1), np.stack([z, xcomp, c], -1),
        np.stack([xcomp, z, c], -1), np.stack([c, z, xcomp], -1),
    ], 0)
    out = np.take_along_axis(
        rgbs, idx[None, ..., None], axis=0)[0] + (v - c)[..., None]
    out = out * (255.0 if is_int else 1.0)
    return np.clip(out, 0, 255 if is_int else 1.0).astype(img.dtype)


def _affine_grid_sample(img, matrix, fill=0):
    """Inverse-warp img by the 2x3 affine matrix (output->input coords)."""
    h, w = img.shape[0], img.shape[1]
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    xs = xx - cx
    ys = yy - cy
    sx = matrix[0, 0] * xs + matrix[0, 1] * ys + matrix[0, 2] + cx
    sy = matrix[1, 0] * xs + matrix[1, 1] * ys + matrix[1, 2] + cy
    x0 = np.round(sx).astype(np.int64)
    y0 = np.round(sy).astype(np.int64)
    valid = (x0 >= 0) & (x0 < w) & (y0 >= 0) & (y0 < h)
    out = np.full_like(img, fill)
    out[valid] = img[y0[valid], x0[valid]]
    return out


def affine(img, angle, translate, scale, shear, interpolation="nearest",
           fill=0, center=None):
    """Reference ``functional.affine``: rotate/translate/scale/shear about
    the center; nearest-neighbor resampling."""
    a = np.deg2rad(angle)
    sx, sy = (np.deg2rad(s) for s in (
        shear if isinstance(shear, (list, tuple)) else (shear, 0.0)))
    # forward matrix; invert for sampling
    m = np.array([
        [np.cos(a + sy) / np.cos(sy),
         -np.cos(a + sy) * np.tan(sx) / np.cos(sy) - np.sin(a), 0],
        [np.sin(a + sy) / np.cos(sy),
         -np.sin(a + sy) * np.tan(sx) / np.cos(sy) + np.cos(a), 0],
    ], np.float64) * scale
    full = np.eye(3)
    full[:2, :2] = m[:, :2]
    full[0, 2] = translate[0]
    full[1, 2] = translate[1]
    inv = np.linalg.inv(full)
    return _affine_grid_sample(img, inv[:2], fill=fill)


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    return affine(img, angle, (0, 0), 1.0, (0.0, 0.0), fill=fill)


def perspective(img, startpoints, endpoints, interpolation="nearest",
                fill=0):
    """Reference ``functional.perspective``: warp so endpoints map back to
    startpoints (solves the 8-dof homography)."""
    A = []
    bv = []
    for (x, y), (u, v) in zip(endpoints, startpoints):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        bv.append(u)
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        bv.append(v)
    coef = np.linalg.lstsq(np.asarray(A, np.float64),
                           np.asarray(bv, np.float64), rcond=None)[0]
    hmat = np.append(coef, 1.0).reshape(3, 3)
    h, w = img.shape[0], img.shape[1]
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    denom = hmat[2, 0] * xx + hmat[2, 1] * yy + hmat[2, 2]
    sx = (hmat[0, 0] * xx + hmat[0, 1] * yy + hmat[0, 2]) / denom
    sy = (hmat[1, 0] * xx + hmat[1, 1] * yy + hmat[1, 2]) / denom
    x0 = np.round(sx).astype(np.int64)
    y0 = np.round(sy).astype(np.int64)
    valid = (x0 >= 0) & (x0 < w) & (y0 >= 0) & (y0 < h)
    out = np.full_like(img, fill)
    out[valid] = img[y0[valid], x0[valid]]
    return out


# ---------------------------------------------------------- class tail ----


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = value

    def __call__(self, img):
        if self.value == 0:
            return img
        v = np.random.uniform(-self.value, self.value)
        return adjust_hue(img, v)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees
        self.fill = fill

    def __call__(self, img):
        angle = np.random.uniform(*self.degrees)
        return rotate(img, angle, fill=self.fill)


class RandomAffine(BaseTransform):
    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None, keys=None):
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees
        self.translate = translate
        self.scale = scale
        self.shear = shear
        self.fill = fill

    def __call__(self, img):
        h, w = img.shape[0], img.shape[1]
        angle = np.random.uniform(*self.degrees)
        tx = ty = 0.0
        if self.translate is not None:
            tx = np.random.uniform(-self.translate[0], self.translate[0]) * w
            ty = np.random.uniform(-self.translate[1], self.translate[1]) * h
        sc = np.random.uniform(*self.scale) if self.scale else 1.0
        sh = (np.random.uniform(-self.shear, self.shear)
              if isinstance(self.shear, numbers.Number) else 0.0)
        return affine(img, angle, (tx, ty), sc, (sh, 0.0), fill=self.fill)


class RandomPerspective(BaseTransform):
    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="nearest", fill=0, keys=None):
        self.prob = prob
        self.distortion_scale = distortion_scale
        self.fill = fill

    def __call__(self, img):
        if np.random.rand() >= self.prob:
            return img
        h, w = img.shape[0], img.shape[1]
        d = self.distortion_scale
        dx = int(d * w / 2)
        dy = int(d * h / 2)
        start = [(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)]
        end = [(np.random.randint(0, dx + 1), np.random.randint(0, dy + 1)),
               (w - 1 - np.random.randint(0, dx + 1),
                np.random.randint(0, dy + 1)),
               (w - 1 - np.random.randint(0, dx + 1),
                h - 1 - np.random.randint(0, dy + 1)),
               (np.random.randint(0, dx + 1),
                h - 1 - np.random.randint(0, dy + 1))]
        return perspective(img, start, end, fill=self.fill)


class RandomErasing(BaseTransform):
    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, keys=None):
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value

    def __call__(self, img):
        if np.random.rand() >= self.prob:
            return img
        h, w = img.shape[0], img.shape[1]
        area = h * w
        for _ in range(10):
            target = np.random.uniform(*self.scale) * area
            ar = np.random.uniform(*self.ratio)
            eh = int(round(np.sqrt(target * ar)))
            ew = int(round(np.sqrt(target / ar)))
            if eh < h and ew < w:
                i = np.random.randint(0, h - eh + 1)
                j = np.random.randint(0, w - ew + 1)
                return erase(img, i, j, eh, ew, self.value)
        return img
