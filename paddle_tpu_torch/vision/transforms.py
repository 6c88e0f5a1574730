"""Vision transforms of the port (counterpart of
``paddle_tpu/vision/transforms.py``, ref:
python/paddle/vision/transforms/transforms.py).

A copy of the reference, which never imported jax: numpy on the host
(feeds the DataLoader); HWC uint8 in, CHW float out via ToTensor. The
random transforms draw from Python's ``random``, as the reference's do, so
a seeded run gets the same draws from both packages.
"""
from __future__ import annotations

import math
import numbers
import random

import numpy as np

__all__ = ["Compose", "ToTensor", "Resize", "RandomHorizontalFlip",
           "RandomVerticalFlip", "Normalize", "Transpose", "CenterCrop",
           "RandomCrop", "RandomResizedCrop", "Pad", "BrightnessTransform",
           "ContrastTransform", "SaturationTransform", "HueTransform",
           "ColorJitter", "to_tensor", "normalize", "resize",
           "hflip", "vflip", "center_crop", "crop", "pad",
           "erase", "affine", "perspective"]


def _size2(size):
    if isinstance(size, numbers.Number):
        return int(size), int(size)
    return int(size[0]), int(size[1])


def resize(img, size, interpolation="bilinear"):
    h, w = img.shape[:2]
    if isinstance(size, int):
        if h < w:
            oh, ow = size, int(size * w / h)
        else:
            oh, ow = int(size * h / w), size
    else:
        oh, ow = _size2(size)
    ys = (np.arange(oh) + 0.5) * h / oh - 0.5
    xs = (np.arange(ow) + 0.5) * w / ow - 0.5
    if interpolation == "nearest":
        yi = np.clip(np.round(ys).astype(int), 0, h - 1)
        xi = np.clip(np.round(xs).astype(int), 0, w - 1)
        return img[yi][:, xi]
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None]
    wx = np.clip(xs - x0, 0, 1)[None, :]
    im = img.astype(np.float32)
    if im.ndim == 2:
        im = im[..., None]
        squeeze = True
    else:
        squeeze = False
    top = im[y0][:, x0] * (1 - wx[..., None]) + im[y0][:, x1] * wx[..., None]
    bot = im[y1][:, x0] * (1 - wx[..., None]) + im[y1][:, x1] * wx[..., None]
    out = top * (1 - wy[..., None]) + bot * wy[..., None]
    if squeeze:
        out = out[..., 0]
    if img.dtype == np.uint8:
        out = np.clip(out, 0, 255).astype(np.uint8)
    return out


def hflip(img):
    return img[:, ::-1].copy()


def vflip(img):
    return img[::-1].copy()


def crop(img, top, left, height, width):
    return img[top:top + height, left:left + width].copy()


def center_crop(img, output_size):
    th, tw = _size2(output_size)
    h, w = img.shape[:2]
    i = max((h - th) // 2, 0)
    j = max((w - tw) // 2, 0)
    return crop(img, i, j, th, tw)


def pad(img, padding, fill=0, padding_mode="constant"):
    if isinstance(padding, int):
        padding = (padding,) * 4
    l, t, r, b = padding if len(padding) == 4 else \
        (padding[0], padding[1], padding[0], padding[1])
    width = [(t, b), (l, r)] + [(0, 0)] * (img.ndim - 2)
    if padding_mode == "constant":
        return np.pad(img, width, mode="constant", constant_values=fill)
    mode = {"reflect": "reflect", "edge": "edge", "symmetric": "symmetric"}[padding_mode]
    return np.pad(img, width, mode=mode)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    mean = np.asarray(mean, dtype=np.float32)
    std = np.asarray(std, dtype=np.float32)
    if data_format == "CHW":
        return (img - mean[:, None, None]) / std[:, None, None]
    return (img - mean) / std


def to_tensor(pic, data_format="CHW"):
    arr = np.asarray(pic)
    if arr.ndim == 2:
        arr = arr[..., None]
    arr = arr.astype(np.float32)
    if np.asarray(pic).dtype == np.uint8:
        arr = arr / 255.0
    if data_format == "CHW":
        arr = arr.transpose(2, 0, 1)
    return arr


class BaseTransform:
    def __call__(self, img):
        return self._apply_image(img)


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        self.data_format = data_format

    def _apply_image(self, img):
        return to_tensor(img, self.data_format)


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        self.size = size
        self.interpolation = interpolation

    def _apply_image(self, img):
        return resize(img, self.size, self.interpolation)


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return hflip(img)
        return img


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return vflip(img)
        return img


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False,
                 keys=None):
        if isinstance(mean, numbers.Number):
            mean = [mean] * 3
        if isinstance(std, numbers.Number):
            std = [std] * 3
        self.mean, self.std = mean, std
        self.data_format = data_format

    def _apply_image(self, img):
        return normalize(img, self.mean, self.std, self.data_format)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        self.order = order

    def _apply_image(self, img):
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[..., None]
        return arr.transpose(self.order)


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        self.size = size

    def _apply_image(self, img):
        return center_crop(img, self.size)


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None):
        self.size = _size2(size)
        self.padding = padding
        self.pad_if_needed = pad_if_needed
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        if self.padding is not None:
            img = pad(img, self.padding, self.fill, self.padding_mode)
        th, tw = self.size
        h, w = img.shape[:2]
        if self.pad_if_needed and (h < th or w < tw):
            img = pad(img, (0, max(th - h, 0), 0, max(tw - w, 0)), self.fill,
                      self.padding_mode)
            h, w = img.shape[:2]
        i = random.randint(0, max(h - th, 0))
        j = random.randint(0, max(w - tw, 0))
        return crop(img, i, j, th, tw)


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None):
        self.size = _size2(size)
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _apply_image(self, img):
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target = random.uniform(*self.scale) * area
            ar = np.exp(random.uniform(np.log(self.ratio[0]),
                                       np.log(self.ratio[1])))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                i = random.randint(0, h - ch)
                j = random.randint(0, w - cw)
                return resize(crop(img, i, j, ch, cw), self.size,
                              self.interpolation)
        return resize(center_crop(img, min(h, w)), self.size,
                      self.interpolation)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        self.padding = padding
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        return pad(img, self.padding, self.fill, self.padding_mode)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_brightness(img, f)


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_contrast(img, f)


# ---------------------------------------------------------------------------
# round-2 long-tail transforms (ref: python/paddle/vision/transforms/
# transforms.py + functional.py). Host-side numpy like the rest of this
# module — transforms run in the input pipeline, not on the TPU.
# ---------------------------------------------------------------------------
def adjust_brightness(img, brightness_factor):
    """ref: F.adjust_brightness."""
    out = np.asarray(img).astype(np.float32) * float(brightness_factor)
    a = np.asarray(img)
    return np.clip(out, 0, 255).astype(a.dtype) if a.dtype == np.uint8 \
        else out


def adjust_contrast(img, contrast_factor):
    """ref: F.adjust_contrast."""
    a = np.asarray(img)
    mean = a.astype(np.float32).mean()
    out = (a.astype(np.float32) - mean) * float(contrast_factor) + mean
    return np.clip(out, 0, 255).astype(a.dtype) if a.dtype == np.uint8 \
        else out


def adjust_hue(img, hue_factor):
    """ref: F.adjust_hue — hue rotation via HSV round trip."""
    assert -0.5 <= hue_factor <= 0.5
    a = np.asarray(img).astype(np.float32)
    scale = 255.0 if np.asarray(img).dtype == np.uint8 else 1.0
    rgb = a / scale if scale != 1.0 else a
    # rgb<->hsv (vectorized, channels-last)
    maxc = rgb.max(-1)
    minc = rgb.min(-1)
    v = maxc
    d = maxc - minc
    s = np.where(maxc > 0, d / np.maximum(maxc, 1e-12), 0.0)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    dd = np.maximum(d, 1e-12)
    h = np.where(maxc == r, ((g - b) / dd) % 6,
                 np.where(maxc == g, (b - r) / dd + 2, (r - g) / dd + 4))
    h = np.where(d == 0, 0.0, h) / 6.0
    h = (h + hue_factor) % 1.0
    i = np.floor(h * 6).astype(int)
    f = h * 6 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = (i % 6)[..., None]  # broadcast against the stacked channel dim
    out = np.select(
        [i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
        [np.stack([v, t, p], -1), np.stack([q, v, p], -1),
         np.stack([p, v, t], -1), np.stack([p, q, v], -1),
         np.stack([t, p, v], -1), np.stack([v, p, q], -1)])
    out = out * scale if scale != 1.0 else out
    adt = np.asarray(img).dtype
    return np.clip(out, 0, 255).astype(adt) if adt == np.uint8 else out


def to_grayscale(img, num_output_channels=1):
    """ref: F.to_grayscale (ITU-R 601-2 luma)."""
    a = np.asarray(img).astype(np.float32)
    gray = a[..., 0] * 0.299 + a[..., 1] * 0.587 + a[..., 2] * 0.114
    out = np.repeat(gray[..., None], num_output_channels, -1)
    adt = np.asarray(img).dtype
    return np.clip(out, 0, 255).astype(adt) if adt == np.uint8 else out


def erase(img, i, j, h, w, v, inplace=False):
    """ref: paddle.vision.transforms.erase — set the [i:i+h, j:j+w]
    rectangle to value `v` (scalar or broadcastable array)."""
    a = np.asarray(img)
    if not inplace:
        a = a.copy()
    vv = np.asarray(v)
    a[i:i + h, j:j + w] = vv.astype(a.dtype) if vv.dtype != a.dtype \
        else vv
    return a


def affine(img, angle, translate=(0, 0), scale=1.0, shear=(0.0, 0.0),
           interpolation="nearest", fill=0, center=None):
    """ref: paddle.vision.transforms.affine — deterministic affine
    resample: rotation (degrees) + translation (px) + scale + shear
    (degrees, x then optional y), about `center` (default image
    center). The inverse-map core shared with RandomAffine."""
    a = np.asarray(img)
    h, w = a.shape[:2]
    if isinstance(shear, (int, float)):
        shear = (shear, 0.0)
    shx, shy = (tuple(shear) + (0.0,))[:2]
    tx, ty = translate
    cy, cx = ((h - 1) / 2.0, (w - 1) / 2.0) if center is None \
        else (center[1], center[0])
    ang, shx, shy = (math.radians(angle), math.radians(shx),
                     math.radians(shy))
    cos, sin = math.cos(ang), math.sin(ang)
    S = np.array([[1.0, math.tan(shx)], [math.tan(shy), 1.0]])
    R = np.array([[cos, -sin], [sin, cos]])
    M = (R @ S) * scale
    Minv = np.linalg.inv(M)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    dx = xx - cx - tx
    dy = yy - cy - ty
    xs = Minv[0, 0] * dx + Minv[0, 1] * dy + cx
    ys = Minv[1, 0] * dx + Minv[1, 1] * dy + cy
    return _inverse_map_sample(a, xs, ys, interpolation, fill)


def _homography(src_pts, dst_pts):
    A = []
    for (x, y), (u, v) in zip(src_pts, dst_pts):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y])
    A = np.asarray(A, np.float64)
    b = np.asarray(dst_pts, np.float64).reshape(-1)
    h8 = np.linalg.solve(A, b)
    return np.append(h8, 1.0).reshape(3, 3)


def perspective(img, startpoints, endpoints, interpolation="nearest",
                fill=0):
    """ref: paddle.vision.transforms.perspective — projective warp
    taking the 4 startpoints to the 4 endpoints (inverse-map
    resample)."""
    a = np.asarray(img)
    h, w = a.shape[:2]
    M = _homography(endpoints, startpoints)   # output pixel -> source
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ones = np.ones_like(xx)
    pts = np.stack([xx, yy, ones], 0).reshape(3, -1)
    mapped = M @ pts
    xs = (mapped[0] / mapped[2]).reshape(h, w)
    ys = (mapped[1] / mapped[2]).reshape(h, w)
    return _inverse_map_sample(a, xs, ys, interpolation, fill)


def _inverse_map_sample(a, xs, ys, interpolation="nearest", fill=0):
    """Sample source image `a` at float positions (ys, xs) (one per output
    pixel); out-of-bounds positions take `fill`. Shared by rotate /
    RandomAffine / RandomPerspective."""
    h, w = a.shape[:2]

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yic = np.clip(yi, 0, h - 1)
        xic = np.clip(xi, 0, w - 1)
        px = a[yic, xic].astype(np.float32)
        mask = valid[..., None] if a.ndim == 3 else valid
        return np.where(mask, px, float(fill))

    if interpolation == "bilinear":
        x0 = np.floor(xs).astype(int)
        y0 = np.floor(ys).astype(int)
        wx = (xs - x0)
        wy = (ys - y0)
        if a.ndim == 3:
            wx = wx[..., None]
            wy = wy[..., None]
        out = (gather(y0, x0) * (1 - wy) * (1 - wx)
               + gather(y0, x0 + 1) * (1 - wy) * wx
               + gather(y0 + 1, x0) * wy * (1 - wx)
               + gather(y0 + 1, x0 + 1) * wy * wx)
    else:
        out = gather(np.round(ys).astype(int), np.round(xs).astype(int))
    return np.clip(out, 0, 255).astype(a.dtype) if a.dtype == np.uint8 \
        else out.astype(a.dtype)


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    """ref: F.rotate — inverse-map nearest/bilinear resample (numpy).
    expand=True enlarges the canvas to contain the whole rotated image."""
    a = np.asarray(img)
    h, w = a.shape[:2]
    cy, cx = ((h - 1) / 2.0, (w - 1) / 2.0) if center is None \
        else (center[1], center[0])
    th = np.deg2rad(angle)
    cos, sin = np.cos(th), np.sin(th)
    if expand:
        oh = int(math.ceil(abs(h * cos) + abs(w * sin)))
        ow = int(math.ceil(abs(w * cos) + abs(h * sin)))
        ocy, ocx = (oh - 1) / 2.0, (ow - 1) / 2.0
    else:
        oh, ow = h, w
        ocy, ocx = cy, cx
    yy, xx = np.meshgrid(np.arange(oh), np.arange(ow), indexing="ij")
    xs = cos * (xx - ocx) + sin * (yy - ocy) + cx
    ys = -sin * (xx - ocx) + cos * (yy - ocy) + cy
    return _inverse_map_sample(a, xs, ys, interpolation, fill)


class SaturationTransform(BaseTransform):
    """ref: transforms.SaturationTransform."""

    def __init__(self, value, keys=None):
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = random.uniform(max(0, 1 - self.value), 1 + self.value)
        gray = to_grayscale(img, 3).astype(np.float32)
        out = img.astype(np.float32) * f + gray * (1 - f)
        return np.clip(out, 0, 255).astype(img.dtype) \
            if img.dtype == np.uint8 else out


class HueTransform(BaseTransform):
    """ref: transforms.HueTransform."""

    def __init__(self, value, keys=None):
        assert 0 <= value <= 0.5
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        return adjust_hue(img, random.uniform(-self.value, self.value))


class ColorJitter(BaseTransform):
    """ref: transforms.ColorJitter — randomly jitter brightness, contrast,
    saturation and hue, applying the four constituent transforms in a
    random order per call (matches the reference's _get_param shuffle)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        self.brightness = float(brightness)
        self.contrast = float(contrast)
        self.saturation = float(saturation)
        self.hue = float(hue)
        self._parts = [BrightnessTransform(self.brightness),
                       ContrastTransform(self.contrast),
                       SaturationTransform(self.saturation),
                       HueTransform(self.hue)]

    def _apply_image(self, img):
        order = list(range(4))
        random.shuffle(order)
        for i in order:
            img = self._parts[i]._apply_image(np.asarray(img))
        return img


class Grayscale(BaseTransform):
    """ref: transforms.Grayscale."""

    def __init__(self, num_output_channels=1, keys=None):
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return to_grayscale(img, self.num_output_channels)


class RandomRotation(BaseTransform):
    """ref: transforms.RandomRotation."""

    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        if isinstance(degrees, (int, float)):
            degrees = (-abs(degrees), abs(degrees))
        self.degrees = degrees
        self.interpolation = interpolation
        self.expand = expand
        self.center = center
        self.fill = fill

    def _apply_image(self, img):
        angle = random.uniform(*self.degrees)
        return rotate(img, angle, self.interpolation, self.expand,
                      self.center, self.fill)


class RandomErasing(BaseTransform):
    """ref: transforms.RandomErasing — erase a random rectangle.
    value='random' fills with gaussian noise like the reference; the
    `inplace` flag is accepted (this numpy pipeline always copies)."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, keys=None):
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value
        self.inplace = inplace

    def _apply_image(self, img):
        if random.random() > self.prob:
            return img
        a = np.array(img, copy=True)
        h, w = a.shape[:2]
        area = h * w
        for _ in range(10):
            target = random.uniform(*self.scale) * area
            ar = math.exp(random.uniform(math.log(self.ratio[0]),
                                         math.log(self.ratio[1])))
            eh = int(round(math.sqrt(target * ar)))
            ew = int(round(math.sqrt(target / ar)))
            if eh < h and ew < w:
                top = random.randint(0, h - eh)
                left = random.randint(0, w - ew)
                patch_shape = (eh, ew) + a.shape[2:]
                if isinstance(self.value, str):  # 'random'
                    noise = np.random.standard_normal(patch_shape)
                    if a.dtype == np.uint8:
                        noise = np.clip(noise * 255, 0, 255)
                    return erase(a, top, left, eh, ew,
                                 noise.astype(a.dtype), inplace=True)
                return erase(a, top, left, eh, ew, self.value,
                             inplace=True)
        return a


class RandomAffine(BaseTransform):
    """ref: transforms.RandomAffine — one inverse-map affine resample
    covering rotation + translation + scale + shear (2- or 4-element
    shear ranges like the reference)."""

    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None, keys=None):
        if isinstance(degrees, (int, float)):
            degrees = (-abs(degrees), abs(degrees))
        self.degrees = degrees
        self.translate = translate
        self.scale_range = scale
        if shear is not None and isinstance(shear, (int, float)):
            shear = (-abs(shear), abs(shear))
        self.shear = None if shear is None else list(shear)
        self.interpolation = interpolation
        self.fill = fill
        self.center = center

    def _apply_image(self, img):
        a = np.asarray(img)
        h, w = a.shape[:2]
        angle = random.uniform(*self.degrees)
        s = (random.uniform(*self.scale_range)
             if self.scale_range is not None else 1.0)
        shx = shy = 0.0
        if self.shear is not None:
            shx = random.uniform(self.shear[0], self.shear[1])
            if len(self.shear) == 4:
                shy = random.uniform(self.shear[2], self.shear[3])
        tx = (random.uniform(-self.translate[0], self.translate[0]) * w
              if self.translate is not None else 0.0)
        ty = (random.uniform(-self.translate[1], self.translate[1]) * h
              if self.translate is not None else 0.0)
        return affine(a, angle, (tx, ty), s, (shx, shy),
                      interpolation=self.interpolation, fill=self.fill,
                      center=self.center)


class RandomPerspective(BaseTransform):
    """ref: transforms.RandomPerspective — random 4-point projective warp
    (inverse-map nearest resample)."""

    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="nearest", fill=0, keys=None):
        self.prob = prob
        self.distortion_scale = distortion_scale
        self.interpolation = interpolation
        self.fill = fill

    def _apply_image(self, img):
        if random.random() > self.prob:
            return img
        a = np.asarray(img)
        h, w = a.shape[:2]
        d = self.distortion_scale
        dx = lambda: random.uniform(0, d * w / 2)  # noqa: E731
        dy = lambda: random.uniform(0, d * h / 2)  # noqa: E731
        endpoints = [(dx(), dy()), (w - 1 - dx(), dy()),
                     (w - 1 - dx(), h - 1 - dy()), (dx(), h - 1 - dy())]
        startpoints = [(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)]
        return perspective(a, startpoints, endpoints,
                           self.interpolation, self.fill)


class ToPILImage(BaseTransform):
    """ref: transforms.ToPILImage."""

    def __init__(self, mode=None, keys=None):
        self.mode = mode

    def _apply_image(self, img):
        from PIL import Image
        a = np.asarray(img)
        if a.dtype != np.uint8:
            a = np.clip(a * 255 if a.max() <= 1.0 else a, 0,
                        255).astype(np.uint8)
        if a.ndim == 3 and a.shape[0] in (1, 3) and a.shape[-1] not in (1, 3):
            a = np.transpose(a, (1, 2, 0))  # CHW -> HWC
        if a.ndim == 3 and a.shape[-1] == 1:
            a = a[..., 0]
        return Image.fromarray(a, mode=self.mode)


AdjustBrightness = BrightnessTransform
AdjustContrast = ContrastTransform
