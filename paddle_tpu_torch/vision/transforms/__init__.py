"""Vision transforms: the counterpart of
``paddle_tpu/vision/transforms/__init__.py``, all of it — ``Compose``,
``ToTensor``, ``Normalize``, ``Resize``, the crops and flips, the color,
affine, perspective and erasing families, and the functional forms
(``to_tensor``, ``normalize``, ``resize``, ``hflip``, ``adjust_*``,
``affine``, ``rotate``, ``perspective``, ``erase`` ...).

A copy of the JAX module: numpy on the host (CHW float or HWC uint8
images, returned in the caller's layout), the random transforms drawing
from Python's ``random`` as the JAX module does, so the same
``random.seed`` gives the same outputs in both packages. Batches reach
the card through ``io.DataLoader``.
"""

from __future__ import annotations

import numbers
import random

import numpy as np


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class BaseTransform:
    def __init__(self, keys=None):
        self.keys = keys

    def __call__(self, img):
        return self._apply_image(img)


def _chw(img):
    if img.ndim == 2:
        return img[None]
    if img.shape[0] in (1, 3, 4):
        return img
    return np.transpose(img, (2, 0, 1))


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        super().__init__(keys)
        self.data_format = data_format

    def _apply_image(self, img):
        img = np.asarray(img)
        if img.dtype == np.uint8:
            img = img.astype("float32") / 255.0
        img = img.astype("float32")
        if self.data_format == "CHW":
            img = _chw(img)
        return img


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False,
                 keys=None):
        super().__init__(keys)
        self.mean = np.asarray(mean, "float32")
        self.std = np.asarray(std, "float32")
        self.data_format = data_format

    def _apply_image(self, img):
        img = np.asarray(img, "float32")
        if self.data_format == "CHW":
            m = self.mean.reshape(-1, 1, 1)
            s = self.std.reshape(-1, 1, 1)
        else:
            m, s = self.mean, self.std
        return (img - m) / s


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        super().__init__(keys)
        # int size = scale the smaller edge (paddle semantics); tuple = exact
        self.size = size

    def _apply_image(self, img):
        img = _chw(np.asarray(img, "float32"))
        c, h, w = img.shape
        if isinstance(self.size, (list, tuple)):
            th, tw = self.size
        else:
            short = self.size
            if h <= w:
                th, tw = short, max(1, int(round(w * short / h)))
            else:
                th, tw = max(1, int(round(h * short / w))), short
        ys = (np.arange(th) + 0.5) * h / th - 0.5
        xs = (np.arange(tw) + 0.5) * w / tw - 0.5
        ys = np.clip(ys, 0, h - 1)
        xs = np.clip(xs, 0, w - 1)
        y0 = np.floor(ys).astype(int)
        x0 = np.floor(xs).astype(int)
        y1 = np.minimum(y0 + 1, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        wy = (ys - y0)[None, :, None]
        wx = (xs - x0)[None, None, :]
        out = (img[:, y0][:, :, x0] * (1 - wy) * (1 - wx)
               + img[:, y1][:, :, x0] * wy * (1 - wx)
               + img[:, y0][:, :, x1] * (1 - wy) * wx
               + img[:, y1][:, :, x1] * wy * wx)
        return out.astype("float32")


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None):
        super().__init__(keys)
        self.size = size if isinstance(size, (list, tuple)) else (size, size)
        self.padding = padding
        self.pad_if_needed = pad_if_needed
        self.fill = fill
        self.padding_mode = padding_mode

    def _pad(self, img, wpad, hpad):
        mode = {"constant": "constant", "edge": "edge",
                "reflect": "reflect", "symmetric": "symmetric"}[
            self.padding_mode]
        kw = {"constant_values": self.fill} if mode == "constant" else {}
        return np.pad(img, ((0, 0), hpad, wpad), mode=mode, **kw)

    def _apply_image(self, img):
        img = _chw(np.asarray(img))
        if self.padding:
            p = self.padding if isinstance(self.padding, (list, tuple)) \
                else [self.padding] * 4
            img = self._pad(img, (p[0], p[2]), (p[1], p[3]))
        th, tw = self.size
        c, h, w = img.shape
        if self.pad_if_needed and h < th:
            img = self._pad(img, (0, 0), (th - h, th - h))
        if self.pad_if_needed and w < tw:
            img = self._pad(img, (tw - w, tw - w), (0, 0))
        c, h, w = img.shape
        i = random.randint(0, h - th)
        j = random.randint(0, w - tw)
        return img[:, i:i + th, j:j + tw]


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        super().__init__(keys)
        self.size = size if isinstance(size, (list, tuple)) else (size, size)

    def _apply_image(self, img):
        img = _chw(np.asarray(img))
        c, h, w = img.shape
        th, tw = self.size
        if h < th or w < tw:
            raise ValueError(
                f"CenterCrop size ({th},{tw}) larger than image ({h},{w})")
        i = (h - th) // 2
        j = (w - tw) // 2
        return img[:, i:i + th, j:j + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return np.ascontiguousarray(_chw(np.asarray(img))[:, :, ::-1])
        return _chw(np.asarray(img))


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return np.ascontiguousarray(_chw(np.asarray(img))[:, ::-1])
        return _chw(np.asarray(img))


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = size if isinstance(size, (list, tuple)) else (size, size)
        self.scale = scale
        self.ratio = ratio
        self._resize = Resize(self.size, interpolation)

    def _apply_image(self, img):
        img = _chw(np.asarray(img))
        c, h, w = img.shape
        area = h * w
        for _ in range(10):
            target = random.uniform(*self.scale) * area
            ar = np.exp(random.uniform(np.log(self.ratio[0]),
                                       np.log(self.ratio[1])))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if cw <= w and ch <= h:
                i = random.randint(0, h - ch)
                j = random.randint(0, w - cw)
                return self._resize(img[:, i:i + ch, j:j + cw])
        return self._resize(img)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = order

    def _apply_image(self, img):
        return np.transpose(np.asarray(img), self.order)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        alpha = 1 + random.uniform(-self.value, self.value)
        return np.clip(np.asarray(img, "float32") * alpha, 0, None)


class ContrastTransform(BrightnessTransform):
    def _apply_image(self, img):
        img = np.asarray(img, "float32")
        alpha = 1 + random.uniform(-self.value, self.value)
        mean = img.mean()
        return np.clip(mean + (img - mean) * alpha, 0, None)


def to_tensor(img, data_format="CHW"):
    return ToTensor(data_format)(img)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)


def hflip(img):
    return np.ascontiguousarray(_chw(np.asarray(img))[:, :, ::-1])


def vflip(img):
    return np.ascontiguousarray(_chw(np.asarray(img))[:, ::-1])


# ---------------------------------------------------------------------------
# the color, affine, perspective and erasing families: host-side numpy;
# HWC uint8 or CHW float accepted like the rest
# ---------------------------------------------------------------------------

def _hwc(img):
    a = np.asarray(img)
    if a.ndim == 2:
        return a[:, :, None]
    if a.shape[0] in (1, 3, 4) and a.shape[-1] not in (1, 3, 4):
        return np.transpose(a, (1, 2, 0))
    return a


def _like(out, img):
    """Return in the caller's layout (CHW if input was CHW)."""
    a = np.asarray(img)
    if a.ndim == 3 and a.shape[0] in (1, 3, 4) and a.shape[-1] not in (1, 3, 4):
        return np.ascontiguousarray(np.transpose(out, (2, 0, 1)))
    return np.ascontiguousarray(out)


def adjust_brightness(img, brightness_factor):
    a = _hwc(img).astype(np.float32)
    out = np.clip(a * brightness_factor, 0,
                  255 if np.asarray(img).dtype == np.uint8 else None)
    return _like(out.astype(np.asarray(img).dtype), img)


def adjust_contrast(img, contrast_factor):
    a = _hwc(img).astype(np.float32)
    mean = a.mean(axis=(0, 1), keepdims=True).mean()
    out = np.clip((a - mean) * contrast_factor + mean, 0,
                  255 if np.asarray(img).dtype == np.uint8 else None)
    return _like(out.astype(np.asarray(img).dtype), img)


def _rgb_to_hsv(a):
    r, g, b = a[..., 0], a[..., 1], a[..., 2]
    mx = a.max(-1)
    mn = a.min(-1)
    diff = mx - mn + 1e-12
    h = np.where(mx == r, (g - b) / diff % 6,
                 np.where(mx == g, (b - r) / diff + 2, (r - g) / diff + 4))
    h = h / 6.0
    s = np.where(mx > 0, diff / (mx + 1e-12), 0.0)
    return np.stack([h, s, mx], -1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0] * 6.0, hsv[..., 1], hsv[..., 2]
    i = np.floor(h).astype(np.int32) % 6
    f = h - np.floor(h)
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    choices = np.stack([
        np.stack([v, t, p], -1), np.stack([q, v, p], -1),
        np.stack([p, v, t], -1), np.stack([p, q, v], -1),
        np.stack([t, p, v], -1), np.stack([v, p, q], -1)], 0)
    return np.take_along_axis(choices, i[None, ..., None], 0)[0]


def adjust_hue(img, hue_factor):
    assert -0.5 <= hue_factor <= 0.5
    dt = np.asarray(img).dtype
    a = _hwc(img).astype(np.float32)
    scale = 255.0 if dt == np.uint8 else 1.0
    hsv = _rgb_to_hsv(a / scale)
    hsv[..., 0] = (hsv[..., 0] + hue_factor) % 1.0
    out = _hsv_to_rgb(hsv) * scale
    return _like(out.astype(dt), img)


def adjust_saturation(img, saturation_factor):
    dt = np.asarray(img).dtype
    a = _hwc(img).astype(np.float32)
    gray = a.mean(-1, keepdims=True)
    out = np.clip(gray + (a - gray) * saturation_factor, 0,
                  255 if dt == np.uint8 else None)
    return _like(out.astype(dt), img)


def to_grayscale(img, num_output_channels=1):
    dt = np.asarray(img).dtype
    a = _hwc(img).astype(np.float32)
    gray = (0.299 * a[..., 0] + 0.587 * a[..., 1]
            + 0.114 * a[..., 2])[..., None]
    out = np.repeat(gray, num_output_channels, axis=-1)
    return _like(out.astype(dt), img)


def crop(img, top, left, height, width):
    a = _hwc(img)
    return _like(a[top:top + height, left:left + width], img)


def center_crop(img, output_size):
    if isinstance(output_size, numbers.Number):
        output_size = (int(output_size), int(output_size))
    a = _hwc(img)
    h, w = a.shape[:2]
    th, tw = output_size
    return crop(img, (h - th) // 2, (w - tw) // 2, th, tw)


def pad(img, padding, fill=0, padding_mode="constant"):
    a = _hwc(img)
    if isinstance(padding, numbers.Number):
        pl = pr = pt = pb = int(padding)
    elif len(padding) == 2:
        pl = pr = int(padding[0])
        pt = pb = int(padding[1])
    else:
        pl, pt, pr, pb = (int(p) for p in padding)
    mode = {"constant": "constant", "edge": "edge", "reflect": "reflect",
            "symmetric": "symmetric"}[padding_mode]
    kw = {"constant_values": fill} if mode == "constant" else {}
    out = np.pad(a, ((pt, pb), (pl, pr), (0, 0)), mode=mode, **kw)
    return _like(out, img)


def _affine_sample(a, matrix, out_h, out_w, fill=0):
    """Inverse-map bilinear sampling with a 2x3 matrix (output->input)."""
    h, w = a.shape[:2]
    ys, xs = np.meshgrid(np.arange(out_h), np.arange(out_w), indexing="ij")
    sx = matrix[0, 0] * xs + matrix[0, 1] * ys + matrix[0, 2]
    sy = matrix[1, 0] * xs + matrix[1, 1] * ys + matrix[1, 2]
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    wx = sx - x0
    wy = sy - y0
    out = np.zeros((out_h, out_w, a.shape[2]), np.float32)
    valid = (sx >= -1) & (sx < w) & (sy >= -1) & (sy < h)
    for dy in (0, 1):
        for dx in (0, 1):
            xi = np.clip(x0 + dx, 0, w - 1)
            yi = np.clip(y0 + dy, 0, h - 1)
            wgt = ((wx if dx else 1 - wx) * (wy if dy else 1 - wy))
            out += a[yi, xi].astype(np.float32) * wgt[..., None]
    out = np.where(valid[..., None], out, float(fill))
    return out


def affine(img, angle=0.0, translate=(0, 0), scale=1.0, shear=(0.0, 0.0),
           interpolation="bilinear", fill=0, center=None):
    """ref functional.affine: rotation+translation+scale+shear about the
    image center (inverse-mapped bilinear sampling)."""
    dt = np.asarray(img).dtype
    a = _hwc(img)
    h, w = a.shape[:2]
    cx, cy = center if center is not None else (w * 0.5, h * 0.5)
    rot = np.deg2rad(angle)
    sx, sy = (np.deg2rad(s) for s in (shear if not isinstance(
        shear, numbers.Number) else (shear, 0.0)))
    # forward matrix: T(center+translate) R S Shear T(-center)
    m = np.array([[np.cos(rot + sy) / np.cos(sy),
                   -np.cos(rot + sy) * np.tan(sx) / np.cos(sy)
                   - np.sin(rot), 0],
                  [np.sin(rot + sy) / np.cos(sy),
                   -np.sin(rot + sy) * np.tan(sx) / np.cos(sy)
                   + np.cos(rot), 0]], np.float64) * scale
    m[:, 2] = [cx + translate[0], cy + translate[1]]
    m[0, 2] -= m[0, 0] * cx + m[0, 1] * cy
    m[1, 2] -= m[1, 0] * cx + m[1, 1] * cy
    # invert (2x3 augmented)
    full = np.vstack([m, [0, 0, 1]])
    inv = np.linalg.inv(full)[:2]
    out = _affine_sample(a, inv, h, w, fill)
    return _like(out.astype(dt), img)


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    return affine(img, angle=angle, fill=fill, center=center,
                  interpolation=interpolation)


def perspective(img, startpoints, endpoints, interpolation="nearest",
                fill=0):
    """ref functional.perspective: 4-point homography warp."""
    dt = np.asarray(img).dtype
    a = _hwc(img)
    h, w = a.shape[:2]
    # solve homography mapping endpoints -> startpoints (inverse map)
    A = []
    for (ex, ey), (sx, sy) in zip(endpoints, startpoints):
        A.append([ex, ey, 1, 0, 0, 0, -sx * ex, -sx * ey])
        A.append([0, 0, 0, ex, ey, 1, -sy * ex, -sy * ey])
    b = []
    for (sx, sy) in startpoints:
        b += [sx, sy]
    coef = np.linalg.lstsq(np.asarray(A, np.float64),
                           np.asarray(b, np.float64), rcond=None)[0]
    H = np.append(coef, 1.0).reshape(3, 3)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    denom = H[2, 0] * xs + H[2, 1] * ys + H[2, 2]
    sxs = (H[0, 0] * xs + H[0, 1] * ys + H[0, 2]) / denom
    sys_ = (H[1, 0] * xs + H[1, 1] * ys + H[1, 2]) / denom
    x0 = np.clip(np.round(sxs).astype(np.int64), 0, w - 1)
    y0 = np.clip(np.round(sys_).astype(np.int64), 0, h - 1)
    # validity in the NEAREST-rounding window (±0.5) so border pixels with
    # -1e-14-style numerical fuzz aren't dropped to fill
    valid = (sxs >= -0.5) & (sxs < w - 0.5 + 1e-9) & \
            (sys_ >= -0.5) & (sys_ < h - 0.5 + 1e-9)
    out = np.where(valid[..., None], a[y0, x0], float(fill))
    return _like(out.astype(dt), img)


def erase(img, i, j, h, w, v, inplace=False):
    a = _hwc(img).copy()
    a[i:i + h, j:j + w] = v
    return _like(a, img)


class ColorJitter(BaseTransform):
    """ref transforms.ColorJitter: random brightness/contrast/saturation/
    hue jitter."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        super().__init__(keys)
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def _rand(self, f):
        return random.uniform(max(0, 1 - f), 1 + f)

    def _apply_image(self, img):
        if self.brightness:
            img = adjust_brightness(img, self._rand(self.brightness))
        if self.contrast:
            img = adjust_contrast(img, self._rand(self.contrast))
        if self.saturation:
            img = adjust_saturation(img, self._rand(self.saturation))
        if self.hue:
            img = adjust_hue(img, random.uniform(-self.hue, self.hue))
        return img


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return to_grayscale(img, self.num_output_channels)


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        return adjust_hue(img, random.uniform(-self.value, self.value))


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        return adjust_saturation(
            img, random.uniform(max(0, 1 - self.value), 1 + self.value))


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        super().__init__(keys)
        self.padding = padding
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        return pad(img, self.padding, self.fill, self.padding_mode)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        super().__init__(keys)
        self.degrees = (-degrees, degrees) if isinstance(
            degrees, numbers.Number) else degrees
        self.center = center
        self.fill = fill

    def _apply_image(self, img):
        return rotate(img, random.uniform(*self.degrees),
                      center=self.center, fill=self.fill)


class RandomAffine(BaseTransform):
    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None, keys=None):
        super().__init__(keys)
        self.degrees = (-degrees, degrees) if isinstance(
            degrees, numbers.Number) else degrees
        self.translate = translate
        self.scale = scale
        self.shear = shear
        self.fill = fill
        self.center = center

    def _apply_image(self, img):
        a = _hwc(img)
        h, w = a.shape[:2]
        angle = random.uniform(*self.degrees)
        tx = ty = 0
        if self.translate:
            tx = random.uniform(-self.translate[0], self.translate[0]) * w
            ty = random.uniform(-self.translate[1], self.translate[1]) * h
        sc = random.uniform(*self.scale) if self.scale else 1.0
        sh = (random.uniform(-self.shear, self.shear)
              if isinstance(self.shear, numbers.Number)
              else (random.uniform(*self.shear) if self.shear else 0.0))
        return affine(img, angle=angle, translate=(tx, ty), scale=sc,
                      shear=(sh, 0.0), fill=self.fill, center=self.center)


class RandomPerspective(BaseTransform):
    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="nearest", fill=0, keys=None):
        super().__init__(keys)
        self.prob = prob
        self.distortion_scale = distortion_scale
        self.fill = fill

    def _apply_image(self, img):
        if random.random() >= self.prob:
            return img
        a = _hwc(img)
        h, w = a.shape[:2]
        d = self.distortion_scale
        dx, dy = int(d * w / 2), int(d * h / 2)
        start = [[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]]
        end = [[random.randint(0, dx), random.randint(0, dy)],
               [w - 1 - random.randint(0, dx), random.randint(0, dy)],
               [w - 1 - random.randint(0, dx), h - 1 - random.randint(0, dy)],
               [random.randint(0, dx), h - 1 - random.randint(0, dy)]]
        return perspective(img, start, end, fill=self.fill)


class RandomErasing(BaseTransform):
    """ref transforms.RandomErasing (cutout regularization)."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, keys=None):
        super().__init__(keys)
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value

    def _apply_image(self, img):
        if random.random() >= self.prob:
            return img
        a = _hwc(img)
        h, w = a.shape[:2]
        area = h * w
        for _ in range(10):
            target = random.uniform(*self.scale) * area
            ratio = random.uniform(*self.ratio)
            eh = int(round((target * ratio) ** 0.5))
            ew = int(round((target / ratio) ** 0.5))
            if eh < h and ew < w:
                i = random.randint(0, h - eh)
                j = random.randint(0, w - ew)
                return erase(img, i, j, eh, ew, self.value)
        return img
