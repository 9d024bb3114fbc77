"""Colour augmentation (counterpart of
behindthescenes_tpu/datasets/augmentation.py:25-77; reference
utils/augmentation.py:3-18 with torchvision ColorJitter's float
formulation), in numpy.

One jitter is drawn per item and applied to every view: brightness,
contrast and saturation scale factors and a hue rotation, in a random
order. The JAX package runs saturation and hue through OpenCV
(`cv2.transform`, `addWeighted`, float RGB <-> HSV); here they are numpy
with OpenCV 5's float formulas, fused multiply-adds where it fuses them:
H in degrees, S and V in [0, 1], H = 0 where max equals min, and
HSV -> RGB through the six-sector table.
"""
from __future__ import annotations

import numpy as np

from behindthescenes_tpu_torch.datasets.remap import fma32

# ITU-R 601 grayscale weights (torchvision rgb_to_grayscale).
_GRAY_W = np.array([0.299, 0.587, 0.114], np.float32)
_EPS = np.float32(np.finfo(np.float32).eps)
# HSV -> RGB: for each sector, the entries of (v, p, q, t) that are r, g
# and b (OpenCV's sector_data, read in RGB order).
_SECTOR_RGB = np.array([[0, 3, 1], [2, 0, 1], [1, 0, 3], [1, 2, 0],
                        [3, 1, 0], [0, 1, 2]])


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """float32 RGB (..., 3) -> HSV: H in [0, 360), S and V as OpenCV's
    COLOR_RGB2HSV computes them for float images."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    vmin = np.minimum(np.minimum(r, g), b)
    diff = v - vmin
    s = diff / (np.abs(v) + _EPS)
    scale = np.float32(60.0) / (diff + _EPS)
    h_r = (g - b) * scale
    h_r = np.where(h_r < 0, fma32(g - b, scale, np.float32(360.0)), h_r)
    h = np.where(v == r, h_r,
                 np.where(v == g, fma32(b - r, scale, np.float32(120.0)),
                          fma32(r - g, scale, np.float32(240.0))))
    return np.stack([h, s, v], axis=-1).astype(np.float32)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """The inverse, as OpenCV's COLOR_HSV2RGB for float images."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    h = h * np.float32(6.0 / 360.0)
    sector = np.floor(h)
    h = (h - sector).astype(np.float32)
    sector = np.mod(sector, 6).astype(np.int64)
    one = np.float32(1.0)
    tab = np.stack([v, v * (one - s), v * fma32(-s, h, one),
                    v * fma32(-s, one - h, one)], axis=-1)
    return np.take_along_axis(tab, _SECTOR_RGB[sector], axis=-1) \
        .astype(np.float32)


def sample_color_jitter(rng: np.random.Generator,
                        brightness=(0.8, 1.2), contrast=(0.8, 1.2),
                        saturation=(0.8, 1.2), hue=(-0.1, 0.1)):
    """Returns a function (h, w, 3) float32 [0, 1] -> jittered image (a new
    array; the input is not changed). The draws are the JAX package's, in
    its order: the permutation, then the b, c, s and h uniforms."""
    order = rng.permutation(4)
    b = float(rng.uniform(*brightness))
    c = float(rng.uniform(*contrast))
    s = float(rng.uniform(*saturation))
    h = float(rng.uniform(*hue))

    def adjust_brightness(img):
        np.multiply(img, b, out=img)
        return np.clip(img, 0.0, 1.0, out=img)

    def adjust_contrast(img):
        # clamp((img - gm) * c + gm), gm the scalar grayscale mean.
        gm = float(img.mean(axis=(0, 1)) @ _GRAY_W)
        np.multiply(img, c, out=img)
        img += (1.0 - c) * gm
        return np.clip(img, 0.0, 1.0, out=img)

    def adjust_saturation(img):
        # clamp(img * s + gray * (1 - s)), gray per pixel.
        gray = fma32(img[..., 2], _GRAY_W[2],
                     fma32(img[..., 0], _GRAY_W[0], img[..., 1] * _GRAY_W[1]))
        out = fma32(img, np.float32(s),
                    (gray * np.float32(1.0 - s))[..., None])
        return np.clip(out, 0.0, 1.0, out=out)

    def adjust_hue(img):
        hsv = rgb_to_hsv(img)
        hsv[..., 0] = np.mod(hsv[..., 0] + np.float32(h * 360.0),
                             np.float32(360.0))
        return np.clip(hsv_to_rgb(hsv), 0.0, 1.0)

    fns = [adjust_brightness, adjust_contrast, adjust_saturation, adjust_hue]

    def apply(img):
        img = np.ascontiguousarray(img, dtype=np.float32).copy()
        for i in order:
            img = fns[i](img)
        return img

    return apply
