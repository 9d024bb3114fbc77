"""Bilinear remap of float images with a constant zero border: a numpy
emulation of `cv2.remap(img, map_x, map_y, cv2.INTER_LINEAR,
borderMode=cv2.BORDER_CONSTANT, borderValue=0)` on float32 (h, w, c)
images, the resample behind behindthescenes_tpu/datasets/kitti_360.py:68-71.

OpenCV 5 remaps float images with float maps at full precision (no
1/32-pixel lattice): at (x, y), with x0 = floor(x), a = x - x0 (and y0,
b likewise) and the four neighbours p00, p01 (row y0), p10, p11 (row
y0 + 1), it takes
    f0 = fma(a, p01 - p00, p00), f1 = fma(a, p11 - p10, p10),
    out = fma(b, f1 - f0, f0)
in float32, and reads each neighbour outside the image as 0, one by one.
The fused multiply-adds are emulated in float64 (the product is exact
there, and rounding the float64 sum to float32 agrees with one rounding
except when the float64 sum falls exactly on a float32 tie).
"""
from __future__ import annotations

import numpy as np


def fma32(a, b, c) -> np.ndarray:
    """a * b + c of float32 operands with one rounding to float32, as a
    fused multiply-add (emulated in float64)."""
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def remap_linear(img: np.ndarray, map_x: np.ndarray,
                 map_y: np.ndarray) -> np.ndarray:
    """img (H, W, C) or (H, W) float32; map_x, map_y (h, w) float32 source
    pixel coordinates -> (h, w, C) or (h, w) float32. A coordinate that
    is not finite gives NaN, as in OpenCV."""
    img = np.asarray(img, dtype=np.float32)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    hs, ws = img.shape[:2]
    mx = np.asarray(map_x, dtype=np.float32)
    my = np.asarray(map_y, dtype=np.float32)
    nan = ~(np.isfinite(mx) & np.isfinite(my))
    # Far outside is as good as just outside: every neighbour reads 0.
    mx = np.clip(np.where(nan, -4.0, mx), -4.0, ws + 4.0).astype(np.float32)
    my = np.clip(np.where(nan, -4.0, my), -4.0, hs + 4.0).astype(np.float32)
    fx, fy = np.floor(mx), np.floor(my)
    a = (mx - fx)[..., None]
    b = (my - fy)[..., None]
    x0, y0 = fx.astype(np.int64), fy.astype(np.int64)
    padded = np.zeros((hs + 2, ws + 2, img.shape[2]), np.float32)
    padded[1:-1, 1:-1] = img

    def at(dy, dx):
        return padded[np.clip(y0 + dy, -1, hs) + 1,
                      np.clip(x0 + dx, -1, ws) + 1]

    p00, p01, p10, p11 = at(0, 0), at(0, 1), at(1, 0), at(1, 1)
    f0 = fma32(a, p01 - p00, p00)
    f1 = fma32(a, p11 - p10, p10)
    out = fma32(b, f1 - f0, f0)
    out[nan] = np.nan
    return out[..., 0] if squeeze else out
