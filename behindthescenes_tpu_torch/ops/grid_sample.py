"""Grid sampling with torch `F.grid_sample` semantics, channel-last
(counterpart of behindthescenes_tpu/ops/grid_sample.py:17-222, 283-332).

- `grid_sample_2d`: bilinear or nearest, border or zeros padding, at
  arbitrary points, with the JAX package's formula.
- `grid_sample_2d_xpair` and `grid_sample_2d_packed`: what the JAX
  package's corner-packed bf16 paths compute (pack_corners_x +
  grid_sample_2d_xpair, pack_corners + grid_sample_2d_packed), rounded
  where they round. The packing itself is a layout for the TPU's gather
  rows; here the corners are gathered from the unpacked map, clamped at
  the edge as the packing clamps them.
- `resample_uniform_lattice`: bilinear, border padding, on the
  linspace(-1, 1) lattice, factored into two small matmuls because the
  lattice is fixed.
"""
from __future__ import annotations

import numpy as np
import torch


def _unnormalize(coord, size: int, align_corners: bool):
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _row_gather(image, iy, ix):
    """Rows image[..., iy, ix, :] (..., P, C) of in-bounds integer
    coordinates (..., P): one index per pixel into the flattened map."""
    h, w, c = image.shape[-3:]
    batch = image.shape[:-3]
    b = int(np.prod(batch)) if batch else 1
    flat = image.reshape(b * h * w, c)
    offsets = (torch.arange(b, device=image.device) * (h * w))[:, None]
    idx = (iy * w + ix).reshape(b, -1) + offsets
    return flat.index_select(0, idx.reshape(-1)).reshape(
        batch + (iy.shape[-1], c))


def grid_sample_2d(image: torch.Tensor, coords: torch.Tensor, *,
                   align_corners: bool = False, padding_mode: str = "border",
                   mode: str = "bilinear") -> torch.Tensor:
    """Sample image (..., H, W, C) at normalized coords (..., P, 2) in
    [-1, 1] (x, y) -> (..., P, C), `F.grid_sample`'s function computed as
    the JAX package computes it (four row gathers, weights wx * wy)."""
    if padding_mode not in ("border", "zeros"):
        raise NotImplementedError(padding_mode)
    h, w = image.shape[-3], image.shape[-2]
    x = _unnormalize(coords[..., 0], w, align_corners)
    y = _unnormalize(coords[..., 1], h, align_corners)

    def inside(ix, iy):
        return (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)

    def fetch(ix, iy):
        return _row_gather(image, torch.clamp(iy, 0, h - 1),
                           torch.clamp(ix, 0, w - 1))

    if mode == "nearest":
        ix, iy = torch.round(x).long(), torch.round(y).long()
        out = fetch(ix, iy)
        if padding_mode == "zeros":
            out = torch.where(inside(ix, iy)[..., None], out,
                              torch.zeros_like(out))
        return out
    if mode != "bilinear":
        raise NotImplementedError(mode)
    if padding_mode == "border":
        x = torch.clamp(x, 0.0, w - 1)
        y = torch.clamp(y, 0.0, h - 1)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    ix0, iy0 = x0.long(), y0.long()
    out = 0
    for ix, iy, wgt in ((ix0, iy0, wx0 * wy0), (ix0 + 1, iy0, wx1 * wy0),
                        (ix0, iy0 + 1, wx0 * wy1),
                        (ix0 + 1, iy0 + 1, wx1 * wy1)):
        if padding_mode == "zeros":
            wgt = torch.where(inside(ix, iy), wgt, torch.zeros_like(wgt))
        out = out + fetch(ix, iy) * wgt[..., None]
    return out


def _corner_coords(shape, coords, align_corners):
    """Border-clipped source coordinates -> (ix0, iy0, x - x0, y - y0), the
    last two in f32."""
    h, w = shape[-3], shape[-2]
    x = torch.clamp(_unnormalize(coords[..., 0], w, align_corners), 0.0,
                    w - 1)
    y = torch.clamp(_unnormalize(coords[..., 1], h, align_corners), 0.0,
                    h - 1)
    x0, y0 = torch.floor(x), torch.floor(y)
    return x0.long(), y0.long(), x - x0, y - y0


def _bilinear_border(image, coords, align_corners, weight_dtype):
    """Bilinear, border padding, as the JAX package's packed paths lerp:
    x first, then y, `v0 * (1 - w) + v1 * w` with the weights in
    weight_dtype and the corner values in image's dtype."""
    h, w = image.shape[-3], image.shape[-2]
    ix0, iy0, fx, fy = _corner_coords(image.shape, coords, align_corners)
    ix1 = torch.clamp_max(ix0 + 1, w - 1)
    iy1 = torch.clamp_max(iy0 + 1, h - 1)
    wx1 = fx.to(weight_dtype)[..., None]
    wy1 = fy.to(weight_dtype)[..., None]
    top = _row_gather(image, iy0, ix0) * (1 - wx1) \
        + _row_gather(image, iy0, ix1) * wx1
    bot = _row_gather(image, iy1, ix0) * (1 - wx1) \
        + _row_gather(image, iy1, ix1) * wx1
    return top * (1 - wy1) + bot * wy1


def grid_sample_2d_xpair(image: torch.Tensor, coords: torch.Tensor, *,
                         align_corners: bool = False) -> torch.Tensor:
    """The x-pair path of the JAX package's bf16 feature maps with C > 32:
    the corner values and the lerp weights are in image's dtype and every
    lerp runs in it. image (..., H, W, C), coords (..., P, 2) -> (..., P,
    C) in image's dtype."""
    return _bilinear_border(image, coords, align_corners, image.dtype)


def grid_sample_2d_packed(image: torch.Tensor, coords: torch.Tensor, *,
                          align_corners: bool = False) -> torch.Tensor:
    """The 4-corner path of the JAX package (bf16 feature maps with C <=
    32, f16 colors, f32 colors): corner values in image's dtype, lerp
    weights and the result in f32 (f64 for an f64 image). image (..., H,
    W, C), coords (..., P, 2) -> (..., P, C)."""
    return _bilinear_border(image, coords, align_corners,
                            torch.promote_types(image.dtype, torch.float32))


def _lattice_matrix(out_size: int, in_size: int,
                    align_corners: bool = False) -> np.ndarray:
    """(out_size, in_size) bilinear-resample matrix for the
    linspace(-1, 1, out_size) lattice under border padding: the 1-D factor
    of grid_sample on that lattice."""
    x = np.linspace(-1.0, 1.0, out_size, dtype=np.float64)
    u = np.clip(_unnormalize(x, in_size, align_corners), 0.0, in_size - 1)
    i0 = np.floor(u).astype(np.int64)
    f = u - i0
    i1 = np.minimum(i0 + 1, in_size - 1)
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    mat[np.arange(out_size), i0] += (1.0 - f).astype(np.float32)
    mat[np.arange(out_size), i1] += f.astype(np.float32)
    return mat


def resample_uniform_lattice(image: torch.Tensor, out_hw,
                             align_corners: bool = False) -> torch.Tensor:
    """image (H, W, C) -> (out_h, out_w, C) in image's dtype."""
    h, w, _ = image.shape
    oh, ow = out_hw
    ry = torch.as_tensor(_lattice_matrix(oh, h, align_corners),
                         dtype=image.dtype, device=image.device)
    rx = torch.as_tensor(_lattice_matrix(ow, w, align_corners),
                         dtype=image.dtype, device=image.device)
    out = torch.einsum("oh,hwc->owc", ry, image)
    return torch.einsum("pw,owc->opc", rx, out)
