"""Grid sampling with torch `F.grid_sample` semantics, channel-last
(counterpart of behindthescenes_tpu/ops/grid_sample.py:17-332).

- `grid_sample_2d`: bilinear or nearest, border or zeros padding, at
  arbitrary points, with the JAX package's formula.
- `grid_sample_2d_xpair` and `grid_sample_2d_packed`: what the JAX
  package's corner-packed bf16 paths compute (pack_corners_x +
  grid_sample_2d_xpair, pack_corners + grid_sample_2d_packed), rounded
  where they round. The packing itself is a layout for the TPU's gather
  rows; here the corners are gathered from the unpacked map, clamped at
  the edge as the packing clamps them.
- `grid_sample_2d_tiles` and `tile_region_fit`: bilinear sampling of
  tile-grouped points from one dense region per tile (patch-mode
  training's tile fetch).
- `resample_uniform_lattice`: bilinear, border padding, on the
  linspace(-1, 1) lattice, factored into two small matmuls because the
  lattice is fixed.
"""
from __future__ import annotations

import numpy as np
import torch

from behindthescenes_tpu_torch import tracing


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


def grid_sample_2d_tiles(image: torch.Tensor, coords: torch.Tensor,
                         region_hw) -> torch.Tensor:
    """Bilinear sample of tile-grouped points, each tile from one dense
    (rh, rw) region (behindthescenes_tpu/ops/grid_sample.py:224-268).

    Per tile, the region is anchored at the tile's clipped coordinate
    minimum and gathered by index; the points are interpolated from it
    with separable hat-function products, val[p] = sum_y hy[p, y] sum_x
    hx[p, x] R[y, x, :], with the hat weights cast to the image's dtype as
    the JAX package casts them. This equals grid_sample_2d(...,
    align_corners=False, padding_mode="border") for points whose clipped
    coordinates fall inside their tile's region; points outside read zero
    (every hat weight vanishes). `tile_region_fit` says which tiles fit.
    The gradient with respect to the image is autograd's (the region
    gather's backward accumulates, with atomics on the card).

    image (H, W, C); coords (T, P, 2) -> (T, P, C) in image's dtype."""
    h, w, _ = image.shape
    rh, rw = region_hw
    if rh > h or rw > w:
        raise ValueError(f"tile region {rh}x{rw} exceeds the {h}x{w} map")
    px, py, x0, y0 = _tile_anchor(coords, (h, w), region_hw)
    ry = torch.arange(rh, dtype=px.dtype, device=px.device)
    rx = torch.arange(rw, dtype=px.dtype, device=px.device)
    hy = torch.relu(1.0 - ((py - y0[:, None].to(py.dtype))[..., None]
                           - ry).abs())                         # (T, P, rh)
    hx = torch.relu(1.0 - ((px - x0[:, None].to(px.dtype))[..., None]
                           - rx).abs())                         # (T, P, rw)
    rows = y0[:, None] + torch.arange(rh, device=image.device)  # (T, rh)
    cols = x0[:, None] + torch.arange(rw, device=image.device)  # (T, rw)
    region = image[rows[:, :, None], cols[:, None, :]]      # (T, rh, rw, C)
    inner = torch.einsum("tpr,tyrc->tpyc", hx.to(image.dtype), region)
    return torch.einsum("tpy,tpyc->tpc", hy.to(image.dtype), inner)


def _tile_anchor(coords, image_hw, region_hw):
    """Clipped source coordinates px, py (T, P) and each tile's region
    origin x0, y0 (T,): the minimum truncated (as astype(int32); the
    minima are >= 0), kept inside the map."""
    h, w = image_hw
    rh, rw = region_hw
    px = torch.clamp(_unnormalize(coords[..., 0], w, False), 0.0, w - 1)
    py = torch.clamp(_unnormalize(coords[..., 1], h, False), 0.0, h - 1)
    x0 = torch.clamp(px.amin(1).to(torch.int64), 0, max(w - rw, 0))
    y0 = torch.clamp(py.amin(1).to(torch.int64), 0, max(h - rh, 0))
    return px, py, x0, y0


def tile_points_inside(coords: torch.Tensor, image_hw, region_hw):
    """Per point (T, P) bool: do both texels of its bilinear footprint lie
    in its tile's region, where grid_sample_2d_tiles equals
    grid_sample_2d? `tile_region_fit` can pass a tile whose span is
    within a texel of the region's while its region, anchored at the
    truncated minimum, ends before its last point's second texel."""
    rh, rw = region_hw
    px, py, x0, y0 = _tile_anchor(coords, image_hw, region_hw)
    return (px - x0[:, None] <= rw - 1) & (py - y0[:, None] <= rh - 1)


def tile_region_fit(coords: torch.Tensor, image_hw, region_hw):
    """Per tile: does every clipped point fall inside a (rh, rw) region
    anchored at the tile's minimum (behindthescenes_tpu/ops/
    grid_sample.py:271-280)? coords (T, P, 2) -> (T,) bool."""
    h, w = image_hw
    rh, rw = region_hw
    px = torch.clamp(_unnormalize(coords[..., 0], w, False), 0.0, w - 1)
    py = torch.clamp(_unnormalize(coords[..., 1], h, False), 0.0, h - 1)
    dx = px.amax(1) - px.amin(1)
    dy = py.amax(1) - py.amin(1)
    return (dy <= rh - 1) & (dx <= rw - 1)


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
    ry = tracing.to_device(_lattice_matrix(oh, h, align_corners),
                           image.device, image.dtype)
    rx = tracing.to_device(_lattice_matrix(ow, w, align_corners),
                           image.device, image.dtype)
    out = torch.einsum("oh,hwc->owc", ry, image)
    return torch.einsum("pw,owc->opc", rx, out)
