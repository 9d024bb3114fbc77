"""Bilinear resample onto the uniform NDC pixel lattice (counterpart of
behindthescenes_tpu/ops/grid_sample.py:283-332).

`resample_uniform_lattice` is what grid_sample (bilinear, border padding)
computes on the linspace(-1, 1) lattice, factored into two small matmuls
because the lattice is fixed.
"""
from __future__ import annotations

import numpy as np
import torch


def _unnormalize(coord, size: int, align_corners: bool):
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


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
