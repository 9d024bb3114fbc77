"""SSIM with the reference's window, padding and composition options
(counterpart of behindthescenes_tpu/ops/ssim.py:12-75), channel-last; the
3x3 window runs as a depthwise convolution.

The window statistics are computed in float64, where the JAX package
computes them in the input's dtype: the variance as E[x^2] - E[x]^2
cancels on flat patches, and two f32 evaluations of the formula that sum
in different orders (XLA's convolution and torch's) differ by their own
rounding, up to 1.5e-4 of the SSIM map on near-flat patches and 2.8e-6 on
uniform noise. In float64 the port is the nearer to exact of the two (see
tests/test_torch_general_path.py). The window's weights are the
reference's f32 constants, as in JAX. The result has the input's dtype."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from behindthescenes_tpu_torch import tracing

# 3x3 gaussian window, the reference's constants (layers.py:82-85).
_GAUSS3 = ((0.0947, 0.1183, 0.0947),
           (0.1183, 0.1478, 0.1183),
           (0.0947, 0.1183, 0.0947))
_C1 = 0.01 ** 2
_C2 = 0.03 ** 2


def _depthwise3(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """3x3 depthwise convolution, valid padding, of NCHW x."""
    c = x.shape[1]
    return F.conv2d(x, window.expand(c, 1, 3, 3), groups=c)


def ssim(x: torch.Tensor, y: torch.Tensor, *, pad_reflection: bool = True,
         gaussian_average: bool = False, comp_mode: bool = False,
         eval_mode: bool = False, pad: bool = True) -> torch.Tensor:
    """SSIM error map of x, y (N, H, W, C) -> (N, H, W, C):
    not eval_mode, not comp_mode: clamp((1 - S) / 2, 0, 1);
    not eval_mode, comp_mode: clamp(1 - S, 0, 1) / 2; eval_mode: S."""
    dtype = x.dtype
    x = x.permute(0, 3, 1, 2).double()
    y = y.permute(0, 3, 1, 2).double()
    if pad:
        mode = "reflect" if pad_reflection else "constant"
        x = F.pad(x, (1, 1, 1, 1), mode=mode)
        y = F.pad(y, (1, 1, 1, 1), mode=mode)
    if gaussian_average:
        window = np.asarray(_GAUSS3, dtype=np.float32)
    else:
        window = np.full((3, 3), 1.0 / 9.0, dtype=np.float32)
    window = tracing.to_device(window, x.device, x.dtype)
    mu_x = _depthwise3(x, window)
    mu_y = _depthwise3(y, window)
    mu_x_sq = mu_x * mu_x
    mu_y_sq = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_x = _depthwise3(x * x, window) - mu_x_sq
    sigma_y = _depthwise3(y * y, window) - mu_y_sq
    sigma_xy = _depthwise3(x * y, window) - mu_xy
    num = (2 * mu_xy + _C1) * (2 * sigma_xy + _C2)
    den = (mu_x_sq + mu_y_sq + _C1) * (sigma_x + sigma_y + _C2)
    s = num / den
    if eval_mode:
        out = s
    elif comp_mode:
        out = torch.clamp(1.0 - s, 0.0, 1.0) * 0.5
    else:
        out = torch.clamp((1.0 - s) * 0.5, 0.0, 1.0)
    return out.permute(0, 2, 3, 1).to(dtype)
