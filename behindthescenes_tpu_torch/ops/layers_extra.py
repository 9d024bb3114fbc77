"""The rest of the reference's layer library (counterpart of
behindthescenes_tpu/ops/layers_extra.py; reference
models/common/model/layers.py): back-projection (:44-63),
point_projection (:66-72), the residual-image warp (:153-225),
PadSameConv2d (:228-258), PadSameConv2dTransposed (:261-297), ConvReLU2
(:300-327), ConvReLU (:330-346), Upconv (:349-367), ConvSig (:370-387)
and Refine (:390-410). The shipped BTS configs use none of them; they
complete the layer surface for the reference's other model families.

Conventions are the JAX package's: NHWC images at the interface (NCHW
inside the convolutions), points as (n, p, d) rows, functions where the
reference is stateless and modules where there are weights. A module
takes its input width at construction, where Flax infers it. Parameter
layouts are torch's: a Flax conv kernel (kh, kw, in, out) is
weight.permute(2, 3, 1, 0); Refine's transposed kernel is torch's
(in, out, kh, kw) flipped in both spatial axes (Flax's ConvTranspose
does not flip its kernel, torch's conv_transpose2d does).

`residual_image` computes the SSIM through the port's `ops/ssim.py`,
whose window statistics are float64 where the JAX package's are f32: on
inputs of unit scale the two differ by up to about 3e-6 (see that
module).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from behindthescenes_tpu_torch import geometry
from behindthescenes_tpu_torch.models.bts import _linspace
from behindthescenes_tpu_torch.models.encoder import _conv
from behindthescenes_tpu_torch.ops.grid_sample import grid_sample_2d
from behindthescenes_tpu_torch.ops.ssim import ssim


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


# ------------------------------------------------------------------ projection
def ndc_grid(h: int, w: int, dtype=torch.float32, device=None):
    """Homogeneous NDC pixel grid [x, y, 1], (h*w, 3), x fastest
    (reference layers.py:50-55: linspace(-1, 1) inclusive)."""
    # jnp.linspace's formula, each operation rounded (XLA's fused
    # evaluation of it differs by up to an ulp).
    gy, gx = torch.meshgrid(_linspace(h, dtype, device),
                            _linspace(w, dtype, device), indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1),
                        torch.ones(h * w, dtype=dtype, device=device)], -1)


def backproject(depth: torch.Tensor, inv_k: torch.Tensor) -> torch.Tensor:
    """A depth map (n, h, w) or (n, h, w, 1) lifted through the inverse
    NDC intrinsics inv_k (n, 3, 3) to homogeneous camera points (n, h*w,
    4) (reference Backprojection, layers.py:44-63)."""
    if depth.ndim == 4:
        depth = depth[..., 0]
    n, h, w = depth.shape
    coord = ndc_grid(h, w, depth.dtype, depth.device)
    cam = [inv_k[:, None, i, 0] * coord[None, :, 0]
           + inv_k[:, None, i, 1] * coord[None, :, 1]
           + inv_k[:, None, i, 2] for i in range(3)]
    d = depth.reshape(n, h * w)
    return torch.stack([cam[0] * d, cam[1] * d, cam[2] * d,
                        torch.ones_like(d)], -1)


def point_projection(points: torch.Tensor, k: torch.Tensor,
                     t: torch.Tensor, eps: float = 1e-7):
    """Homogeneous points (n, p, 4) through the transform t (n, 4, 4) and
    the intrinsics k (n, 3, 3) (reference layers.py:66-72): (normalised
    xy (n, p, 2), camera z (n, p))."""
    kt = k[:, :3, :3] @ t[:, :3, :]                              # (n, 3, 4)
    cam = [sum(kt[:, None, i, j] * points[..., j] for j in range(4))
           for i in range(3)]
    z = cam[2]
    return torch.stack([cam[0], cam[1]], -1) / (z + eps)[..., None], z


def residual_image(keyframe: torch.Tensor, keyframe_pose: torch.Tensor,
                   keyframe_k: torch.Tensor, inv_depth: torch.Tensor,
                   frames: Sequence[torch.Tensor],
                   poses: Sequence[torch.Tensor],
                   intrinsics: Sequence[torch.Tensor],
                   inv_depth_min: float = 1.0,
                   inv_depth_max: float = 0.0) -> torch.Tensor:
    """The least SSIM residual (n, h, w, 1) between the keyframe (n, h, w,
    3) in [-1, 1] and the source frames warped into it through a
    predicted depth, 0 where no source frame sees the pixel (the intended
    semantics of the reference's ResidualImageModule, layers.py:166-225,
    which raises upstream). inv_depth (n, h, w, 1) in [0, 1] maps to
    inverse depth by lerp(inv_depth_max, inv_depth_min); poses are
    camera-to-world (n, 4, 4), intrinsics NDC (n, 3, 3)."""
    n, h, w, _ = keyframe.shape
    invd = ((1.0 - inv_depth) * inv_depth_max
            + inv_depth * inv_depth_min)[..., 0]
    depth = 1.0 / torch.clamp_min(invd, 1e-7)
    cam = backproject(depth, torch.linalg.inv(keyframe_k))
    residuals, masks = [], []
    for img, pose, k in zip(frames, poses, intrinsics):
        t = geometry.invert_pose(pose) @ keyframe_pose
        xy, _ = point_projection(cam, k, t)
        # A sample is unseen where any channel of image + 1 (zero-padded)
        # is exactly 0; align_corners keeps the linspace(-1, 1) grid
        # self-consistent.
        warped = grid_sample_2d(img + 1.0, xy, align_corners=True,
                                padding_mode="zeros")
        mask = (warped == 0.0).any(-1, keepdim=True).reshape(n, h, w, 1)
        res = ssim((warped - 0.5).reshape(n, h, w, 3), keyframe + 0.5)
        res = res.mean(-1, keepdim=True)
        residuals.append(torch.where(mask, torch.inf, res))
        masks.append(mask)
    residual = torch.stack(residuals).min(0).values
    unseen = torch.stack(masks).all(0)
    return torch.where(unseen, torch.zeros_like(residual), residual)


# ---------------------------------------------------------------- pad-same ops
def pad_same(x: torch.Tensor, kernel_size, stride=1) -> torch.Tensor:
    """TensorFlow's "same" padding for a VALID convolution of NHWC x
    (reference PadSameConv2d, layers.py:228-258; negative pads crop, as
    F.pad does)."""
    ky, kx = _pair(kernel_size)
    sy, sx = _pair(stride)
    _, h, w, _ = x.shape
    py = (sy * (math.ceil(h / sy) - 1) + ky - h) / 2
    px = (sx * (math.ceil(w / sx) - 1) + kx - w) / 2
    lo_y, hi_y = math.floor(py), math.ceil(py)
    lo_x, hi_x = math.floor(px), math.ceil(px)
    x = x[:, max(0, -lo_y):x.shape[1] - max(0, -hi_y),
          max(0, -lo_x):x.shape[2] - max(0, -hi_x)]
    return F.pad(x, (0, 0, max(0, lo_x), max(0, hi_x), max(0, lo_y),
                     max(0, hi_y)))


def pad_same_transposed(x: torch.Tensor, orig_hw, stride=2) -> torch.Tensor:
    """NHWC x padded or cropped to exactly orig_hw * stride (reference
    PadSameConv2dTransposed, layers.py:261-297)."""
    sy, sx = _pair(stride)
    for axis, target in ((1, orig_hw[0] * sy), (2, orig_hw[1] * sx)):
        over = target - x.shape[axis]
        if over > 0:
            pad = [0, 0] * (4 - axis)
            pad[-2:] = [math.floor(over / 2), math.ceil(over / 2)]
            x = F.pad(x, pad)
        elif over < 0:
            lo = math.floor(-over / 2)
            x = x.narrow(axis, lo, x.shape[axis] - lo - math.ceil(-over / 2))
    return x


# -------------------------------------------------------------- weight layers
def _nhwc_conv(conv: nn.Conv2d, x: torch.Tensor, dtype) -> torch.Tensor:
    """`conv` over NHWC x in the compute dtype, NHWC out."""
    return _conv(conv, x.permute(0, 3, 1, 2), dtype).permute(0, 2, 3, 1)


class ConvReLU(nn.Module):
    """pad_same, a convolution, leaky relu (reference layers.py:330-346)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 stride: int = 1, neg_slope: float = 0.1,
                 compute_dtype=torch.float32):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.neg_slope, self.dt = neg_slope, compute_dtype
        self.conv = nn.Conv2d(in_ch, features, _pair(kernel_size),
                              _pair(stride))

    def forward(self, x):
        x = pad_same(x, self.kernel_size, self.stride)
        return F.leaky_relu(_nhwc_conv(self.conv, x, self.dt),
                            self.neg_slope)


class ConvReLU2(nn.Module):
    """A (k, 1) then a (1, k) convolution, each followed by leaky relu
    (reference layers.py:300-327)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 stride: int = 1, neg_slope: float = 0.1,
                 compute_dtype=torch.float32):
        super().__init__()
        k, s = kernel_size, stride
        self.kernel_size, self.stride = k, s
        self.neg_slope, self.dt = neg_slope, compute_dtype
        self.conv_y = nn.Conv2d(in_ch, features, (k, 1), (s, 1))
        self.conv_x = nn.Conv2d(features, features, (1, k), (1, s))

    def forward(self, x):
        k, s = self.kernel_size, self.stride
        x = pad_same(x, (k, 1), (s, 1))
        x = F.leaky_relu(_nhwc_conv(self.conv_y, x, self.dt), self.neg_slope)
        x = pad_same(x, (1, k), (1, s))
        return F.leaky_relu(_nhwc_conv(self.conv_x, x, self.dt),
                            self.neg_slope)


class Upconv(nn.Module):
    """A 2x nearest upsample and a 2x2 "same" convolution (reference
    layers.py:349-367)."""

    def __init__(self, in_ch: int, features: int,
                 compute_dtype=torch.float32):
        super().__init__()
        self.dt = compute_dtype
        self.conv = nn.Conv2d(in_ch, features, 2)

    def forward(self, x):
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return _nhwc_conv(self.conv, pad_same(x, 2), self.dt)


class ConvSig(nn.Module):
    """pad_same, a convolution, sigmoid (reference layers.py:370-387)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 stride: int = 1, compute_dtype=torch.float32):
        super().__init__()
        self.kernel_size, self.stride, self.dt = kernel_size, stride, \
            compute_dtype
        self.conv = nn.Conv2d(in_ch, features, _pair(kernel_size),
                              _pair(stride))

    def forward(self, x):
        x = pad_same(x, self.kernel_size, self.stride)
        return torch.sigmoid(_nhwc_conv(self.conv, x, self.dt))


class Refine(nn.Module):
    """A 4x4 stride-2 transposed convolution and leaky relu, padded to
    exactly twice the input's size, with an optional skip concatenated
    (reference layers.py:390-410)."""

    def __init__(self, in_ch: int, features: int, neg_slope: float = 0.1,
                 compute_dtype=torch.float32):
        super().__init__()
        self.neg_slope, self.dt = neg_slope, compute_dtype
        self.conv2d_t = nn.ConvTranspose2d(in_ch, features, 4, 2)

    def forward(self, x, features_direct: Optional[torch.Tensor] = None):
        orig_hw = x.shape[1:3]
        conv = self.conv2d_t
        out = F.conv_transpose2d(x.permute(0, 3, 1, 2).to(self.dt),
                                 conv.weight.to(self.dt), None, 2)
        out = out + conv.bias.to(out.dtype)[:, None, None]
        x = F.leaky_relu(out.permute(0, 2, 3, 1), self.neg_slope)
        x = pad_same_transposed(x, orig_hw, 2)
        if features_direct is not None:
            x = torch.cat([x, features_direct.to(x.dtype)], -1)
        return x
