"""3D-convolution residual blocks (counterpart of
behindthescenes_tpu/models/resnet3dconv.py; reference
models/common/model/resnet3dconv.py, in the reference's model zoo and
unused by the shipped BTS configs). Channel-last (N, D, H, W, C) at the
interface, NCDHW inside the convolutions. A module takes its input width
at construction, where Flax infers it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def _act(v: torch.Tensor, beta: float) -> torch.Tensor:
    """softplus(beta v) / beta, or relu where beta is 0."""
    return F.softplus(beta * v) / beta if beta > 0 else torch.relu(v)


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Flax's "SAME" padding of NCDHW x for a k-wide stride-s kernel: the
    total pad max((ceil(n / s) - 1) s + k - n, 0) per axis, the smaller
    half first."""
    pads = []
    for n in reversed(x.shape[2:]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def _conv3d(in_ch: int, out_ch: int, k: int, s: int, bias: bool = True,
            zero: bool = False) -> nn.Conv3d:
    conv = nn.Conv3d(in_ch, out_ch, k, s, bias=bias)
    if zero:
        nn.init.zeros_(conv.weight)
    else:      # He normal over the fan-in, as the JAX package's init
        nn.init.kaiming_normal_(conv.weight, mode="fan_in",
                                nonlinearity="relu")
    if bias:
        nn.init.zeros_(conv.bias)
    return conv


class ResnetBlock3DConv(nn.Module):
    """A residual 3D-conv block whose second convolution starts at zero,
    so the block starts as the identity (DVR-style, as ResnetBlockFC)."""

    def __init__(self, size_in: int, size_out: Optional[int] = None,
                 size_h: Optional[int] = None, beta: float = 0.0,
                 kernel_size: int = 1, stride: int = 1):
        super().__init__()
        size_out = size_out or size_in
        size_h = size_h or min(size_in, size_out)
        self.beta, self.k, self.s = beta, kernel_size, stride
        k, s = kernel_size, stride
        self.conv_0 = _conv3d(size_in, size_h, k, s)
        self.conv_1 = _conv3d(size_h, size_out, k, s, zero=True)
        self.shortcut = None if size_in == size_out and stride == 1 \
            else _conv3d(size_in, size_out, k, s, bias=False)

    def _conv(self, conv, x):
        if self.k > 1:
            x = _same_pad(x, self.k, self.s)
        return conv(x)

    def forward(self, x):
        """x (N, D, H, W, C) -> (N, D', H', W', size_out)."""
        x = x.permute(0, 4, 1, 2, 3)
        net = self._conv(self.conv_0, _act(x, self.beta))
        dx = self._conv(self.conv_1, _act(net, self.beta))
        x_s = x if self.shortcut is None else self._conv(self.shortcut, x)
        return (x_s + dx).permute(0, 2, 3, 4, 1)


class Resnet3DConv(nn.Module):
    """A stack of 3D-conv residual blocks over a voxel feature grid: a 1x1x1
    convolution in, `n_blocks` blocks, the activation and a 1x1x1
    convolution out. (N, D, H, W, d_in) -> (N, D, H, W, d_out)."""

    def __init__(self, d_in: int, n_blocks: int = 3, d_hidden: int = 64,
                 d_out: int = 4, beta: float = 0.0):
        super().__init__()
        self.beta = beta
        self.conv_in = _conv3d(d_in, d_hidden, 1, 1)
        self.blocks = nn.ModuleList(
            ResnetBlock3DConv(d_hidden, beta=beta) for _ in range(n_blocks))
        self.conv_out = _conv3d(d_hidden, d_out, 1, 1)

    def forward(self, x):
        x = self.conv_in(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
        for block in self.blocks:
            x = block(x)
        x = _act(x, self.beta).permute(0, 4, 1, 2, 3)
        return self.conv_out(x).permute(0, 2, 3, 4, 1)
