"""Image-quality metrics of NVS evaluation (counterpart of
behindthescenes_tpu/evaluation/metrics.py:1-150).

PSNR and a skimage-compatible SSIM (uniform 7x7 window, sample-covariance
normalization) run on the host in numpy float64, as in the JAX package.
LPIPS(VGG16) runs in torch on a device, with pretrained VGG weights that
must be supplied locally: see LPIPSVGG.
"""
from __future__ import annotations

import logging
import os

import numpy as np
import torch
import torch.nn.functional as F


def psnr(pred: np.ndarray, gt: np.ndarray, data_range: float = 1.0) -> float:
    mse = float(np.mean((pred.astype(np.float64)
                         - gt.astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(data_range ** 2 / mse)


def _uniform_filter(img: np.ndarray, size: int) -> np.ndarray:
    """Valid-mode uniform filter via cumulative sums (2D, per channel)."""
    out = img.astype(np.float64)
    for axis in (0, 1):
        c = np.cumsum(out, axis=axis)
        c = np.concatenate([np.zeros_like(np.take(c, [0], axis=axis)), c],
                           axis=axis)
        hi = np.take(c, range(size, c.shape[axis]), axis=axis)
        lo = np.take(c, range(0, c.shape[axis] - size), axis=axis)
        out = (hi - lo) / size
    return out


def ssim(pred: np.ndarray, gt: np.ndarray, data_range: float = 1.0,
         win_size: int = 7, k1: float = 0.01, k2: float = 0.03) -> float:
    """skimage.structural_similarity semantics: uniform win, sample
    covariance (N/(N-1)), mean over the valid region, channels averaged.

    pred, gt: (h, w) or (h, w, c).
    """
    if pred.ndim == 3:
        return float(np.mean([
            ssim(pred[..., c], gt[..., c], data_range, win_size, k1, k2)
            for c in range(pred.shape[-1])]))
    x = pred.astype(np.float64)
    y = gt.astype(np.float64)
    np_ = win_size ** 2
    cov_norm = np_ / (np_ - 1)

    ux = _uniform_filter(x, win_size)
    uy = _uniform_filter(y, win_size)
    uxx = _uniform_filter(x * x, win_size)
    uyy = _uniform_filter(y * y, win_size)
    uxy = _uniform_filter(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    a1 = 2 * ux * uy + c1
    a2 = 2 * vxy + c2
    b1 = ux ** 2 + uy ** 2 + c1
    b2 = vx + vy + c2
    s = (a1 * a2) / (b1 * b2)
    return float(s.mean())


class LPIPSVGG:
    """LPIPS(VGG16) perceptual distance (Zhang et al., CVPR'18).

    Reads the JAX package's `.npz` layout (scripts/convert_lpips_weights.py
    writes it): conv{i}_w (3, 3, in, out) HWIO and conv{i}_b for the 13
    convolutions, lin{i}_w for the 5 stage heads, and the input `shift`
    and `scale`. `maybe_create` returns None when no weights are given,
    so evaluators skip the metric."""

    # Per-stage convolution counts and channels (VGG16 relu1_2 ..
    # relu5_3).
    _STAGES = (2, 2, 3, 3, 3)
    CHANNELS = (64, 128, 256, 512, 512)

    def __init__(self, weights_npz: str, device=None):
        dev = torch.device(device or "cpu")
        with np.load(weights_npz) as data:
            t = {k: torch.as_tensor(data[k], dtype=torch.float32,
                                    device=dev) for k in data.files}
        self.conv_w = [t[f"conv{i}_w"].permute(3, 2, 0, 1).contiguous()
                       for i in range(13)]                # OIHW
        self.conv_b = [t[f"conv{i}_b"] for i in range(13)]
        self.lin_w = [t[f"lin{i}_w"].reshape(-1) for i in range(5)]
        self.shift = t["shift"].reshape(1, 3, 1, 1)
        self.scale = t["scale"].reshape(1, 3, 1, 1)
        self.device = dev

    @classmethod
    def maybe_create(cls, weights_npz=None, device=None):
        path = weights_npz or os.environ.get("BTS_LPIPS_WEIGHTS")
        if path and os.path.exists(path):
            return cls(path, device)
        logging.getLogger("bts_torch.eval").warning(
            "LPIPS weights unavailable (%s) — reporting PSNR/SSIM only. "
            "Convert with scripts/convert_lpips_weights.py and pass "
            "lpips_weights or set BTS_LPIPS_WEIGHTS.",
            path or "no path given")
        return None

    def features(self, x, num_stages: int = 5):
        """VGG16 stage activations (relu1_2 .. relu5_3) of x (n, 3, h, w)
        in [-1, 1], of the first `num_stages` stages: 3x3 convolutions
        with SAME padding, 2x2 VALID max pools between stages. Returns a
        list of NCHW tensors."""
        h = (x - self.shift) / self.scale
        feats, ci = [], 0
        for stage, n_convs in enumerate(self._STAGES[:num_stages]):
            for _ in range(n_convs):
                h = torch.relu(F.conv2d(h, self.conv_w[ci], self.conv_b[ci],
                                        padding=1))
                ci += 1
            feats.append(h)
            if stage < len(self._STAGES) - 1:
                h = F.max_pool2d(h, 2, 2)
        return feats

    @torch.no_grad()
    def __call__(self, pred: np.ndarray, gt: np.ndarray) -> float:
        """pred, gt: (h, w, 3) in [0, 1]."""
        def prep(img):
            x = torch.as_tensor(np.asarray(img), dtype=torch.float32,
                                device=self.device)
            return x.permute(2, 0, 1)[None] * 2 - 1
        total = 0.0
        for xa, xb, w in zip(self.features(prep(pred)),
                             self.features(prep(gt)), self.lin_w):
            na = xa / (torch.linalg.vector_norm(xa, dim=1, keepdim=True)
                       + 1e-10)
            nb = xb / (torch.linalg.vector_norm(xb, dim=1, keepdim=True)
                       + 1e-10)
            d = (na - nb) ** 2 * w.reshape(1, -1, 1, 1)
            total += float(d.sum(1).mean())
        return total
