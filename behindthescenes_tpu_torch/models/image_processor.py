"""Image processors that define the supervision signal (counterpart of
behindthescenes_tpu/models/image_processor.py:14-90): encoder images (n,
v, h, w, 3) in [-1, 1] -> the channels the loss compares."""
from __future__ import annotations

import dataclasses

import torch

from behindthescenes_tpu_torch.evaluation.metrics import LPIPSVGG


@dataclasses.dataclass(frozen=True)
class RGBProcessor:
    """[-1, 1] -> [0, 1] RGB (reference image_processor.py:22-29)."""
    channels: int = 3

    def __call__(self, images):
        return images * 0.5 + 0.5


@dataclasses.dataclass(frozen=True)
class PatchProcessor:
    """Each pixel's p x p neighbourhood of [0, 1] RGB as channels, the
    edge padded by p // 2 (reference image_processor.py:69-93): the p^2
    shifted copies concatenated on the channel axis, row-major in the
    shift, 3 p^2 channels."""
    patch_size: int = 3

    @property
    def channels(self) -> int:
        return 3 * self.patch_size ** 2

    def __call__(self, images):
        n, v, h, w, c = images.shape
        p, r = self.patch_size, self.patch_size // 2
        x = (images * 0.5 + 0.5).reshape(n * v, h, w, c).permute(0, 3, 1, 2)
        x = torch.nn.functional.pad(x, (r, r, r, r), mode="replicate")
        x = x.permute(0, 2, 3, 1).reshape(n, v, h + 2 * r, w + 2 * r, c)
        return torch.cat([x[:, :, dy:dy + h, dx:dx + w]
                          for dy in range(p) for dx in range(p)], -1)


class PerceptualProcessor:
    """LPIPS-VGG activations as the supervision space (reference
    image_processor.py:32-66): the first `layers` VGG stages, each unit-
    normalised over its channels and resized to the image's size by the
    nearest index floor(i * in / out). Needs the LPIPS weights (the
    `.npz` that `evaluation/metrics.LPIPSVGG` reads); without them it
    raises, as the JAX package's does."""

    def __init__(self, layers: int = 1, weights=None):
        self._weights = weights
        self._vgg = LPIPSVGG.maybe_create(weights)
        if self._vgg is None:
            raise NotImplementedError(
                "perceptual image processor needs LPIPS-VGG weights: set "
                "BTS_LPIPS_WEIGHTS (scripts/convert_lpips_weights.py)")
        self._layers = layers
        self.channels = sum(LPIPSVGG.CHANNELS[:layers])

    def __call__(self, images):
        n, v, h, w, c = images.shape
        if self._vgg.device != images.device:
            self._vgg = LPIPSVGG.maybe_create(self._weights, images.device)
        x = images.reshape(n * v, h, w, c).permute(0, 3, 1, 2)
        outs = []
        for f in self._vgg.features(x, num_stages=self._layers):
            f = f / (torch.linalg.vector_norm(f, dim=1, keepdim=True)
                     + 1e-10)
            fh, fw = f.shape[2:]
            if (fh, fw) != (h, w):
                ys = (torch.arange(h, device=f.device) * (fh / h)).long()
                xs = (torch.arange(w, device=f.device) * (fw / w)).long()
                f = f[:, :, ys][:, :, :, xs]
            outs.append(f)
        out = torch.cat(outs, 1).permute(0, 2, 3, 1)
        return out.reshape(n, v, h, w, self.channels)


def make_image_processor(conf: dict):
    """Factory (reference image_processor.py:9-19)."""
    ptype = conf.get("type", "rgb").lower()
    if ptype == "rgb":
        return RGBProcessor()
    if ptype == "patch":
        return PatchProcessor(conf.get("patch_size", 3))
    if ptype == "perceptual":
        return PerceptualProcessor(conf.get("layers", 1),
                                   conf.get("weights"))
    raise NotImplementedError(f"Unsupported image processor: {ptype}")
