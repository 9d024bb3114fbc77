"""Image processors that define the supervision signal (counterpart of
behindthescenes_tpu/models/image_processor.py:15-23, 80-90): encoder
images (n, v, h, w, 3) in [-1, 1] -> the channels the loss compares."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RGBProcessor:
    """[-1, 1] -> [0, 1] RGB (reference image_processor.py:22-29)."""
    channels: int = 3

    def __call__(self, images):
        return images * 0.5 + 0.5


def make_image_processor(conf: dict):
    """Factory (reference image_processor.py:9-19); the rgb type."""
    ptype = conf.get("type", "rgb").lower()
    if ptype == "rgb":
        return RGBProcessor()
    if ptype in ("patch", "perceptual"):
        raise NotImplementedError(
            f"the {ptype} image processor is not ported (ROADMAP Queue A "
            "item 5)")
    raise NotImplementedError(f"Unsupported image processor: {ptype}")
