"""Image reading and writing without OpenCV (counterpart of
behindthescenes_tpu/utils/io.py:8-29, which calls cv2): PNG through
datasets/png.py and baseline JPEG through datasets/jpeg.py, with the
pixels `cv2.imread` / `cv2.imwrite` give and take. The compressed bytes
of a written file differ from OpenCV's; its pixels do not."""
from __future__ import annotations

import numpy as np

from behindthescenes_tpu_torch.datasets.jpeg import read_jpeg
from behindthescenes_tpu_torch.datasets.png import read_png, write_png

_PNG = b"\x89PNG"
_JPEG = b"\xff\xd8"


def read_image(path: str) -> np.ndarray:
    """An 8- or 16-bit grey or RGB PNG, or a baseline JPEG, as float32 in
    [0, 1]: (h, w, 3) RGB or (h, w) grey."""
    try:
        with open(path, "rb") as f:
            magic = f.read(4)
    except FileNotFoundError:
        raise FileNotFoundError(path) from None
    if magic.startswith(_PNG):
        img = read_png(path)
    elif magic.startswith(_JPEG):
        img = read_jpeg(path)
    else:
        raise ValueError(f"{path}: neither PNG nor JPEG")
    if img.dtype == np.uint16:
        return img.astype(np.float32) / 65535.0
    return img.astype(np.float32) / 255.0


def write_image(path: str, img: np.ndarray, bit16: bool = False) -> None:
    """img: RGB (h, w, 3) or grey (h, w) floats in [0, 1], written as an 8-
    or 16-bit PNG (values clipped, then truncated as astype truncates)."""
    if not str(path).lower().endswith(".png"):
        raise ValueError(f"{path}: write_image writes PNG files only")
    img = np.clip(np.asarray(img), 0, 1)
    out = (img * 65535).astype(np.uint16) if bit16 \
        else (img * 255).astype(np.uint8)
    write_png(path, out)
