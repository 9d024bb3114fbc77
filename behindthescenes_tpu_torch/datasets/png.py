"""PNG reading and writing on the standard library's zlib, and the two
image resizes of OpenCV that the KITTI-360 loader uses.

The GPU machine has no OpenCV, so the port reads and writes its images
here (no JAX counterpart; the JAX package calls cv2):
- `read_png` reads 8-bit grey and RGB, non-interlaced, with any of the
  five row filters (OpenCV's writer picks them row by row, Paeth
  included), as `cv2.imread` gives them with the channels in RGB order;
- `write_png` writes the same kinds, every row with filter 0 (none);
- `resize_linear` is `cv2.resize(..., INTER_LINEAR)` on float32 images:
  half-pixel centres, edge clamp, no antialias when shrinking, the
  weights in float32 (OpenCV's fixed point applies to 8-bit images only)
  and each pass a fused lerp;
- `resize_nearest` is `cv2.resize(..., INTER_NEAREST)`: the source index
  of a destination index d is floor(d * src / dst), clamped (not the
  pixel centre).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> samples per pixel: grey and RGB.
_CHANNELS = {0: 1, 2: 3}
# zlib level of the writer: the trees it writes are rewritten often and
# read once, so speed comes before size.
_LEVEL = 1


def _chunks(data: bytes, path):
    """(type, body) of each chunk after the signature, up to IEND."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: no IEND chunk")


def _unfilter_sequential(kind: int, cur: list, prev: list, bpp: int):
    """Average (3) and Paeth (4) rows, in place: each byte needs the one
    reconstructed bpp bytes before it."""
    for i in range(bpp):
        cur[i] = (cur[i] + (prev[i] >> 1 if kind == 3 else prev[i])) & 255
    for i in range(bpp, len(cur)):
        a, b = cur[i - bpp], prev[i]
        if kind == 3:
            cur[i] = (cur[i] + ((a + b) >> 1)) & 255
            continue
        c = prev[i - bpp]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 255
    return cur


def _unfilter(kinds: np.ndarray, rows: np.ndarray, bpp: int) -> np.ndarray:
    """The image bytes (h, stride) of filtered rows (h, stride)."""
    out = np.empty_like(rows)
    prev = np.zeros(rows.shape[1], np.uint8)
    for y, kind in enumerate(kinds.tolist()):
        row = rows[y]
        if kind == 0:
            out[y] = row
        elif kind == 1:     # Sub: a running sum per channel, modulo 256
            out[y] = np.cumsum(row.reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif kind == 2:     # Up
            out[y] = row + prev
        elif kind in (3, 4):
            out[y] = _unfilter_sequential(kind, row.tolist(), prev.tolist(),
                                          bpp)
        else:
            raise ValueError(f"PNG row filter {kind}")
        prev = out[y]
    return out


def read_png(path) -> np.ndarray:
    """An 8-bit grey (h, w) or RGB (h, w, 3) non-interlaced PNG as uint8;
    any other kind raises ValueError."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, compression, filtering, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace or compression \
            or filtering:
        raise ValueError(f"{path}: bit depth {depth}, colour type {color}, "
                         f"interlace {interlace}: only 8-bit grey and RGB, "
                         "non-interlaced, are read")
    bpp = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data for "
                         f"{h}x{w}x{bpp}")
    rows = raw.reshape(h, w * bpp + 1)
    img = _unfilter(rows[:, 0], rows[:, 1:], bpp)
    return img.reshape(h, w) if bpp == 1 else img.reshape(h, w, 3)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path, img: np.ndarray) -> None:
    """Write uint8 grey (h, w) or RGB (h, w, 3) as a PNG, every row with
    filter 0."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"write_png takes uint8 (h, w) or (h, w, 3), not "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)],
                          axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 0 if img.ndim == 2 else 2,
                         0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), _LEVEL))
                + _chunk(b"IEND", b""))


def _linear_taps(dst: int, src: int):
    """OpenCV's INTER_LINEAR taps along one axis: (i0, i1, w), the source
    position in float64, the weight of i1 then rounded to float32, edges
    clamped to i0 with weight 0."""
    scale = 1.0 / (dst / src)
    f = (np.arange(dst) + 0.5) * scale - 0.5
    i0 = np.floor(f).astype(np.int64)
    frac = f - i0
    edge = (i0 < 0) | (i0 >= src - 1)
    i0 = np.clip(i0, 0, src - 1)
    frac[edge] = 0.0
    return i0, np.minimum(i0 + 1, src - 1), frac.astype(np.float32)


def _lerp(a, b, w):
    """a + (b - a) * w in float32 with one rounding of the product and the
    sum, as OpenCV's fused multiply-add (the product of two float32 values
    is exact in float64)."""
    return (a + (b - a).astype(np.float64) * w).astype(np.float32)


def resize_linear(img: np.ndarray, size) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=INTER_LINEAR) of a float32
    image (h0, w0[, c]) with at least two rows and columns to size =
    (h, w): each row first, then each column, each a float32 lerp of two
    taps (bit-equal to OpenCV 5's)."""
    img = np.asarray(img)
    if img.dtype != np.float32:
        raise ValueError("resize_linear takes float32 images (OpenCV "
                         "rounds 8-bit ones in fixed point)")
    h, w = size
    x0, x1, wx = _linear_taps(w, img.shape[1])
    y0, y1, wy = _linear_taps(h, img.shape[0])
    extra = (None,) * (img.ndim - 2)
    rows = _lerp(img[:, x0], img[:, x1], wx[(None, slice(None)) + extra])
    return _lerp(rows[y0], rows[y1], wy[(slice(None), None) + extra])


def _nearest_index(dst: int, src: int) -> np.ndarray:
    return np.minimum(np.floor(np.arange(dst) * (1.0 / (dst / src)))
                      .astype(np.int64), src - 1)


def resize_nearest(img: np.ndarray, size) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=INTER_NEAREST) to size =
    (h, w), any dtype."""
    h, w = size
    return img[_nearest_index(h, img.shape[0])][:, _nearest_index(
        w, img.shape[1])]
