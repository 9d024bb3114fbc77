"""PNG reading and writing on the standard library's zlib, and the two
image resizes of OpenCV that the KITTI-360 loader uses.

The GPU machine has no OpenCV, so the port reads and writes its images
here (no JAX counterpart; the JAX package calls cv2):
- `read_png` reads 8- and 16-bit grey and RGB, non-interlaced, with any
  of the five row filters (OpenCV's writer picks them row by row, Paeth
  included), as `cv2.imread(path, cv2.IMREAD_UNCHANGED)` gives them with
  the channels in RGB order;
- `write_png` writes the same kinds, every row with filter 0 (none);
- `resize_linear` is `cv2.resize(..., INTER_LINEAR)` on float32 and
  float64 images, bit-equal: half-pixel centres, edge clamp, no
  antialias when shrinking; 1, 3 and 4 channels as the Intel IPP that
  OpenCV 5 calls computes them (fused lerps), 2 channels as OpenCV's own
  code does (OpenCV's fixed point applies to 8-bit images only);
- `resize_linear_u8` is `cv2.resize(..., INTER_LINEAR)` on uint8 images,
  in OpenCV's fixed point (11-bit weights and its vertical pass's
  truncations);
- `read_png_color` reads as `cv2.imread(path)` (IMREAD_COLOR) does: three
  8-bit channels, grey replicated, 16-bit samples cut to their high byte;
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
    """A grey (h, w) or RGB (h, w, 3) non-interlaced PNG as uint8 (8-bit)
    or uint16 (16-bit); any other kind raises ValueError."""
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
    if depth not in (8, 16) or color not in _CHANNELS or interlace \
            or compression or filtering:
        raise ValueError(f"{path}: bit depth {depth}, colour type {color}, "
                         f"interlace {interlace}: only 8- and 16-bit grey "
                         "and RGB, non-interlaced, are read")
    channels = _CHANNELS[color]
    bpp = channels * depth // 8          # filters work on whole pixels
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data for "
                         f"{h}x{w}x{bpp}")
    rows = raw.reshape(h, w * bpp + 1)
    img = _unfilter(rows[:, 0], rows[:, 1:], bpp)
    if depth == 16:
        img = img.view(">u2").astype(np.uint16)
    return img.reshape(h, w) if channels == 1 else img.reshape(h, w, 3)


def read_png_color(path) -> np.ndarray:
    """`cv2.imread(path)` of a PNG with its channels in RGB order: uint8
    (h, w, 3); grey is replicated to three channels and a 16-bit sample
    keeps its high byte (libpng's strip_16)."""
    img = read_png(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    return np.repeat(img[..., None], 3, axis=2) if img.ndim == 2 else img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path, img: np.ndarray) -> None:
    """Write uint8 or uint16 grey (h, w) or RGB (h, w, 3) as an 8- or
    16-bit PNG, every row with filter 0."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16) or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"write_png takes uint8 or uint16 (h, w) or (h, w, "
                         f"3), not {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    depth = 8 * img.dtype.itemsize
    data = img.astype(">u2").view(np.uint8) if depth == 16 else img
    rows = np.concatenate([np.zeros((h, 1), np.uint8), data.reshape(h, -1)],
                          axis=1)
    header = struct.pack(">IIBBBBB", w, h, depth,
                         0 if img.ndim == 2 else 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), _LEVEL))
                + _chunk(b"IEND", b""))


_SPLIT = np.float64(2 ** 27 + 1)  # Veltkamp's splitter for float64


def _two_sum(a, b):
    """s, e with s = fl(a + b) and s + e = a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """p, e with p = fl(a * b) and p + e = a * b exactly (Dekker)."""
    p = a * b
    t = _SPLIT * a
    ah = t - (t - a)
    t = _SPLIT * b
    bh = t - (t - b)
    al, bl = a - ah, b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _sum_odd(a, b):
    """a + b in float64 rounded to odd: an inexact sum takes the
    neighbour whose last bit is 1 (Boldo and Melquiond), so that one more
    rounding lands where a single rounding of the exact sum would."""
    s, e = _two_sum(a, b)
    fix = (e != 0) & ((s.view(np.int64) & 1) == 0)
    return np.where(fix, np.nextafter(s, np.where(e > 0, np.inf, -np.inf)),
                    s)


def fma(a, b, c, dtype=np.float64) -> np.ndarray:
    """a * b + c rounded once to `dtype` (float32 or float64), as a fused
    multiply-add computes it, in numpy float64 arithmetic."""
    a, b, c = np.broadcast_arrays(*(np.asarray(v, np.float64)
                                    for v in (a, b, c)))
    if np.dtype(dtype) == np.float32:
        return _sum_odd(a * b, c).astype(np.float32)   # a * b is exact
    ph, pl = _two_prod(a, b)
    th, tl = _two_sum(c, ph)
    return th + _sum_odd(pl, tl)


def _ipp_taps(dst: int, src: int, dtype):
    """IPP's taps along one axis: (i0, i1, w, clamped). The position (d +
    0.5) * (src / dst) - 0.5 is float64, fused for float64 images; the
    weight w of i1 is its fraction, rounded to float32 for float32
    images; positions outside [0, src - 1] read their edge with w = 0."""
    d = np.arange(dst) + 0.5
    if dtype == np.float64:
        p = fma(d, src / dst, -0.5)
    else:
        p = d * (src / dst) - 0.5
    i0 = np.floor(p).astype(np.int64)
    w = p - i0
    clamped = (i0 < 0) | (i0 >= src - 1)
    w[clamped] = 0
    i0 = np.clip(i0, 0, src - 1)
    return i0, np.minimum(i0 + 1, src - 1), w.astype(dtype), clamped


def _ipp_lerp(a, b, w):
    """a + (b - a) * w with one rounding of the product and the sum."""
    return fma(b - a, w, a, a.dtype)


def _ipp_split_edges(run: int, channels: int) -> np.ndarray:
    """Which samples of a run of `run` clamped columns (left to right,
    at either edge) IPP's float32 vertical pass rounds twice, as (run,
    channels) booleans: its loop takes blocks of 16 columns (rounded
    twice with 4 channels, once with 3), then a remainder of 5 or more
    columns (twice, with 3 channels only in the first two); a shorter
    remainder, and every column with one channel, once."""
    split = np.zeros((run, channels), bool)
    if channels not in (3, 4):
        return split
    whole = run - run % 16
    if channels == 4:
        split[:whole] = True
    if run - whole >= 5:
        split[whole:, :2 if channels == 3 else 4] = True
    return split


def _resize_ipp(img: np.ndarray, size) -> np.ndarray:
    """cv2.resize's float INTER_LINEAR for 1, 3 and 4 channels, which
    OpenCV hands to Intel IPP: each row, then each column, a fused lerp;
    the clamped columns of the vertical pass as `_ipp_split_edges`."""
    h, w = size
    img3 = img.reshape(img.shape[:2] + (-1,))
    x0, x1, wx, clamped = _ipp_taps(w, img.shape[1], img.dtype)
    y0, y1, wy, _ = _ipp_taps(h, img.shape[0], img.dtype)
    rows = _ipp_lerp(img3[:, x0], img3[:, x1], wx[None, :, None])
    a, b = rows[y0], rows[y1]
    out = _ipp_lerp(a, b, wy[:, None, None])
    if img.dtype == np.float32:
        # Columns are clamped at each edge, never all (src >= 2).
        left, right = int(np.argmin(clamped)), int(np.argmin(clamped[::-1]))
        split = np.zeros((w, img3.shape[2]), bool)
        split[:left] = _ipp_split_edges(left, img3.shape[2])
        split[w - right:] = _ipp_split_edges(right, img3.shape[2])
        twice = (a + ((b - a) * wy[:, None, None]).astype(img.dtype)) \
            .astype(img.dtype)
        out = np.where(split[None], twice, out)
    return out.reshape((h, w) + img.shape[2:])


def _opencv_taps(dst: int, src: int, clamp: bool):
    """OpenCV's own taps along one axis: (i0, i1, w) with the position
    rounded to float32 and w, the weight of i1, its fraction there.
    Columns (`clamp`) read their edge with w = 0 outside [0, src - 1];
    rows keep their weight and clamp only the two source indices."""
    p = ((np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5) \
        .astype(np.float32)
    i0 = np.floor(p).astype(np.int64)
    w = (p - i0.astype(np.float32)).astype(np.float32)
    if clamp:
        w[(i0 < 0) | (i0 >= src - 1)] = 0
        i0 = np.clip(i0, 0, src - 1)
    return np.clip(i0, 0, src - 1), np.clip(i0 + 1, 0, src - 1), w


def _resize_opencv(img: np.ndarray, size) -> np.ndarray:
    """cv2.resize's float INTER_LINEAR in OpenCV's own code (2 channels):
    each pass a * (1 - w) + b * w with float32 weights, each product and
    the sum rounded in the image's type."""
    h, w = size
    x0, x1, wx = _opencv_taps(w, img.shape[1], True)
    y0, y1, wy = _opencv_taps(h, img.shape[0], False)

    def lerp(a, b, wt):
        w0 = (np.float32(1) - wt).astype(img.dtype)
        return a * w0 + b * wt.astype(img.dtype)

    rows = lerp(img[:, x0], img[:, x1], wx[None, :, None])
    return lerp(rows[y0], rows[y1], wy[:, None, None])


def resize_linear(img: np.ndarray, size) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=INTER_LINEAR) of a float32 or
    float64 image (h0, w0[, c]) with at least two rows and columns to
    size = (h, w), bit-equal to OpenCV 5 built with IPP: half-pixel
    centres, edge clamp, no antialias when shrinking; 1, 3 and 4 channels
    as IPP computes them (`_resize_ipp`), 2 as OpenCV's own code
    (`_resize_opencv`)."""
    img = np.asarray(img)
    if img.dtype not in (np.float32, np.float64):
        raise ValueError("resize_linear takes float32 or float64 images "
                         "(OpenCV rounds 8-bit ones in fixed point: "
                         "resize_linear_u8)")
    channels = img.shape[2] if img.ndim == 3 else 1
    if img.ndim not in (2, 3) or channels > 4 or min(img.shape[:2]) < 2:
        raise ValueError(f"resize_linear takes (h, w[, c <= 4]) images of "
                         f"at least 2 x 2, not {img.shape}")
    if channels == 2:
        return _resize_opencv(img, size)
    return _resize_ipp(img, size)


def _linear_taps_u8(dst: int, src: int, clamp: bool):
    """OpenCV's INTER_LINEAR taps of 8-bit images along one axis: (i0, i1,
    w0, w1) with the weights in 11-bit fixed point, each rounded from
    float32. The position is rounded to float32 too; columns (`clamp`)
    take weights (2048, 0) outside [0, src - 1], rows keep theirs and
    clamp only the two source indices."""
    f = ((np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5) \
        .astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    frac = (f - i0.astype(np.float32)).astype(np.float32)
    if clamp:
        edge = (i0 < 0) | (i0 >= src - 1)
        frac[edge] = 0
        i0 = np.clip(i0, 0, src - 1)
    w0 = np.rint((np.float32(1) - frac) * np.float32(2048)).astype(np.int64)
    w1 = np.rint(frac * np.float32(2048)).astype(np.int64)
    return np.clip(i0, 0, src - 1), np.clip(i0 + 1, 0, src - 1), w0, w1


def resize_linear_u8(img: np.ndarray, size) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=INTER_LINEAR) of a uint8
    image (h0, w0[, c]) to size = (h, w), bit-equal: each row in exact
    integers (pixel x 11-bit weight), then each column as OpenCV's
    vector path computes it, ((row >> 4) * weight) >> 16 for each of the
    two rows, summed, then (sum + 2) >> 2."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_linear_u8 takes uint8 images, not "
                         f"{img.dtype}")
    h, w = size
    x0, x1, a0, a1 = _linear_taps_u8(w, img.shape[1], True)
    y0, y1, b0, b1 = _linear_taps_u8(h, img.shape[0], False)
    extra = (None,) * (img.ndim - 2)
    along_x = (None, slice(None)) + extra
    along_y = (slice(None), None) + extra
    src = img.astype(np.int64)
    rows = src[:, x0] * a0[along_x] + src[:, x1] * a1[along_x]
    out = (((rows[y0] >> 4) * b0[along_y]) >> 16) \
        + (((rows[y1] >> 4) * b1[along_y]) >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)


def _nearest_index(dst: int, src: int) -> np.ndarray:
    return np.minimum(np.floor(np.arange(dst) * (1.0 / (dst / src)))
                      .astype(np.int64), src - 1)


def resize_nearest(img: np.ndarray, size) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=INTER_NEAREST) to size =
    (h, w), any dtype."""
    h, w = size
    return img[_nearest_index(h, img.shape[0])][:, _nearest_index(
        w, img.shape[1])]
