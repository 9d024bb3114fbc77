"""Motion-JPEG video in an AVI container, with the standard library and
the port's numpy JPEG codec (datasets/jpeg.py), for the video scripts.

Counterpart of behindthescenes_tpu/utils/io.py:32-41 (`write_video`),
which writes mp4v through `cv2.VideoWriter`; the GPU machine has no
OpenCV and no video encoder, so the port writes `.avi` files instead:
- a RIFF `AVI ` file: `hdrl` with the main header (`avih`) and one video
  stream (`strl`: `strh` of type `vids`, handler `MJPG`; `strf`, a
  BITMAPINFOHEADER with compression `MJPG`), then `movi` with one `00dc`
  chunk a frame (a baseline JPEG), then the `idx1` index, its offsets
  taken from the `movi` list's type, as OpenCV's own MJPEG writer sets
  them (every frame a key frame);
- the frames are quantised as the JAX package's `write_video` does:
  `(np.clip(f, 0, 1) * 255).astype(np.uint8)`.
OpenCV reads such a file with its built-in reader
(`cv2.VideoCapture(path, cv2.CAP_OPENCV_MJPEG)`); `read_video` reads it
back here through the port's JPEG decoder.
"""
from __future__ import annotations

import struct

import numpy as np

from behindthescenes_tpu_torch.datasets.jpeg import decode_jpeg, encode_jpeg

_JPEG_QUALITY = 95      # each frame's JPEG quality (jpeg.encode_jpeg)
_AVIF_HASINDEX = 0x10
_AVIIF_KEYFRAME = 0x10
_RIFF_LIMIT = 2 ** 31  # a plain AVI 1.0 file (no OpenDML extension)


def _chunk(fourcc: bytes, body: bytes) -> bytes:
    """A RIFF chunk: id, little-endian size, body padded to even length."""
    return fourcc + struct.pack("<I", len(body)) + body \
        + (b"\0" if len(body) & 1 else b"")


def _list(kind: bytes, body: bytes) -> bytes:
    return _chunk(b"LIST", kind + body)


def quantise(frame) -> np.ndarray:
    """An RGB float frame in [0, 1] as the uint8 pixels written: clipped,
    scaled by 255 and truncated (the JAX package's write_video)."""
    frame = np.asarray(frame)
    if frame.ndim != 3 or frame.shape[2] != 3:
        raise ValueError(f"a frame is RGB (h, w, 3), not {frame.shape}")
    return (np.clip(frame, 0, 1) * 255).astype(np.uint8)


def encode_avi(frames, fps: int = 10) -> bytes:
    """RGB float frames (h, w, 3) in [0, 1] -> the bytes of a Motion-JPEG
    AVI at `fps` frames a second."""
    jpegs = [encode_jpeg(quantise(f), _JPEG_QUALITY) for f in frames]
    if not jpegs:
        raise ValueError("a video needs at least one frame")
    h, w = quantise(frames[0]).shape[:2]
    n = len(jpegs)
    biggest = max(len(j) for j in jpegs)
    avih = struct.pack("<14I", round(1e6 / fps), biggest * fps, 0,
                       _AVIF_HASINDEX, n, 0, 1, biggest, w, h, 0, 0, 0, 0)
    strh = (b"vidsMJPG" + struct.pack("<IHHIIIIIIII", 0, 0, 0, 0, 1, fps,
                                      0, n, biggest, 0xFFFFFFFF, 0)
            + struct.pack("<4h", 0, 0, w, h))
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG",
                       w * h * 3, 0, 0, 0, 0)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih) + _list(
        b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))
    movi_body, index = [], []
    offset = 4                        # from the `movi` type's first byte
    for jpeg in jpegs:
        chunk = _chunk(b"00dc", jpeg)
        index.append(struct.pack("<4sIII", b"00dc", _AVIIF_KEYFRAME,
                                 offset, len(jpeg)))
        movi_body.append(chunk)
        offset += len(chunk)
    body = (b"AVI " + hdrl + _list(b"movi", b"".join(movi_body))
            + _chunk(b"idx1", b"".join(index)))
    if len(body) + 8 > _RIFF_LIMIT:
        raise ValueError(f"{n} frames make {len(body)} bytes, over a plain "
                         f"AVI's {_RIFF_LIMIT}")
    return _chunk(b"RIFF", body)


def write_video(path: str, frames, fps: int = 10) -> None:
    """frames: RGB float (h, w, 3) in [0, 1]; written to `path` as a
    Motion-JPEG AVI (the JAX package writes mp4v: see the module
    docstring)."""
    data = encode_avi(list(frames), fps)
    with open(path, "wb") as f:
        f.write(data)


def _chunks(data: bytes, start: int, end: int, path):
    while start + 8 <= end:
        fourcc = data[start:start + 4]
        size = struct.unpack_from("<I", data, start + 4)[0]
        if start + 8 + size > end:
            raise ValueError(f"{path}: chunk {fourcc!r} at {start} runs "
                             f"past its parent")
        yield fourcc, start + 8, size
        start += 8 + size + (size & 1)


def read_avi(data: bytes, path="<bytes>") -> np.ndarray:
    """A Motion-JPEG AVI's frames as uint8 RGB (n, h, w, 3): the `movi`
    list's `00dc` chunks in order, after a check that the stream header
    (`strh`) is Motion-JPEG video."""
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path}: not a RIFF AVI file")
    end = min(len(data), 8 + struct.unpack_from("<I", data, 4)[0])
    mjpeg, frames = False, []
    for fourcc, at, size in _chunks(data, 12, end, path):
        if fourcc != b"LIST":
            continue
        kind = data[at:at + 4]
        if kind == b"hdrl":
            for sub, sat, ssize in _chunks(data, at + 4, at + size, path):
                if sub == b"LIST" and data[sat:sat + 4] == b"strl":
                    for leaf, lat, _ in _chunks(data, sat + 4, sat + ssize,
                                                path):
                        if leaf == b"strh":
                            if data[lat:lat + 8] != b"vidsMJPG":
                                raise ValueError(
                                    f"{path}: stream {data[lat:lat + 8]!r}"
                                    f" is not Motion-JPEG video")
                            mjpeg = True
        elif kind == b"movi":
            for sub, sat, ssize in _chunks(data, at + 4, at + size, path):
                if sub == b"00dc":
                    frames.append(decode_jpeg(data[sat:sat + ssize], path))
    if not mjpeg or not frames:
        raise ValueError(f"{path}: no Motion-JPEG stream or no frames")
    return np.stack(frames)


def read_video(path: str) -> np.ndarray:
    """The frames of a Motion-JPEG AVI as uint8 RGB (n, h, w, 3), decoded
    by the port's JPEG decoder (as `cv2.imread` decodes a JPEG)."""
    with open(path, "rb") as f:
        return read_avi(f.read(), path)
