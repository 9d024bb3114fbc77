"""The port's JPEG reader and writer (behindthescenes_tpu_torch/datasets/
jpeg.py) against OpenCV's libjpeg-turbo: every file here is written by
cv2.imwrite / cv2.imencode, and read_jpeg must equal cv2.imread (BGR ->
RGB) bit for bit; progressive files raise; files that write_jpeg writes
decode in cv2 bit-equal to read_jpeg, close to their source."""
import cv2
import numpy as np
import pytest
import torch

from behindthescenes_tpu_torch.datasets import jpeg
from behindthescenes_tpu_torch.datasets.gen_synthetic_kitti_360 import (
    build_scene, make_calibs, pinhole_dirs, render_image)

# One intra-op thread: pytest-xdist runs several workers on this CPU,
# and torch's default of a thread per core makes every small op wait
# on threads that the other workers have swapped out.
torch.set_num_threads(1)


def _noise(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 255, shape,
                                                dtype=np.uint8)


def _street(h=96, w=320):
    """A frame of the synthetic street (gen_synthetic_kitti_360's scene),
    uint8 BGR as cv2 writes it."""
    calibs = make_calibs(h, w, 64, 64)
    boxes = build_scene(np.random.default_rng(3), 30.0)
    c2w = np.eye(4)
    c2w[:3, :3] = calibs["cam_to_pose"]["image_00"][:3, :3]
    rgb, _, _ = render_image(c2w, pinhole_dirs(calibs["k_px"], h, w), boxes)
    return np.clip(rgb * 255.0, 0, 255).astype(np.uint8)[..., ::-1].copy()


def _assert_reads_like_cv2(path):
    want = cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1]
    got = jpeg.read_jpeg(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


# name -> (image made from a seed, imwrite parameters)
CASES = {
    "kitti_raw_noise_375x1242": (lambda: _noise((375, 1242, 3)), []),
    "re10k_noise_72x128": (lambda: _noise((72, 128, 3), 1), []),
    "street_96x320": (_street, []),
    "odd_1x1": (lambda: _noise((1, 1, 3), 2), []),
    "odd_17x33": (lambda: _noise((17, 33, 3), 3), []),
    "grey_40x50": (lambda: _noise((40, 50), 4), []),
    "444": (lambda: _noise((37, 61, 3), 5),
            [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
             cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]),
    "422": (lambda: _noise((37, 61, 3), 6),
            [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
             cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422]),
    "q50": (lambda: _street(45, 70), [cv2.IMWRITE_JPEG_QUALITY, 50]),
    "q75": (lambda: _noise((45, 70, 3), 7), [cv2.IMWRITE_JPEG_QUALITY, 75]),
    "q95": (lambda: _noise((45, 70, 3), 8), [cv2.IMWRITE_JPEG_QUALITY, 95]),
    "q100": (lambda: _noise((45, 70, 3), 9),
             [cv2.IMWRITE_JPEG_QUALITY, 100]),
    "restart_3": (lambda: _noise((45, 70, 3), 10),
                  [cv2.IMWRITE_JPEG_RST_INTERVAL, 3]),
    "restart_1_street": (lambda: _street(40, 72),
                         [cv2.IMWRITE_JPEG_RST_INTERVAL, 1]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_read_jpeg_equals_cv2_imread(name, tmp_path):
    make, params = CASES[name]
    img = make()
    path = tmp_path / f"{name}.jpg"
    assert cv2.imwrite(str(path), img, params)
    got = _assert_reads_like_cv2(path)
    if img.ndim == 2:
        assert (got[..., 0] == got[..., 1]).all() and \
            (got[..., 0] == got[..., 2]).all()


def test_restart_markers_are_in_the_file(tmp_path):
    """The restart cases do reach the RSTn path: the file has a DRI
    segment and RST markers."""
    path = tmp_path / "rst.jpg"
    cv2.imwrite(str(path), _noise((45, 70, 3)),
                [cv2.IMWRITE_JPEG_RST_INTERVAL, 3])
    data = path.read_bytes()
    assert b"\xff\xdd" in data and b"\xff\xd0" in data
    _assert_reads_like_cv2(path)


def test_progressive_raises_with_the_file_name(tmp_path):
    path = tmp_path / "progressive.jpg"
    cv2.imwrite(str(path), _noise((40, 56, 3)),
                [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match="progressive.jpg.*progressive"):
        jpeg.read_jpeg(path)


def test_other_files_raise(tmp_path):
    """Not a JPEG, and a baseline header turned into an arithmetic-coded
    or a 12-bit one, raise instead of returning an image."""
    ok, buf = cv2.imencode(".jpg", _noise((16, 16, 3)))
    data = bytearray(buf.tobytes())
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_jpeg(b"\x89PNG\r\n", "x.png")
    sof = data.index(b"\xff\xc0")
    arith = bytearray(data)
    arith[sof + 1] = 0xC9
    with pytest.raises(ValueError, match="arithmetic"):
        jpeg.decode_jpeg(bytes(arith), "a.jpg")
    twelve = bytearray(data)
    twelve[sof + 4] = 12
    with pytest.raises(ValueError, match="12-bit"):
        jpeg.decode_jpeg(bytes(twelve), "b.jpg")


def test_idct_range_limit_table():
    """jdmaster.c's post-IDCT table read through & 1023: the identity
    (shifted by 128) on [-128, 127], 255 up to 511, the wrap to 0 on
    [512, 895] and on [-512, -129], and so on around the 1024 cycle."""
    pieces = ((-1024, -897, lambda x: x + 1152), (-896, -513, 255),
              (-512, -129, 0), (-128, 127, lambda x: x + 128),
              (128, 511, 255), (512, 895, 0), (896, 1023, lambda x: x - 896))
    for lo, hi, value in pieces:
        x = np.arange(lo, hi + 1)
        want = value(x) if callable(value) else np.full(x.shape, value)
        np.testing.assert_array_equal(
            jpeg._RANGE_LIMIT[x & 1023].astype(np.int64), want)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


@pytest.mark.parametrize("case", ["noise_q95", "checker_q100",
                                  "binary_noise_q20"])
def test_idct_output_stays_in_the_clamp_range(case):
    """On these files the IDCT's outputs stay in [-512, 511], where
    jdmaster.c's wrapping table and the saturation of libjpeg-turbo's
    SIMD IDCT give the same samples: that the two agree here is why the
    bit-equal tests cannot tell them apart."""
    rng = np.random.default_rng(0)
    img, quality = {
        "noise_q95": (_noise((375, 1242, 3)), 95),
        "checker_q100": ((np.indices((64, 64)).sum(0) % 2 * 255)
                         .astype(np.uint8)[..., None].repeat(3, 2), 100),
        "binary_noise_q20": ((rng.integers(0, 2, (200, 200, 3)) * 255)
                             .astype(np.uint8), 20)}[case]
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])
    frame, comps, qtables, scans = jpeg._parse(buf.tobytes(), case)
    grids, _ = jpeg._decode_coefficients(frame, comps, scans, case)
    for g, c in zip(grids, comps):
        raw = jpeg.idct_islow_raw(g, qtables[c.tq])
        assert raw.min() >= -512 and raw.max() <= 511, (raw.min(), raw.max())


@pytest.mark.parametrize("shape", [(375, 1242), (96, 320), (37, 61),
                                   (1, 1)])
def test_write_jpeg_reads_back(shape, tmp_path):
    """A file of write_jpeg is a baseline 4:2:0 JPEG that cv2 decodes
    bit-equal to read_jpeg, as close to its source as cv2's own q95 file
    (4:2:0 too) within 0.1 dB, and above 40 dB PSNR at KITTI raw's
    375x1242 (the 4:2:0 chroma of the box edges keeps smaller street
    frames under that: 36.4 dB at 96x320, cv2's file as well)."""
    bgr = _street(*shape)
    rgb = bgr[..., ::-1].copy()
    path = tmp_path / "w.jpg"
    jpeg.write_jpeg(path, rgb)
    data = path.read_bytes()
    assert data[:2] == b"\xff\xd8" and b"\xff\xc0" in data
    got = _assert_reads_like_cv2(path)
    ok, buf = cv2.imencode(".jpg", bgr)
    cv2_psnr = _psnr(cv2.imdecode(buf, cv2.IMREAD_COLOR)[..., ::-1], rgb)
    assert _psnr(got, rgb) > cv2_psnr - 0.1, (_psnr(got, rgb), cv2_psnr)
    if shape == (375, 1242):
        assert _psnr(got, rgb) > 40.0


def test_write_jpeg_quality_tables():
    """The quantisation tables of jcparam.c at qualities 50, 75, 95."""
    assert (jpeg.quality_table(jpeg._STD_LUMA_Q, 50)
            == jpeg._STD_LUMA_Q).all()
    assert jpeg.quality_table(jpeg._STD_LUMA_Q, 95)[0] == 2
    assert jpeg.quality_table(jpeg._STD_CHROMA_Q, 75)[0] == 9
    assert jpeg.quality_table(jpeg._STD_LUMA_Q, 100).max() == 1
