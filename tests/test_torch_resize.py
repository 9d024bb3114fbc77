"""`png.resize_linear` against `cv2.resize(..., INTER_LINEAR)`, bit for
bit, on random float32 and float64 images with 1-4 channels: enlarging,
shrinking and mixed (the BEV profile's 180 x 180 -> 192 x 640 in
`gen_vid_seq`). OpenCV 5 hands 1-, 3- and 4-channel float images to
Intel IPP and 2-channel ones to its own code; the port computes each as
that code does (`datasets/png.py`)."""
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from behindthescenes_tpu_torch.datasets import png

torch.set_num_threads(1)

SIZES = [((40, 60), (192, 640)),      # enlarge
         ((376, 1241), (192, 640)),   # shrink (KITTI's frames)
         ((150, 500), (192, 640)),    # grow y, shrink x
         ((180, 180), (192, 640))]    # the profile's resize


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("src,dst", SIZES)
def test_resize_linear_bit_equal_to_opencv(src, dst, channels, dtype):
    rng = np.random.default_rng(sum(src) + sum(dst) + channels)
    shape = src + ((channels,) if channels > 1 else ())
    img = rng.random(shape).astype(dtype)
    want = cv2.resize(img, (dst[1], dst[0]),
                      interpolation=cv2.INTER_LINEAR)
    got = png.resize_linear(img, dst)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("width", [48, 54, 60, 150, 200, 300, 400])
def test_resize_linear_clamped_column_runs(width, channels):
    """Runs of 4 to 33 clamped columns at each edge (a 6-column source):
    IPP rounds some of their vertical lerps twice, by blocks of 16
    columns and a remainder of at least 5."""
    rng = np.random.default_rng(width + channels)
    img = rng.random((40, 6, channels)).astype(np.float32)
    want = cv2.resize(img, (width, 77), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(png.resize_linear(img, (77, width)), want)


def test_fma_rounds_once():
    """`png.fma` against exact rational arithmetic in both precisions,
    including near-cancellations."""
    from fractions import Fraction
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal(400) for _ in range(3))
    c[:100] = -(a[:100] * b[:100])
    got = png.fma(a, b, c)
    for i in range(len(a)):
        exact = Fraction(a[i]) * Fraction(b[i]) + Fraction(c[i])
        assert got[i] == float(exact)
    a32, b32, c32 = (v.astype(np.float32) for v in (a, b, c))
    got32 = png.fma(a32, b32, c32, np.float32)
    for i in range(len(a)):
        exact = (Fraction(float(a32[i])) * Fraction(float(b32[i]))
                 + Fraction(float(c32[i])))
        below = np.nextafter(got32[i], np.float32(-np.inf))
        above = np.nextafter(got32[i], np.float32(np.inf))
        err = abs(Fraction(float(got32[i])) - exact)
        assert err <= abs(Fraction(float(below)) - exact)
        assert err <= abs(Fraction(float(above)) - exact)


def test_resize_linear_refuses_other_types():
    with pytest.raises(ValueError, match="float32 or float64"):
        png.resize_linear(np.zeros((4, 4), np.uint8), (8, 8))
