"""The port's training data pipeline against the JAX package and OpenCV: the
loader's batch order (shuffle, drop_last, seed, epochs) against the JAX
DataLoader; the bilinear remap against cv2.remap; the colour jitter
against the JAX package's cv2-based one; the float RGB <-> HSV conversions
against cv2.cvtColor.
"""
import cv2
import numpy as np
import pytest

from behindthescenes_tpu.datasets.augmentation import \
    sample_color_jitter as jax_jitter
from behindthescenes_tpu.datasets.loader import DataLoader as JLoader
from behindthescenes_tpu_torch.datasets.augmentation import (
    hsv_to_rgb, rgb_to_hsv, sample_color_jitter)
from behindthescenes_tpu_torch.datasets.loader import DataLoader
from behindthescenes_tpu_torch.datasets.remap import remap_linear


class _Indexed:
    """Items that are their own index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"index": np.array([i], np.int64)}


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("workers", [0, 3])
def test_loader_order_matches_jax(drop_last, workers):
    """Three epochs of a shuffled loader (23 items in batches of 4, seed 5):
    the port's batches hold the JAX loader's items in the JAX loader's
    order, with and without the last short batch."""
    kw = dict(batch_size=4, shuffle=True, drop_last=drop_last, seed=5)
    want_loader = JLoader(_Indexed(23), num_workers=0, **kw)
    got_loader = DataLoader(_Indexed(23), num_workers=workers, **kw)
    assert len(got_loader) == len(want_loader) == (5 if drop_last else 6)
    seen = []
    for epoch in range(3):
        want_loader.set_epoch(epoch)
        got_loader.set_epoch(epoch)
        want = [b["index"][:, 0].tolist() for b in want_loader]
        got = [b["index"][:, 0].tolist() for b in got_loader]
        assert got == want, epoch
        seen.append(sum(got, []))
    assert seen[0] != seen[1] != seen[2]


def test_loader_without_shuffle_keeps_item_order():
    got = [b["index"][:, 0].tolist()
           for b in DataLoader(_Indexed(5), batch_size=2, num_workers=2)]
    assert got == [[0, 1], [2, 3], [4]]


def _maps(rng, src_hw, dst_hw):
    """Maps over the source and a margin of 3 pixels around it (in-range,
    border and out-of-range points), with whole-pixel points, the last
    row and column exactly, far-away points and non-finite ones."""
    hs, ws = src_hw
    mx = rng.uniform(-3, ws + 2, dst_hw).astype(np.float32)
    my = rng.uniform(-3, hs + 2, dst_hw).astype(np.float32)
    mx[0] = np.round(mx[0])
    my[1] = np.round(my[1])
    mx[2, :4] = [ws - 1, ws - 1.0 + 1e-3, -1.0 + 1e-3, 0.0]
    my[2, :4] = [hs - 1, 0.0, hs - 1.0 + 1e-3, -1.0 + 1e-3]
    mx[3, :5] = [-1e9, 1e9, np.nan, np.inf, 1.5]
    my[3, :5] = [1.0, 1.0, 1.0, 1.0, -np.inf]
    return mx, my


@pytest.mark.parametrize("case", ["rgb", "grey", "upsample", "fisheye_like"])
def test_remap_matches_opencv(case):
    """remap_linear against cv2.remap(INTER_LINEAR, BORDER_CONSTANT, 0) on
    random float32 images: bit-equal on every value (OpenCV 5.0), NaN
    where OpenCV gives NaN."""
    rng = np.random.default_rng(["rgb", "grey", "upsample",
                                 "fisheye_like"].index(case))
    src, dst = {"rgb": ((37, 53), (41, 47)), "grey": ((29, 31), (40, 40)),
                "upsample": ((12, 16), (96, 128)),
                "fisheye_like": ((64, 64), (48, 160))}[case]
    img = rng.random(src + ((3,) if case != "grey" else ())) \
        .astype(np.float32)
    if case == "fisheye_like":
        # A smooth map that leaves the source at its corners, as the
        # pinhole -> fisheye map does.
        yy, xx = np.mgrid[0:dst[0], 0:dst[1]].astype(np.float64)
        u, v = (xx / (dst[1] - 1)) * 2 - 1, (yy / (dst[0] - 1)) * 2 - 1
        r = 1 + 0.4 * (u * u + v * v)
        mx = ((u * r * 0.9 + 1) * 0.5 * (src[1] - 1)).astype(np.float32)
        my = ((v * r * 0.7 + 1) * 0.5 * (src[0] - 1)).astype(np.float32)
    else:
        mx, my = _maps(rng, src, dst)
    want = cv2.remap(img, mx, my, cv2.INTER_LINEAR,
                     borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    got = remap_linear(img, mx, my)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok], want[ok])


def test_color_jitter_matches_jax():
    """20 seeds (15 of the 24 op orders): the port's jitter lands within
    2e-6 of the JAX package's cv2 result, on images with grey, black,
    white and saturated pixels (measured with OpenCV 5.0: 0 of 184,320
    values differ). The input is not changed."""
    worst = 0.0
    for seed in range(20):
        img = np.random.default_rng(100 + seed).random((48, 64, 3)) \
            .astype(np.float32)
        img[0, :4] = [[0.5, 0.5, 0.5], [0, 0, 0], [1, 1, 1], [0.2, 0.2, 0.7]]
        orig = img.copy()
        want = jax_jitter(np.random.default_rng(seed))(img)
        rng = np.random.default_rng(seed)
        got = sample_color_jitter(rng)(img)
        np.testing.assert_array_equal(img, orig)
        assert got.dtype == np.float32
        worst = max(worst, float(np.abs(got - want).max()))
    assert worst <= 2e-6, worst


def test_color_jitter_leaves_the_stream_as_jax_does():
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    jax_jitter(a)
    sample_color_jitter(b)
    assert a.random() == b.random()


def test_hsv_matches_opencv():
    """rgb_to_hsv and hsv_to_rgb against cv2.cvtColor on float images:
    bit-equal (OpenCV 5.0)."""
    img = np.random.default_rng(11).random((64, 96, 3)).astype(np.float32)
    img[0, :3] = [[0.5, 0.5, 0.5], [0, 0, 0], [1, 0, 0]]
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    np.testing.assert_array_equal(rgb_to_hsv(img), hsv)
    hsv[..., 0] = (hsv[..., 0] + np.float32(37.5)) % np.float32(360.0)
    np.testing.assert_array_equal(hsv_to_rgb(hsv),
                                  cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))
