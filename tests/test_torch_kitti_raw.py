"""The port's KITTI raw loader (behindthescenes_tpu_torch/datasets/
kitti_raw.py) against the JAX package's, on a copy of the JAX test's
miniature tree (tests/test_kitti_raw.py: noise frames written by cv2 at
day 2011_09_26's 375x1242, a 500-point velodyne scan, simple rectified
stereo): every item's images bit-equal (the port decodes with its own
JPEG reader, JAX with cv2), projections and poses within 1e-6, depths bit
for bit, for `l` and `r` datapoints, stereo and mono, one and two frames,
keep_aspect_ratio and the colour jitter; both velodyne projectors against
the JAX package's numpy path and its C++ projector; and the synthetic
KITTI raw drive the port generates."""
import os

import cv2
import numpy as np
import pytest
import torch

from behindthescenes_tpu import native
from behindthescenes_tpu.datasets import kitti_raw as jkr
from behindthescenes_tpu_torch.config import (find_config, load_config,
                                              parse_cli_overrides)
from behindthescenes_tpu_torch.datasets import gen_synthetic_kitti_360 as k360
from behindthescenes_tpu_torch.datasets import gen_synthetic_kitti_raw as gen
from behindthescenes_tpu_torch.datasets import kitti_raw as tkr
from behindthescenes_tpu_torch.datasets.factory import make_datasets
from behindthescenes_tpu_torch.datasets.loader import DataLoader

# One intra-op thread: pytest-xdist runs several workers on this CPU,
# and torch's default of a thread per core makes every small op wait
# on threads that the other workers have swapped out.
torch.set_num_threads(1)

DAY = "2011_09_26"
SEQ = f"{DAY}_drive_0001_sync"
H0, W0 = 375, 1242  # base size for this day


@pytest.fixture(scope="module")
def kitti_tree(tmp_path_factory):
    """tests/test_kitti_raw.py's fixture tree, rebuilt from the same seed
    (copied, not imported)."""
    root = tmp_path_factory.mktemp("kitti_raw")
    data = root / "data"
    poses = root / "poses"
    seq_dir = data / DAY / SEQ
    rng = np.random.default_rng(0)

    for cam in ("image_02", "image_03"):
        d = seq_dir / cam / "data"
        d.mkdir(parents=True)
        for i in range(6):
            img = rng.integers(0, 255, (H0, W0, 3), dtype=np.uint8)
            cv2.imwrite(str(d / f"{i:010d}.jpg"), img)

    vd = seq_dir / "velodyne_points" / "data"
    vd.mkdir(parents=True)
    pts = np.concatenate([
        rng.uniform(3, 40, (500, 1)),            # x forward
        rng.uniform(-10, 10, (500, 1)),          # y left
        rng.uniform(-2, 1, (500, 1)),            # z up
        np.ones((500, 1))], axis=1).astype(np.float32)
    for i in range(6):
        pts.tofile(str(vd / f"{i:010d}.bin"))

    # Calibration: simple rectified stereo, fx=fy=700, baseline 0.54.
    k = np.array([[700.0, 0, W0 / 2], [0, 700.0, H0 / 2], [0, 0, 1]])
    p_l = np.hstack([k, np.zeros((3, 1))])
    p_r = p_l.copy()
    p_r[0, 3] = -0.54 * 700.0
    with open(data / DAY / "calib_cam_to_cam.txt", "w") as f:
        f.write("P_rect_02: " + " ".join(map(str, p_l.ravel())) + "\n")
        f.write("P_rect_03: " + " ".join(map(str, p_r.ravel())) + "\n")
        f.write("R_rect_00: " + " ".join(map(str, np.eye(3).ravel())) + "\n")
    with open(data / DAY / "calib_velo_to_cam.txt", "w") as f:
        # velodyne x-forward -> camera z-forward
        r = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], dtype=float)
        f.write("R: " + " ".join(map(str, r.ravel())) + "\n")
        f.write("T: 0 0 0\n")

    pd = poses / DAY
    pd.mkdir(parents=True)
    with open(pd / f"{SEQ}.txt", "w") as f:
        for i in range(6):
            pose = np.eye(4)
            pose[2, 3] = i * 0.8  # drive forward
            f.write(" ".join(map(str, pose[:3].ravel())) + "\n")

    split = root / "split"
    split.mkdir()
    for name in ("train_files.txt", "test_files.txt"):
        with open(split / name, "w") as f:
            f.write(f"{DAY}/{SEQ} 2 l\n")
            f.write(f"{DAY}/{SEQ} 3 r\n")
    # A frame with no .jpg, which the loaders read from its .png.
    png = seq_dir / "image_02" / "data" / f"{5:010d}"
    cv2.imwrite(str(png) + ".png", cv2.imread(str(png) + ".jpg"))
    os.remove(str(png) + ".jpg")
    with open(split / "png_files.txt", "w") as f:
        f.write(f"{DAY}/{SEQ} 5 l\n")
    return root


def _kw(tree, split="train_files.txt", **kw):
    return dict(data_path=str(tree / "data"), pose_path=str(tree / "poses"),
                split_path=str(tree / "split" / split), **kw)


def _assert_items_equal(want, got):
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["imgs"], want["imgs"])
    assert got["imgs"].dtype == want["imgs"].dtype == np.float32
    np.testing.assert_allclose(got["projs"], want["projs"], atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(got["poses"], want["poses"], atol=1e-6,
                               rtol=0)
    if "depths" in want:
        assert got["depths"].shape == want["depths"].shape
        np.testing.assert_array_equal(got["depths"], want["depths"])


# (split, keyword arguments): l and r datapoints (items 0 and 1), stereo
# and mono, one and two frames, keep_aspect_ratio, depths of both
# projectors, the .png fallback.
LOADS = {
    "stereo_fc2": ("train_files.txt",
                   dict(target_image_size=(96, 320), return_stereo=True,
                        frame_count=2)),
    "mono_fc1": ("train_files.txt",
                 dict(target_image_size=(48, 160), frame_count=1)),
    "mono_fc2_dilation2": ("train_files.txt",
                           dict(target_image_size=(48, 160), frame_count=2,
                                dilation=2)),
    "keep_aspect_stereo": ("train_files.txt",
                           dict(target_image_size=(64, 96),
                                return_stereo=True, frame_count=2,
                                keep_aspect_ratio=True)),
    "depth_counter": ("test_files.txt",
                      dict(target_image_size=(48, 160), frame_count=1,
                           return_depth=True, native_depth=False)),
    "depth_native_stereo": ("test_files.txt",
                            dict(target_image_size=(48, 160),
                                 return_stereo=True, frame_count=1,
                                 return_depth=True, native_depth=True)),
    "png_fallback": ("png_files.txt",
                     dict(target_image_size=(48, 160), frame_count=1)),
}


@pytest.mark.parametrize("case", sorted(LOADS))
def test_items_match_jax(case, kitti_tree):
    split, kw = LOADS[case]
    if kw.get("native_depth") and not native.available():
        pytest.skip("g++ unavailable: no JAX C++ projector to compare")
    want = jkr.KittiRawDataset(**_kw(kitti_tree, split, **kw))
    got = tkr.KittiRawDataset(**_kw(kitti_tree, split, **kw))
    assert len(got) == len(want)
    for i in range(len(want)):
        _assert_items_equal(want[i], got[i])
    if kw.get("return_depth"):
        assert got[0]["depths"].shape == (1, 1, H0, W0)
        assert (got[0]["depths"] > 0).sum() > 50


def test_colour_jitter_matches_jax_with_no_workers(kitti_tree):
    """make_train_test's training set with color_aug through a loader of
    no workers: the jitter of every item, drawn from the dataset's own
    generator in order, equals JAX's."""
    conf = {"data_path": str(kitti_tree / "data"),
            "pose_path": str(kitti_tree / "poses"),
            "split_path": str(kitti_tree / "split"),
            "image_size": [48, 160], "color_aug": True, "data_fc": 2}
    jtrain, jtest = jkr.KittiRawDataset.make_train_test(conf)
    train, test = make_datasets(dict(conf, type="KITTI_Raw"))
    assert test.native_depth and test.return_depth and train.color_aug
    want = [jtrain[i] for i in range(len(jtrain))]
    got = list(DataLoader(train, batch_size=1, num_workers=0))
    assert len(got) == len(want) == 2
    for w, g in zip(want, got):
        _assert_items_equal(w, {k: v[0] for k, v in g.items()})
    assert not np.array_equal(got[0]["imgs"][0],
                              tkr.KittiRawDataset(**_kw(
                                  kitti_tree, target_image_size=(48, 160),
                                  return_stereo=True))[0]["imgs"])


def test_tulsiani_config_builds_the_loaders(kitti_tree):
    """configs/data/kitti_raw_tulsiani.yaml (128x384, data_fc 1) through
    the port's config loader and factory, on the fixture tree."""
    conf = load_config(find_config("data/kitti_raw_tulsiani"),
                       parse_cli_overrides([
                           f"data_path={kitti_tree / 'data'}",
                           f"pose_path={kitti_tree / 'poses'}",
                           f"split_path={kitti_tree / 'split'}"]))
    assert conf["image_size"] == [128, 384] and conf["data_fc"] == 1
    train, test = make_datasets(conf)
    jtrain, jtest = jkr.KittiRawDataset.make_train_test(conf)
    item = train[0]
    assert item["imgs"].shape == (2, 128, 384, 3)
    _assert_items_equal(jtrain[0], item)
    _assert_items_equal(jtest[1], test[1])


def _scan(n, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.uniform(-5, 40, (n, 1)),
        rng.uniform(-10, 10, (n, 1)),
        rng.uniform(-2, 1, (n, 1)),
        np.ones((n, 1))], axis=1).astype(np.float32)


def _camera_projection():
    k = np.array([[700.0, 0, 600, 0], [0, 700.0, 180, 0], [0, 0, 1, 0]],
                 dtype=np.float32)
    rot = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0],
                    [0, 0, 0, 1]], dtype=np.float32)
    return (k @ rot).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("eigen", [False, True])
def test_counter_projector_matches_jax(seed, eigen):
    """project_velodyne_to_depth against the JAX package's on random
    scans, duplicate resolution (and its index collisions) included."""
    pts, p = _scan(5000, seed), _camera_projection()
    want = jkr.project_velodyne_to_depth(pts.copy(), p, (370, 1226), eigen)
    got = tkr.project_velodyne_to_depth(pts.copy(), p, (370, 1226), eigen)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_counter_projector_duplicates_match_jax():
    """tests/test_kitti_raw.py:127-138's case: two points on pixel (1, 1),
    the nearer depth kept."""
    p_mat = np.hstack([np.eye(3), np.zeros((3, 1))]).astype(np.float32)
    pts = np.array([[2.4, 2.4, 1.0, 1.0], [4.8, 4.8, 2.0, 1.0]],
                   dtype=np.float32)
    want = jkr.project_velodyne_to_depth(pts, p_mat, (4, 4), False)
    got = tkr.project_velodyne_to_depth(pts, p_mat, (4, 4), False)
    np.testing.assert_array_equal(got, want)
    nz = got[got > 0]
    assert len(nz) == 1 and nz[0] == 1.0


@pytest.mark.skipif(not native.available(), reason="g++ unavailable")
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_min_projector_matches_native(seed):
    """project_velodyne_depth against native/velodyne_depth.cpp on
    tests/test_native.py:10-38's inputs (seed 0) and two more scans."""
    pts, p = _scan(5000, seed), _camera_projection()
    want = native.project_velodyne_depth(pts, p, (370, 1226))
    got = tkr.project_velodyne_depth(pts, p, (370, 1226))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    dup = np.array([[2.4, 2.4, 1.0, 1.0], [4.8, 4.8, 2.0, 1.0]],
                   dtype=np.float32)
    eye = np.hstack([np.eye(3), np.zeros((3, 1))]).astype(np.float32)
    np.testing.assert_array_equal(
        tkr.project_velodyne_depth(dup, eye, (4, 4)),
        native.project_velodyne_depth(dup, eye, (4, 4)))


@pytest.mark.skipif(not native.available(), reason="g++ unavailable")
def test_min_projector_rounds_half_to_even():
    """Points that land on a half pixel: nearbyint's half to even, not
    numpy's round-half-away, as the C++ projector rounds."""
    eye = np.hstack([np.eye(3), np.zeros((3, 1))]).astype(np.float32)
    pts = np.array([[2.5, 3.5, 1.0, 1], [4.5, 1.5, 1.0, 1],
                    [-1.0, 1.0, 1.0, 1], [1.0, 1.0, -1.0, 1]], np.float32)
    got = tkr.project_velodyne_depth(pts, eye, (6, 6))
    np.testing.assert_array_equal(
        got, native.project_velodyne_depth(pts, eye, (6, 6)))
    assert got[3, 1] == 1.0 and got[1, 3] == 1.0 and (got > 0).sum() == 2


def test_generated_drive_loads(tmp_path):
    """The port's synthetic drive at a cut size: calibration, poses,
    splits and velodyne files in KITTI's layout; the JAX loader (cv2)
    and the port's read it alike; its velodyne ground truth agrees with
    the rendered depth (median under 1%, 99% of its pixels within 5%),
    and its NDC intrinsics are the KITTI-360 tree's."""
    secs = gen.generate_tree(tmp_path, n_frames=5, test_keyframes=(2,),
                             size=(47, 155))
    assert secs["frame_bytes"] > 0
    kw = dict(data_path=str(tmp_path), pose_path=str(tmp_path / "poses"),
              split_path=str(tmp_path / "splits" / "test_files.txt"),
              target_image_size=(32, 96), return_stereo=True,
              return_depth=True, native_depth=False)
    want, got = jkr.KittiRawDataset(**kw), tkr.KittiRawDataset(**kw)
    _assert_items_equal(want[0], got[0])
    with open(tmp_path / "splits" / "train_files.txt") as f:
        train = f.read().split("\n")
    assert f"{DAY}/{SEQ} 1 l" in train and f"{DAY}/{SEQ} 1 r" in train
    assert f"{DAY}/{SEQ} 2 l" not in train
    item = got[0]
    k = item["projs"][0]
    np.testing.assert_allclose(
        [k[0, 0], k[1, 1], k[0, 2], k[1, 2]],
        [2 * 552.554 / 1408, 2 * 552.554 / 376, 2 * 682.05 / 1408 - 1,
         2 * 238.77 / 376 - 1], rtol=1e-5)
    depth = item["depths"][0, 0]
    assert depth.shape == (H0, W0) and (depth > 0).sum() > 1000
    # The ground truth against the scene's own z-depth at the keyframe's
    # left camera, rendered at the base size.
    boxes = k360.build_scene(np.random.default_rng(0), 5.0)
    c2w = gen.body_poses(5)[2] @ k360.make_calibs(
        k360.HP_REF, k360.WP_REF, k360.HF_REF,
        k360.WF_REF)["cam_to_pose"]["image_00"]
    dirs = k360.pinhole_dirs(np.hstack([gen.k_pixels(), np.zeros((3, 1))]),
                             H0, W0)
    _, t, _ = k360.render_image(c2w, dirs, boxes)
    mask = depth > 0
    rel = np.abs(t[mask] * dirs[..., 2][mask] - depth[mask]) / depth[mask]
    assert np.median(rel) < 0.01 and np.mean(rel < 0.05) > 0.99
    # the right camera sits the baseline to the right of the left one
    np.testing.assert_allclose(
        np.linalg.inv(item["poses"][0]) @ item["poses"][2] @ [0, 0, 0, 1],
        [gen.STEREO_BASELINE, 0, 0, 1], atol=1e-5)
