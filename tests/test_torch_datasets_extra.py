"""The port's KITTI odometry, Waymo, NYU Depth v2, VIPER and TRI-PD
loaders (behindthescenes_tpu_torch/datasets/) against the JAX package's
on miniature trees in each loader's layout (those of
tests/test_datasets_extra.py), with random image content made from a
numpy seed: every item bit-equal to the JAX loader's, the colour-jitter
draws included. Also the factory's three new types, and
`png.resize_linear_u8` and `png.read_png_color` against OpenCV.
"""
import json
import os
import pickle

import cv2
import h5py
import numpy as np
import pytest
import torch

from behindthescenes_tpu.datasets import factory as jfactory
from behindthescenes_tpu.datasets.kitti_odom import \
    KittiOdometryDataset as JOdom
from behindthescenes_tpu.datasets.nyu_depth_v2 import \
    NYUDepthV2Dataset as JNYU
from behindthescenes_tpu.datasets.tri_pd import TRIPDDataset as JTRIPD
from behindthescenes_tpu.datasets.viper import ViperDataset as JViper
from behindthescenes_tpu.datasets.waymo import WaymoDataset as JWaymo
from behindthescenes_tpu_torch.datasets import factory, png
from behindthescenes_tpu_torch.datasets.kitti_odom import KittiOdometryDataset
from behindthescenes_tpu_torch.datasets.nyu_depth_v2 import NYUDepthV2Dataset
from behindthescenes_tpu_torch.datasets.tri_pd import (TRIPDDataset,
                                                       quat_to_matrix)
from behindthescenes_tpu_torch.datasets.viper import ViperDataset
from behindthescenes_tpu_torch.datasets.waymo import WaymoDataset

# One intra-op thread: pytest-xdist runs several workers on this CPU,
# and torch's default of a thread per core makes every small op wait
# on threads that the other workers have swapped out.
torch.set_num_threads(1)


def _assert_items_equal(want, got):
    assert set(got) == set(want)
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def _smooth(rng, h, w, c=3, noise=12.0):
    """Random uint8 content with structure at several scales (it
    compresses, and every resize tap sees different values)."""
    small = rng.uniform(0, 255, (max(2, h // 8), max(2, w // 8), c))
    big = cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC)
    noise = rng.normal(0, noise, (h, w, c))
    return np.clip(big + noise, 0, 255).astype(np.uint8)


# ---------------------------------------------------------- KITTI odometry

def _make_odom_tree(root, seed=0, n_frames=6):
    rng = np.random.default_rng(seed)
    for seq, (h, w) in (("00", (376, 1241)), ("04", (370, 1226))):
        seq_dir = os.path.join(root, "sequences", seq)
        for cam in ("image_2", "image_3"):
            os.makedirs(os.path.join(seq_dir, cam))
        fx, cx, cy = 718.856 + rng.uniform(-5, 5), 607.19, 185.22
        p2 = [fx, 0, cx, 44.8, 0, fx, cy, 0.2, 0, 0, 1, 0.003]
        p3 = [fx, 0, cx, -386.1448, 0, fx, cy, 0, 0, 0, 1, 0]
        with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
            f.write("P2: " + " ".join(repr(float(v)) for v in p2) + "\n")
            f.write("P3: " + " ".join(repr(float(v)) for v in p3) + "\n")
        for cam in ("image_2", "image_3"):
            for i in range(n_frames):
                png.write_png(os.path.join(seq_dir, cam, f"{i:06d}.png"),
                              rng.integers(0, 256, (h, w, 3), np.uint8))
        os.makedirs(os.path.join(root, "poses"), exist_ok=True)
        with open(os.path.join(root, "poses", f"{seq}.txt"), "w") as f:
            for i in range(n_frames):
                mat = np.eye(4)[:3] + rng.normal(0, 0.1, (3, 4))
                f.write(" ".join(repr(float(v)) for v in mat.ravel()) + "\n")


@pytest.mark.parametrize("stereo,size,fc", [(True, (64, 128), 2),
                                            (False, (96, 160), 3)])
def test_kitti_odometry_items_equal_jax(tmp_path, stereo, size, fc):
    _make_odom_tree(str(tmp_path))
    kw = dict(frame_count=fc, sequences=["00", "04"],
              target_image_size=size, return_stereo=stereo)
    want, got = JOdom(str(tmp_path), **kw), \
        KittiOdometryDataset(str(tmp_path), **kw)
    assert len(got) == len(want) == 2 * (6 - fc)
    for i in (0, len(want) // 2, len(want) - 1):
        _assert_items_equal(want[i], got[i])
    with pytest.raises(IndexError):
        got[len(got)]


def test_grey_and_16_bit_pngs_read_as_imread_color(tmp_path):
    rng = np.random.default_rng(1)
    cases = {"grey8": rng.integers(0, 256, (7, 9), np.uint8),
             "grey16": rng.integers(0, 65536, (7, 9), np.uint16),
             "rgb16": rng.integers(0, 65536, (7, 9, 3), np.uint16),
             "rgb8": rng.integers(0, 256, (7, 9, 3), np.uint8)}
    for name, img in cases.items():
        path = str(tmp_path / f"{name}.png")
        cv2.imwrite(path, img)
        want = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        got = png.read_png_color(path)
        assert got.dtype == np.uint8 and got.shape == (7, 9, 3)
        np.testing.assert_array_equal(got, want, err_msg=name)


# ------------------------------------------------------------------ Waymo

def _yaw(deg):
    c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
    m = np.eye(4)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def _make_waymo_tree(root, seed=0, n_frames=20, h=32, w=48):
    rng = np.random.default_rng(seed)
    for mode, seq in (("training", "seg-0001"), ("validation", "seg-0002")):
        base = os.path.join(root, mode, seq)
        os.makedirs(os.path.join(base, "lidar"))
        poses = np.tile(np.eye(4, dtype=np.float32), (n_frames, 1, 1))
        poses[:, :3, 3] = rng.normal(0, 2, (n_frames, 3))
        np.save(os.path.join(base, "poses.npy"), poses)
        yaws = {1: 0, 2: -45, 3: 45, 4: -90, 5: 90}
        k_ndc = {c: np.array([[1.1 + 0.1 * c, 0, 0.02], [0, 1.6, -0.03],
                              [0, 0, 1]]) for c in yaws}
        calib = {"extrinsics": {c: _yaw(d) for c, d in yaws.items()},
                 "proj_mats": k_ndc}
        with open(os.path.join(base, "calibration.pkl"), "wb") as f:
            pickle.dump(calib, f)
        with open(os.path.join(base, "exposures.pkl"), "wb") as f:
            pickle.dump({c: rng.uniform(0.5, 2.0, n_frames)
                         for c in yaws}, f)
        for c in yaws:
            d = os.path.join(base, "frames", f"cam_{c:02d}")
            os.makedirs(d)
            for i in range(n_frames):
                cv2.imwrite(os.path.join(d, f"{i:010d}.jpg"),
                            _smooth(rng, h, w))
        for i in range(n_frames):
            pts = np.stack([rng.uniform(-8, 8, 400), rng.uniform(-2, 2, 400),
                            rng.uniform(-5, 30, 400)], -1)
            # points that land on one pixel: the last one's depth stays
            pts = np.concatenate([pts, pts[:40] * 1.5, pts[:40] * 1.25])
            np.save(os.path.join(base, "lidar", f"{i:010d}.npy"),
                    pts.astype(np.float32))
    with open(os.path.join(root, "val_split.txt"), "w") as f:
        f.writelines(f"seg-0002 {i}\n" for i in (0, 5, 13, 19))


@pytest.mark.parametrize("size,exposure,fc", [((32, 48), True, 2),
                                              ((24, 40), False, 3)])
def test_waymo_items_equal_jax(tmp_path, size, exposure, fc):
    _make_waymo_tree(str(tmp_path))
    kw = dict(target_image_size=size, frame_count=fc, return_depth=True,
              correct_exposure=exposure)
    want = JWaymo(str(tmp_path), "validation",
                  split_path=str(tmp_path / "val_split.txt"), **kw)
    got = WaymoDataset(str(tmp_path), "validation",
                       split_path=str(tmp_path / "val_split.txt"), **kw)
    assert len(got) == len(want) == 4
    for i in range(4):
        _assert_items_equal(want[i], got[i])
    assert (got[1]["depths"] > 0).sum() > 20
    assert got[1]["imgs"].shape == (5 * fc, *size, 3)


def test_waymo_colour_jitter_draws_equal_jax(tmp_path):
    """Training items with the colour jitter: the loaders draw from their
    own generators of one seed in the same order, item after item."""
    _make_waymo_tree(str(tmp_path), seed=1)
    kw = dict(target_image_size=(32, 48), color_aug=True, seed=5,
              correct_exposure=True)
    want = JWaymo(str(tmp_path), "training", **kw)
    got = WaymoDataset(str(tmp_path), "training", **kw)
    assert len(got) == len(want) == 20
    for i in (3, 0, 19, 3):
        _assert_items_equal(want[i], got[i])


# ------------------------------------------------------------------ NYU v2

def _make_nyu(root, seed=0, n=3, w=64, h=48):
    rng = np.random.default_rng(seed)
    imgs = np.stack([_smooth(rng, w, h).transpose(2, 0, 1)
                     for _ in range(n)])                    # (n, 3, W, H)
    depths = rng.uniform(0.5, 10.0, (n, w, h)).astype(np.float32)
    with h5py.File(os.path.join(root, "nyu_depth_v2_labeled.mat"), "w",
                   userblock_size=512) as f:
        f.create_dataset("images", data=imgs, chunks=(1, 3, 32, 32),
                         compression="gzip")
        f.create_dataset("depths", data=depths, chunks=(1, 32, 32),
                         compression="gzip")


@pytest.mark.parametrize("size", [(48, 64), (30, 50), None])
def test_nyu_items_equal_jax(tmp_path, size):
    _make_nyu(str(tmp_path))
    want, got = JNYU(str(tmp_path), size), NYUDepthV2Dataset(str(tmp_path),
                                                             size)
    assert len(got) == len(want) == 3
    for i in range(3):
        _assert_items_equal(want[i], got[i])


# ------------------------------------------------------------------- VIPER

def _make_viper_tree(root, seed=0, n_frames=3):
    rng = np.random.default_rng(seed)
    seq = "001"
    for sub in ("img", "flow", "inst"):
        os.makedirs(os.path.join(root, sub, seq))
    os.makedirs(os.path.join(root, "camera"))
    rows = []
    for i in range(n_frames):
        cv2.imwrite(os.path.join(root, "img", seq, f"{i:05d}.jpg"),
                    _smooth(rng, 1080, 1920, noise=1.0))
        seg = np.zeros((1080, 1920, 3), np.uint8)
        for _ in range(6):
            y, x = rng.integers(0, 900), rng.integers(0, 1700)
            seg[y:y + 180, x:x + 220] = (rng.integers(0, 32),
                                         rng.integers(0, 256),
                                         rng.integers(0, 256))
        cv2.imwrite(os.path.join(root, "inst", seq, f"{i:05d}.png"), seg)
        u = rng.normal(0, 3, (1080, 1920)).astype(np.float32)
        u[rng.uniform(size=u.shape) < 0.01] = np.nan
        np.savez_compressed(os.path.join(root, "flow", seq, f"{i:05d}.npz"),
                            u=u, v=rng.normal(0, 3, u.shape)
                            .astype(np.float32))
        rows.append(np.concatenate([[i], rng.normal(size=16),
                                    rng.normal(size=16)]))
    np.savetxt(os.path.join(root, "camera", f"{seq}.csv"), np.stack(rows),
               delimiter=",", header=",".join(["c"] * 33), comments="")


@pytest.mark.parametrize("size", [(128, 192), (96, 400)])
def test_viper_items_equal_jax(tmp_path, size):
    _make_viper_tree(str(tmp_path))
    kw = dict(frame_count=2, every_nth=1, target_size=size)
    want, got = JViper(str(tmp_path), **kw), ViperDataset(str(tmp_path), **kw)
    assert len(got) == len(want) == 2
    for i in range(2):
        _assert_items_equal(want[i], got[i])
    assert got[0]["segs"][..., 0].max() == 1


# ------------------------------------------------------------------ TRI-PD

def _make_tri_pd_tree(root, seed=0, n_frames=8, h=300, w=400):
    rng = np.random.default_rng(seed)
    for s, scene in enumerate(("scene_000000", "scene_000001",
                               "scene_000004")):
        base = os.path.join(root, scene)
        os.makedirs(os.path.join(base, "calibration"))
        q = rng.normal(size=4)
        calib = {
            "names": ["camera_01", "camera_05"],
            "extrinsics": [{"rotation": dict(zip("xyzw", q.tolist())),
                            "translation": dict(zip(
                                "xyz", rng.normal(size=3).tolist()))}] * 2,
            "intrinsics": [{"fx": 968.0 + s, "fy": 608.0, "cx": 968.0,
                            "cy": 608.0}] * 2,
        }
        with open(os.path.join(base, "calibration", "cal.json"), "w") as f:
            json.dump(calib, f)
        for cam in ("camera_01", "camera_05"):
            rgb_dir = os.path.join(base, "rgb", cam)
            mask_dir = os.path.join(base, "moving_masks", cam)
            flow_dir = os.path.join(base, "motion_vectors_2d", cam)
            for d in (rgb_dir, mask_dir, flow_dir):
                os.makedirs(d)
            for i in range(n_frames):
                name = f"{(i + 1) * 5:018d}.png"
                if scene == "scene_000004" and cam == "camera_05" and i == 4:
                    continue          # a missing frame: the next item
                cv2.imwrite(os.path.join(rgb_dir, name),
                            rng.integers(0, 256, (h, w, 3), np.uint8))
                mask = np.zeros((h, w), np.uint16)
                for _ in range(5):
                    y, x = rng.integers(150, h - 40), rng.integers(0, w - 60)
                    mask[y:y + 40, x:x + 60] = rng.integers(1, 60000)
                mask[0:3, 0:3] = 77           # tiny: mapped to 0
                cv2.imwrite(os.path.join(mask_dir, name), mask)
                cv2.imwrite(os.path.join(flow_dir, name),
                            rng.integers(0, 65536, (h, w, 3), np.uint16))


@pytest.mark.parametrize("random_select", [False, True])
def test_tri_pd_items_equal_jax(tmp_path, random_select):
    """Random uint8 frames through the 0.58 uint8 resize, 16-bit masks
    with tiny instances, 16-bit BGR motion vectors, a missing frame."""
    _make_tri_pd_tree(str(tmp_path))
    kw = dict(split="train", root=str(tmp_path), frame_count=2,
              random_select=random_select, load_flow=True, seed=3)
    want, got = JTRIPD(**kw), TRIPDDataset(**kw)
    assert len(got) == len(want)
    indices = [0, 3, 2, 1] if random_select else [0, 190 * 3 + 3,
                                                  190 * 3 + 4, 190 + 7]
    for i in indices:
        _assert_items_equal(want[i], got[i])
    assert got[0]["imgs"].shape == (2, 174 - 158, 232, 3)


@pytest.mark.parametrize("seed", range(4))
def test_quaternion_matches_scipy(seed):
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(seed)
    for _ in range(200):
        q = rng.normal(size=4) * rng.uniform(0.1, 5)
        np.testing.assert_array_equal(quat_to_matrix(q),
                                      Rotation.from_quat(q).as_matrix())


# ------------------------------------------------------ the uint8 resize

@pytest.mark.parametrize("src,dst,c", [
    ((1216, 1936), (706, 1123), 3),     # TRI-PD's 0.58
    ((300, 400), (174, 232), 3), ((37, 53), (61, 19), 3),
    ((50, 60), (25, 30), 3), ((48, 64), (20, 30), 1), ((5, 7), (1, 1), 4),
    ((2, 2), (9, 13), 1), ((100, 100), (33, 77), 3)])
def test_resize_linear_u8_equals_cv2(src, dst, c):
    rng = np.random.default_rng(sum(src) + sum(dst))
    shape = src + ((c,) if c > 1 else ())
    for img in (rng.integers(0, 256, shape, np.uint8),
                np.full(shape, 255, np.uint8)):
        want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(png.resize_linear_u8(img, dst), want)
    with pytest.raises(ValueError):
        png.resize_linear_u8(img.astype(np.float32), dst)


def test_resize_linear_u8_random_sizes():
    rng = np.random.default_rng(7)
    for _ in range(60):
        h0, w0, h, w = rng.integers(1, 90, 4)
        img = rng.integers(0, 256, (h0, w0, 3), np.uint8)
        want = cv2.resize(img, (int(w), int(h)),
                          interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(png.resize_linear_u8(img, (h, w)),
                                      want)


# ----------------------------------------------------------------- factory

def test_factory_serves_the_three_types(tmp_path):
    odom, waymo, nyu = (tmp_path / d for d in ("odom", "waymo", "nyu"))
    for d in (odom, waymo, nyu):
        d.mkdir()
    _make_odom_tree(str(odom))
    _make_waymo_tree(str(waymo))
    _make_nyu(str(nyu))
    confs = [
        {"type": "KITTI_Odometry", "data_path": str(odom),
         "pose_path": str(odom / "poses"), "image_size": (64, 128),
         "data_fc": 2, "data_stereo": True, "train_sequences": ["00"],
         "test_sequences": ["04"]},
        {"type": "Waymo", "data_path": str(waymo), "image_size": (24, 32),
         "split_path": str(waymo / "val_split.txt"), "color_aug": True,
         "correct_exposure": True},
        {"type": "NYU_Depth_V2", "data_path": str(nyu),
         "image_size": (48, 64)},
    ]
    for conf in confs:
        want = jfactory.make_datasets(dict(conf))
        got = factory.make_datasets(dict(conf))
        for w, g in zip(want, got):
            if w is None:
                assert g is None and conf["type"] == "NYU_Depth_V2"
                continue
            assert len(g) == len(w) > 0
            _assert_items_equal(w[0], g[0])
            _assert_items_equal(w[len(w) - 1], g[len(g) - 1])
        assert factory.make_test_dataset(dict(conf)) is not None
