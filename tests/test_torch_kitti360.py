"""The port's KITTI-360 loading path against OpenCV, scipy, PyYAML and the
JAX package: the PNG reader and writer and the two resizes of
behindthescenes_tpu_torch/datasets/png.py against cv2; the extrinsic Euler
rotation against scipy; the fisheye YAML writer and reader against
PyYAML; the port's Kitti360Dataset against the JAX one, every key of every
item, on the miniature fixture tree (tests/kitti360_fixture.py) and on a
small generated drive, raw and preprocessed; and the port's generator and
preprocessor against the JAX scripts (scripts/datasets/) at that size.
"""
import os
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import yaml
from scipy.spatial.transform import Rotation

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(ROOT, "scripts", "datasets"))

import gen_synthetic_kitti_360 as jgen  # noqa: E402

from behindthescenes_tpu.datasets.kitti_360 import \
    Kitti360Dataset as JDataset  # noqa: E402
from behindthescenes_tpu_torch.datasets import \
    gen_synthetic_kitti_360 as tgen  # noqa: E402
from behindthescenes_tpu_torch.datasets import png  # noqa: E402
from behindthescenes_tpu_torch.datasets.kitti_360 import (  # noqa: E402
    Kitti360Dataset, euler_xy, read_fisheye_yaml)
from behindthescenes_tpu_torch.datasets.preprocess_kitti_360 import \
    preprocess  # noqa: E402
from kitti360_fixture import (FISH_CALIB, add_bboxes_and_semantics,
                              build_kitti360_tree)  # noqa: E402

# A small drive (tests/test_synthetic_kitti_360.py:32 at about half its
# resolution), with two test keyframes; the resolution it is loaded and
# preprocessed at.
DRIVE = dict(n_frames=26, hp=48, wp=176, hf=64, wf=64, seed=3, n_az=360,
             test_keyframes=[2, 5])
DRIVE_HW = (48, 160)
FILTERS = {"none": cv2.IMWRITE_PNG_FILTER_NONE,
           "sub": cv2.IMWRITE_PNG_FILTER_SUB,
           "up": cv2.IMWRITE_PNG_FILTER_UP,
           "average": cv2.IMWRITE_PNG_FILTER_AVG,
           "paeth": cv2.IMWRITE_PNG_FILTER_PAETH,
           "adaptive": cv2.IMWRITE_PNG_ALL_FILTERS}


def _row_filters(path) -> set:
    """The filter byte of every row of an 8-bit PNG."""
    data = open(path, "rb").read()
    pos, idat, header = 8, b"", None
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    w, h, _, color = header[:4]
    stride = w * (3 if color == 2 else 1) + 1
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, stride)
    return set(raw[:, 0].tolist())


def _image(h, w, seed=0):
    """Smooth bands with noise: every row filter has work to do."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(np.sin(xx / 7.0) + np.cos(yy / 5.0)) * 60 + 128,
                    xx * 1.9, (yy * 2 + xx) % 256], -1)
    return np.clip(img + rng.normal(0, 3, img.shape), 0, 255) \
        .astype(np.uint8)


# ------------------------------------------------------------------ png
def test_png_reads_every_opencv_row_filter(tmp_path):
    """OpenCV-written RGB and grey PNGs, one file for each row filter it
    offers and one with its adaptive choice, read as cv2.imread reads
    them (channels in RGB order); together they use all five filters."""
    img = _image(37, 53)
    seen = set()
    for name, flt in FILTERS.items():
        for grey in (False, True):
            path = str(tmp_path / f"{name}_{grey}.png")
            if grey:
                cv2.imwrite(path, img[..., 0], [cv2.IMWRITE_PNG_FILTER, flt])
                want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
            else:
                cv2.imwrite(path, img[..., ::-1],
                            [cv2.IMWRITE_PNG_FILTER, flt])
                want = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
            got = png.read_png(path)
            assert got.dtype == np.uint8 and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
            seen |= _row_filters(path)
    assert seen == {0, 1, 2, 3, 4}


def test_png_round_trip(tmp_path):
    """write_png's files read back equal, by the port and by OpenCV."""
    img = _image(20, 31, seed=1)
    for arr in (img, img[..., 1]):
        path = str(tmp_path / f"rt{arr.ndim}.png")
        png.write_png(path, arr)
        assert _row_filters(path) == {0}
        np.testing.assert_array_equal(png.read_png(path), arr)
        back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(
            back[..., ::-1] if arr.ndim == 3 else back, arr)
    with pytest.raises(ValueError):
        png.write_png(str(tmp_path / "f.png"), img.astype(np.float32))
    cv2.imwrite(str(tmp_path / "rgba.png"),
                np.zeros((4, 4, 4), np.uint8))
    with pytest.raises(ValueError, match="colour type 6"):
        png.read_png(str(tmp_path / "rgba.png"))


@pytest.mark.parametrize("src,dst", [
    ((94, 352, 3), (48, 160)),       # shrink, both axes
    ((188, 704, 3), (192, 640)),     # the gate tree: grow y, shrink x
    ((37, 53, 3), (80, 101)),        # grow, both axes
    ((37, 53), (20, 30)),            # grey
    ((48, 176, 3), (96, 88)),        # grow y, halve x
])
def test_resize_linear_matches_opencv(src, dst):
    rng = np.random.default_rng(sum(src) + sum(dst))
    img = rng.uniform(0, 1, src).astype(np.float32)
    want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
    got = png.resize_linear(img, dst)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("src,dst", [((376, 1408), (192, 640)),
                                     ((94, 352), (48, 160)),
                                     ((37, 53), (80, 101)),
                                     ((48, 176), (24, 88))])
def test_resize_nearest_matches_opencv(src, dst):
    rng = np.random.default_rng(0)
    seg = rng.integers(0, 45, src, dtype=np.uint8)
    want = cv2.resize(seg, (dst[1], dst[0]),
                      interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(png.resize_nearest(seg, dst), want)


# ------------------------------------------------------- calibration
@pytest.mark.parametrize("angles", [(-15, 0), (0, -15), (15, 0), (30, -45),
                                    (-170.5, 89.9)])
def test_euler_xy_matches_scipy(angles):
    """The loader's fisheye rotation: extrinsic x then y, in degrees."""
    a = np.array([angles], dtype=np.float64)
    want = Rotation.from_euler("xy", a, degrees=True).as_matrix()
    assert np.abs(euler_xy(a) - want).max() <= 1e-6


def test_fisheye_yaml_matches_pyyaml(tmp_path):
    """The generator's YAML is PyYAML's text; the loader reads it, and the
    KITTI-360 files' `---` marker, as yaml.safe_load does."""
    calibs = jgen.make_calibs(94, 352, 176, 176)
    for c in (FISH_CALIB, *calibs["fisheye"].values()):
        d = jgen.fisheye_yaml_dict(c) if "image_height" in c else c
        assert tgen.dump_yaml(d) == yaml.safe_dump(d)
        for marker in ("", "---\n"):
            path = tmp_path / "image_02.yaml"
            path.write_text("%YAML:1.0\n" + marker + yaml.safe_dump(d))
            assert read_fisheye_yaml(path) == d
    assert tgen.dump_yaml({"a": 1e-05, "b": float("inf")}) == \
        yaml.safe_dump({"a": 1e-05, "b": float("inf")})


# ------------------------------------------------------------ datasets
def _assert_items_equal(want, got):
    """Every key equal, and every box of 3d_bboxes equal key by key."""
    assert set(got) == set(want)
    for k in want:
        if k == "3d_bboxes":
            assert len(got[k]) == len(want[k]) > 0
            for a, b in zip(want[k], got[k]):
                assert set(a) == set(b)
                for kk in a:
                    np.testing.assert_array_equal(np.asarray(b[kk]),
                                                  np.asarray(a[kk]))
            continue
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _check_dataset(kw, n_items=None):
    want, got = JDataset(**kw), Kitti360Dataset(**kw)
    assert got._datapoints == want._datapoints
    assert len(got) == len(want) > 0
    for key in ("K_perspective", "T_velo_to_pose"):
        np.testing.assert_array_equal(got._calibs[key], want._calibs[key])
    for cam in ("00", "01", "02", "03"):
        np.testing.assert_array_equal(got._calibs["T_cam_to_pose"][cam],
                                      want._calibs["T_cam_to_pose"][cam])
    for name in ("calib_02", "calib_03"):
        assert got._calibs["fisheye"][name] == want._calibs["fisheye"][name]
    for name in ("R_02", "R_03"):
        assert np.abs(got._calibs["fisheye"][name]
                      - want._calibs["fisheye"][name]).max() <= 1e-6
    for i in range(len(want) if n_items is None else n_items):
        _assert_items_equal(want[i], got[i])


@pytest.fixture(scope="module")
def fixture_tree(tmp_path_factory):
    root = build_kitti360_tree(tmp_path_factory.mktemp("k360_fixture"))
    return add_bboxes_and_semantics(root)


@pytest.mark.parametrize("case", ["mono_boxes_segs", "stereo_full_split"])
def test_dataset_matches_jax_on_fixture(fixture_tree, case):
    kw = dict(data_path=str(fixture_tree / "data"),
              pose_path=str(fixture_tree / "poses"),
              target_image_size=(48, 176), return_fisheye=False,
              return_depth=True)
    if case == "mono_boxes_segs":
        kw.update(split_path=str(fixture_tree / "split" / "test_files.txt"),
                  return_stereo=False, frame_count=1,
                  return_3d_bboxes=True, return_segmentation=True)
        _check_dataset(kw)
    else:
        kw.update(split_path=None, return_stereo=True, frame_count=2)
        _check_dataset(kw, n_items=3)


@pytest.fixture(scope="module")
def drives(tmp_path_factory):
    """The small drive from the JAX generator, preprocessed at DRIVE_HW by
    the JAX script, and from the port's, preprocessed by the port's."""
    base = tmp_path_factory.mktemp("k360_drives")
    jax_root, port_root = base / "jax", base / "port"
    jgen.generate_tree(jax_root, **DRIVE)
    subprocess.run([sys.executable, os.path.join(
        ROOT, "scripts", "datasets", "preprocess_kitti_360.py"),
        "-d", str(jax_root), "-r", *map(str, DRIVE_HW)], check=True,
        timeout=600, cwd=ROOT, capture_output=True)
    tgen.generate_tree(port_root, **DRIVE)
    preprocess(port_root, DRIVE_HW)
    return jax_root, port_root


@pytest.mark.parametrize("case", ["raw_stereo_boxes", "preprocessed_mono",
                                  "train_split_right_views"])
def test_dataset_matches_jax_on_drive(drives, case):
    root = drives[0]
    kw = dict(data_path=str(root), pose_path=str(root / "data_poses"),
              split_path=str(root / "splits" / "test_files.txt"),
              target_image_size=DRIVE_HW, return_fisheye=False,
              return_depth=True, frame_count=2)
    if case == "raw_stereo_boxes":
        kw.update(return_stereo=True, return_3d_bboxes=True,
                  return_segmentation=True)
        _check_dataset(kw)
    elif case == "preprocessed_mono":
        kw.update(return_stereo=False, is_preprocessed=True,
                  return_3d_bboxes=True, frame_count=1)
        _check_dataset(kw)
    else:
        kw.update(split_path=str(root / "splits" / "train_files.txt"),
                  return_stereo=False, is_preprocessed=True)
        _check_dataset(kw, n_items=4)


def _files(root: Path) -> set:
    return {str(p.relative_to(root)) for p in root.rglob("*") if p.is_file()}


def test_generator_and_preprocessor_match_jax(drives):
    """The port's drive has the JAX drive's files, less the preprocessed
    fisheye frames (the fisheye resample is not ported): poses,
    calibration, velodyne scans and box XML byte-equal; raw frames and
    semantic maps decode equal; preprocessed frames within one uint8 level,
    and only where the float value the preprocessor truncates lies within
    1e-3 of an integer. Measured with OpenCV 5.0: no preprocessed pixel
    differs (the port's resize is bit-equal to OpenCV's on these
    frames)."""
    jax_root, port_root = drives
    want, got = _files(jax_root), _files(port_root)
    fisheye_pre = {f for f in want
                   if f"data_{DRIVE_HW[0]}x{DRIVE_HW[1]}_" in f}
    assert fisheye_pre and got == want - fisheye_pre
    differ = total = 0
    for f in sorted(got):
        a, b = jax_root / f, port_root / f
        if not f.endswith(".png"):
            assert a.read_bytes() == b.read_bytes(), f
            continue
        ref = cv2.imread(str(a), cv2.IMREAD_UNCHANGED)
        if ref.ndim == 3:
            ref = ref[..., ::-1]
        mine = png.read_png(b)
        if f"data_{DRIVE_HW[0]}x{DRIVE_HW[1]}" not in f:
            np.testing.assert_array_equal(mine, ref, err_msg=f)
            continue
        diff = np.abs(mine.astype(int) - ref.astype(int))
        assert diff.max() <= 1, f
        if diff.any():
            raw = f.replace(f"data_{DRIVE_HW[0]}x{DRIVE_HW[1]}", "data_rect")
            img = png.resize_linear(png.read_png(port_root / raw)
                                    .astype(np.float32) / 255.0, DRIVE_HW)
            value = ((img * 2.0 - 1.0) * 0.5 + 0.5) * 255.0
            near = np.abs(value - np.round(value)) < 1e-3
            assert near[diff > 0].all(), f
        differ += int((diff > 0).sum())
        total += diff.size
    assert total > 0 and differ / total < 0.01


def test_make_gate_tree_cut(tmp_path):
    """make_gate_tree at a cut size: raw, semantic and preprocessed frames,
    the test split of its keyframes and a training split of the other
    frames with a neighbour on each side, loadable as the occupancy
    configs load them."""
    root = tgen.make_gate_tree(tmp_path / "gate", frames=5, scale=0.125,
                               keyframes=(1, 3))
    seq = tgen.GATE_SEQ
    test = (root / "splits" / "test_files.txt").read_text().splitlines()
    train = (root / "splits" / "train_files.txt").read_text().splitlines()
    assert test == [f"{seq} 1 l", f"{seq} 3 l"]
    assert train == [f"{seq} 2 l", f"{seq} 2 r"]
    pre = root / "data_2d_raw" / seq / "image_00" / "data_192x640"
    assert png.read_png(pre / "0000000004.png").shape == (192, 640, 3)
    train_ds, test_ds = Kitti360Dataset.make_train_test(
        {"data_path": str(root), "pose_path": str(root / "data_poses"),
         "split_path": str(root / "splits"), "is_preprocessed": True,
         "data_fc": 1, "data_stereo": False, "data_fisheye": False,
         "return_3d_bboxes": True, "return_segmentation": True})
    assert len(train_ds) == 2 and len(test_ds) == 2
    item = test_ds[1]
    assert item["imgs"].shape == (1, 192, 640, 3)
    assert item["segs"].shape == (1, 192, 640) and item["3d_bboxes"]


def test_unported_options_are_refused(fixture_tree):
    """Colour augmentation and the fisheye resample name their ROADMAP
    item; preprocessed fisheye frames need neither."""
    kw = dict(data_path=str(fixture_tree / "data"),
              pose_path=str(fixture_tree / "poses"), split_path=None,
              target_image_size=(48, 176))
    with pytest.raises(NotImplementedError, match="item 7"):
        Kitti360Dataset(color_aug=True, **kw)
    ds = Kitti360Dataset(return_fisheye=True, **kw)
    with pytest.raises(NotImplementedError, match="item 7"):
        ds[0]
