"""TRI Parallel Domain dataset (counterpart of
behindthescenes_tpu/datasets/tri_pd.py; reference
datasets/tri_pd/tri_pd_dataset.py, an unofficial extra): synthetic
driving scenes with moving or all-instance masks, per-camera calibration
JSONs and optional 2D motion vectors. NHWC.

Frames are PNG, read as `cv2.imread` reads them (`png.read_png_color`)
and resized at a ratio of 0.58 on their uint8 pixels as OpenCV does
(`png.resize_linear_u8`, its fixed point); masks and motion vectors are
read as `cv2.imread(path, IMREAD_UNCHANGED)` reads them (16-bit kept,
three channels in BGR order) and resized by INTER_NEAREST. The
calibration's rotation is a quaternion (x, y, z, w), scalar last,
normalised as scipy's `Rotation.from_quat` normalises it. Instances of
at most 50 pixels are removed, and an item whose file is missing is
replaced by the next item, as in the JAX loader.
"""
from __future__ import annotations

import json
import math
import os

import numpy as np

from behindthescenes_tpu_torch.datasets.png import (read_png,
                                                    read_png_color,
                                                    resize_linear_u8,
                                                    resize_nearest)

# Scenes excluded upstream for broken annotations
# (reference tri_pd_dataset.py:17-24).
BANNED_SCENES = {
    "scene_000100", "scene_000002", "scene_000008", "scene_000012",
    "scene_000018", "scene_000029", "scene_000038", "scene_000040",
    "scene_000043", "scene_000044", "scene_000049", "scene_000050",
    "scene_000053", "scene_000063", "scene_000079", "scene_000090",
    "scene_000094", "scene_000103", "scene_000106", "scene_000111",
    "scene_000112", "scene_000124", "scene_000125", "scene_000127",
    "scene_000148", "scene_000159", "scene_000166", "scene_000169",
    "scene_000170", "scene_000171", "scene_000187", "scene_000191",
    "scene_000200", "scene_000202", "scene_000217", "scene_000218",
    "scene_000225", "scene_000229", "scene_000232", "scene_000236",
    "scene_000237", "scene_000245", "scene_000249", "scene_000196",
    "scene_000156",
}

BASE_SIZE = (1216, 1936)
RATIO = 0.58
CROP = 158


def quat_to_matrix(q) -> np.ndarray:
    """The rotation matrix of a quaternion (x, y, z, w), scalar last,
    normalised first: scipy's `Rotation.from_quat(q).as_matrix()`, its
    operations in its order (bit-equal)."""
    x, y, z, w = np.asarray(q, np.float64)
    norm = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / norm, y / norm, z / norm, w / norm
    x2, y2, z2, w2 = x * x, y * y, z * z, w * w
    xy, zw, xz, yw, yz, xw = x * y, z * w, x * z, y * w, y * z, x * w
    return np.array([[x2 - y2 - z2 + w2, 2 * (xy - zw), 2 * (xz + yw)],
                     [2 * (xy + zw), -x2 + y2 - z2 + w2, 2 * (yz - xw)],
                     [2 * (xz - yw), 2 * (yz + xw), -x2 - y2 + z2 + w2]])


def read_unchanged(path) -> np.ndarray:
    """`cv2.imread(path, IMREAD_UNCHANGED)` of a grey or RGB PNG: its
    bit depth kept, three channels in BGR order."""
    img = read_png(path)
    return img[..., ::-1].copy() if img.ndim == 3 else img


class TRIPDDataset:
    def __init__(self, split="train", root=None, supervision="moving",
                 frame_count=5, random_select=True, load_flow=False,
                 load_segs=True, seed=0):
        self.root_dir = root
        self.frame_count = frame_count
        self.random_select = random_select
        self.load_flow = load_flow
        self.load_segs = load_segs
        self._rng = np.random.default_rng(seed)

        files = sorted(os.listdir(root))
        if split == "train":
            files = files[1:]
        elif split == "eval":
            files = files[:1]
        if supervision == "moving":
            self.annotation = "moving_masks"
        elif supervision == "all":
            self.annotation = "ari_masks"
        else:
            raise ValueError("supervision must be 'moving' or 'all'")

        self.real_files, self.mask_files = [], []
        self.flow_files, self.calibrations = [], []
        for f in files:
            if f in BANNED_SCENES or not f.startswith("scene"):
                continue
            calib_dir = os.path.join(root, f, "calibration")
            with open(os.path.join(calib_dir,
                                   os.listdir(calib_dir)[0])) as cf:
                calib = json.load(cf)
            for i in (1, 5, 6, 7, 8, 9):
                if os.path.exists(os.path.join(root, f,
                                               f"rgb/camera_0{i}")):
                    self.real_files.append(f + f"/rgb/camera_0{i}")
                    self.mask_files.append(
                        f + f"/{self.annotation}/camera_0{i}")
                    self.flow_files.append(
                        f + f"/motion_vectors_2d/camera_0{i}")
                    self.calibrations.append(self.get_camera(calib, i))

    @staticmethod
    def get_image_name(i):
        return f"{(i + 1) * 5:018d}.png"

    @staticmethod
    def get_camera(calib_data, i):
        cam_idx = calib_data["names"].index(f"camera_0{i}")
        ext = calib_data["extrinsics"][cam_idx]
        intr = calib_data["intrinsics"][cam_idx]
        rot = quat_to_matrix(list(ext["rotation"].values()))
        local_pose = np.concatenate(
            [rot, np.array(list(ext["translation"].values()))
             .reshape(-1, 1)], axis=-1)
        proj = np.eye(4)
        proj[0, 0] = intr["fx"] * 2 / BASE_SIZE[1]
        proj[1, 1] = intr["fy"] * 2 / BASE_SIZE[0]
        proj[0, 2] = intr["cx"] / BASE_SIZE[1] - 0.5
        proj[1, 2] = intr["cy"] / BASE_SIZE[0] - 0.5
        return {"local_pose": local_pose, "projection_mat": proj}

    def __len__(self):
        return len(self.real_files) * (1 if self.random_select else 190)

    def __getitem__(self, index):
        if self.random_select:
            rand_id = int(self._rng.integers(0, 190)) + 1
            frame_ids = [rand_id + j for j in range(self.frame_count)]
            index %= len(self.real_files)
        else:
            offset = index % 190
            index //= 190
            frame_ids = [offset + j for j in range(self.frame_count)]

        path = self.real_files[index]
        imgs, segs, flows = [], [], []
        for fid in frame_ids:
            name = self.get_image_name(fid)
            img_path = os.path.join(self.root_dir, path, name)
            if not os.path.exists(img_path):
                return self.__getitem__((index + 1) % len(self))
            img = read_png_color(img_path)
            dim = (int(math.ceil(img.shape[0] * RATIO)),
                   int(math.ceil(img.shape[1] * RATIO)))
            img = resize_linear_u8(img, dim)[CROP:]
            imgs.append(img.astype(np.float32) / 255.0 * 2.0 - 1.0)

            if self.load_segs:
                seg_path = os.path.join(self.root_dir,
                                        self.mask_files[index], name)
                if not os.path.exists(seg_path):
                    return self.__getitem__((index + 1) % len(self))
                seg = resize_nearest(read_unchanged(seg_path), dim)[CROP:]
                # Remove tiny instances (<= 50 px), matching upstream.
                values, indices, counts = np.unique(
                    seg, return_inverse=True, return_counts=True)
                mapping = np.arange(len(values))
                mapping[counts <= 50] = 0
                segs.append(mapping[indices].reshape(seg.shape))

            if self.load_flow:
                flow_path = os.path.join(self.root_dir,
                                         self.flow_files[index], name)
                if os.path.exists(flow_path):
                    flows.append(resize_nearest(read_unchanged(flow_path),
                                                dim)[CROP:])

        calib = self.calibrations[index]
        out = {
            "imgs": np.stack(imgs).astype(np.float32),
            "projs": np.stack([calib["projection_mat"]] * len(imgs)),
            "poses": np.stack([np.vstack([calib["local_pose"],
                                          [0, 0, 0, 1]])] * len(imgs)),
            "meta-data": np.array([index]),
        }
        if segs:
            out["segs"] = np.stack(segs)
        if flows:
            out["flows"] = np.stack(flows)
        return out
