"""Waymo dataset (counterpart of behindthescenes_tpu/datasets/waymo.py;
reference datasets/waymo/waymo_dataset.py): 5 cameras (the front one and
the 45 and 90 degree pairs to its left and right) whose frames are taken
`offset_45` and `offset_90` frames after the front camera's, pickled
calibrations and exposures (numpy arrays), `.npy` poses and LiDAR, and
an optional exposure correction in linear light (gamma 2.2).

Frames are JPEG, read by the port's decoder (`datasets/jpeg.py`,
bit-equal to `cv2.imread`), resized with OpenCV's float INTER_LINEAR
(`png.resize_linear`); the colour jitter is the port's copy of the JAX
package's, drawn in the same order, so items are bit-equal to the JAX
loader's.
"""
from __future__ import annotations

import os
import pickle
from pathlib import Path
from typing import Optional

import numpy as np

from behindthescenes_tpu_torch.datasets.augmentation import \
    sample_color_jitter
from behindthescenes_tpu_torch.datasets.jpeg import read_jpeg
from behindthescenes_tpu_torch.datasets.png import resize_linear

CAMERAS = (1, 2, 3, 4, 5)


class WaymoDataset:
    def __init__(self, data_path: str, mode: str,
                 split_path: Optional[str] = None,
                 target_image_size=(320, 480), return_45=True,
                 return_90=True, return_depth=False, frame_count=2,
                 keyframe_offset=0, dilation=1, offset_45=5, offset_90=10,
                 color_aug=False, correct_exposure=False, seed=0):
        self.data_path = str(Path(data_path) / mode)
        self.split_path = split_path
        self.target_image_size = tuple(target_image_size)
        self.return_45 = return_45
        self.return_90 = return_90
        self.return_depth = return_depth
        self.frame_count = frame_count
        self.keyframe_offset = keyframe_offset
        self.dilation = dilation
        self.offset_45 = offset_45
        self.offset_90 = offset_90
        self.color_aug = color_aug
        self.correct_exposure = correct_exposure
        self._rng = np.random.default_rng(seed)

        self._sequences = [s.name for s in Path(self.data_path).iterdir()
                           if s.is_dir()]
        self._calibs, self._exposures, self._poses = {}, {}, {}
        for seq in self._sequences:
            seq_dir = Path(self.data_path) / seq
            with (seq_dir / "calibration.pkl").open("rb") as f:
                self._calibs[seq] = pickle.load(f)
            self._poses[seq] = np.load(str(seq_dir / "poses.npy"))
            exp_file = seq_dir / "exposures.pkl"
            if exp_file.exists():
                with exp_file.open("rb") as f:
                    self._exposures[seq] = pickle.load(f)

        self._left_offset = ((frame_count - 1) // 2 + keyframe_offset) \
            * dilation
        if split_path is not None:
            with open(split_path) as f:
                self._datapoints = [(ln.split(" ")[0], int(ln.split(" ")[1]))
                                    for ln in f.readlines()]
        else:
            self._datapoints = [(seq, i) for seq in sorted(self._sequences)
                                for i in range(len(self._poses[seq]))]
        self._skip = 0
        self.length = len(self._datapoints)

    def _process_img(self, img, color_aug_fn=None, exposure_corr=None):
        th, tw = self.target_image_size
        if img.shape[:2] != (th, tw):
            img = resize_linear(img, (th, tw))
        if exposure_corr is not None:
            img = np.clip((img ** 2.2 * exposure_corr) ** (1 / 2.2), 0, 1)
        if color_aug_fn is not None:
            img = color_aug_fn(img)
        return img * 2.0 - 1.0

    def _load_image(self, seq, cam, frame_id):
        return read_jpeg(os.path.join(
            self.data_path, seq, "frames", f"cam_{cam:02d}",
            f"{frame_id:010d}.jpg")).astype(np.float32) / 255.0

    def load_depth(self, seq, frame_id):
        """The LiDAR points of a frame (vehicle frame) projected into the
        front camera at the target size: (1, th, tw) float32, 0 where no
        point lands; where several land on one pixel the last one's depth
        stays (numpy's assignment order)."""
        points = np.load(os.path.join(self.data_path, seq, "lidar",
                                      f"{frame_id:010d}.npy")) \
            .astype(np.float32).reshape(-1, 3)
        pts_h = np.concatenate([points, np.ones_like(points[:, :1])], 1)
        calib = self._calibs[seq]
        cam = (calib["proj_mats"][1]
               @ np.linalg.inv(calib["extrinsics"][1])[:3]) @ pts_h.T
        cam = cam.T
        with np.errstate(divide="ignore", invalid="ignore"):  # z = 0: out
            cam[:, :2] = cam[:, :2] / cam[:, 2:3]
        th, tw = self.target_image_size
        mask = ((cam[:, 0] > -1) & (cam[:, 0] < 1) & (cam[:, 1] > -1)
                & (cam[:, 1] < 1) & (cam[:, 2] > 0))
        cam = cam[mask]
        depth = np.zeros((th, tw), dtype=np.float32)
        ys = np.clip(((cam[:, 1] * 0.5 + 0.5) * th).astype(np.int64), 0,
                     th - 1)
        xs = np.clip(((cam[:, 0] * 0.5 + 0.5) * tw).astype(np.int64), 0,
                     tw - 1)
        depth[ys, xs] = cam[:, 2]
        depth[depth < 0] = 0
        return depth[None]

    def frame_ids(self, seq, kf):
        """{camera: frame ids}: the keyframe, then the rest of its window,
        clamped to the sequence; the side cameras offset_45 / offset_90
        frames later."""
        seq_len = self._poses[seq].shape[0]
        ids = [kf] + [max(min(i, seq_len - 1), 0)
                      for i in range(kf - self._left_offset,
                                     kf - self._left_offset
                                     + self.frame_count * self.dilation,
                                     self.dilation)
                      if i != kf]
        ids_45 = [max(min(i + self.offset_45, seq_len - 1), 0)
                  for i in ids] if self.return_45 else []
        ids_90 = [max(min(i + self.offset_90, seq_len - 1), 0)
                  for i in ids] if self.return_90 else []
        return {1: ids, 2: ids_45, 3: ids_45, 4: ids_90, 5: ids_90}

    def __len__(self):
        return self.length

    def __getitem__(self, index):
        if index >= self.length:
            raise IndexError()
        index += self._skip
        seq, kf = self._datapoints[index]
        cam_ids = self.frame_ids(seq, kf)
        color_aug_fn = sample_color_jitter(self._rng) if self.color_aug \
            else None
        if self.correct_exposure and seq in self._exposures:
            exp = self._exposures[seq]
            all_exp = np.concatenate(
                [np.asarray(exp[c])[cam_ids[c]] for c in cam_ids
                 if len(cam_ids[c])])
            median = np.median(all_exp)
            corr = {c: [median / exp[c][i] for i in cam_ids[c]]
                    for c in cam_ids}
        else:
            corr = {c: [None] * len(cam_ids[c]) for c in cam_ids}

        imgs, poses, projs = [], [], []
        calib = self._calibs[seq]
        for cam in CAMERAS:
            for i, frame_id in enumerate(cam_ids[cam]):
                imgs.append(self._process_img(
                    self._load_image(seq, cam, frame_id), color_aug_fn,
                    corr[cam][i]))
                poses.append(self._poses[seq][frame_id]
                             @ calib["extrinsics"][cam])
                projs.append(calib["proj_mats"][cam])
        out = {
            "imgs": np.stack(imgs).astype(np.float32),
            "projs": np.stack(projs).astype(np.float32),
            "poses": np.stack(poses).astype(np.float32),
        }
        if self.return_depth:
            out["depths"] = self.load_depth(seq, cam_ids[1][0])[None]
        return out

    @classmethod
    def make_train_test(cls, conf: dict):
        common = dict(
            data_path=conf["data_path"],
            target_image_size=tuple(conf.get("image_size", (320, 480))),
            frame_count=conf.get("data_fc", 2),
            dilation=conf.get("dilation", 1),
            offset_45=conf.get("offset_45", 5),
            offset_90=conf.get("offset_90", 10),
            correct_exposure=conf.get("correct_exposure", False),
        )
        train = cls(mode="training", split_path=None,
                    color_aug=conf.get("color_aug", False), **common)
        test = cls(mode="validation", split_path=conf.get("split_path"),
                   return_depth=True, **common)
        return train, test
