"""RealEstate10K dataset (counterpart of
behindthescenes_tpu/datasets/realestate10k.py; reference
datasets/realestate10k/realestate10k_dataset.py).

Sequences come from `{split}.pickle`: per key its `timestamps`,
normalised `intrinsics` [fx fy cx cy] (converted to NDC here) and
world-to-camera `poses` 3x4 (inverted to camera-to-world). Frames are
`frames/<split>/<key>/<timestamp>.jpg`, read by the port's JPEG reader
(`datasets/jpeg.py`) and resized with OpenCV's float INTER_LINEAR
(`png.resize_linear`). The training split indexes every frame whose
window fits; the test split reads its `key id` index file. `dilation:
random` draws each item's dilation from the dataset's generator before
the colour jitter's draws.
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


class RealEstate10kDataset:
    def __init__(self, data_path: str, split_path: Optional[str] = None,
                 target_image_size=(256, 384), frame_count=2, dilation=1,
                 keyframe_offset=0, color_aug=False, seed=0):
        self.data_path = data_path
        self.split_path = split_path
        self.target_image_size = tuple(target_image_size)
        self.frame_count = frame_count
        self.dilation = dilation
        self.keyframe_offset = keyframe_offset
        self.color_aug = color_aug
        self._rng = np.random.default_rng(seed)

        self.split = "train" if split_path is None else "test"
        self._seq_data = self._load_seq_data(data_path, self.split)
        self._seq_keys = list(self._seq_data.keys())

        if isinstance(dilation, int):
            self._left_offset = ((frame_count - 1) // 2 + keyframe_offset) \
                * dilation
            extra = (frame_count - 1) * dilation
        else:
            self._left_offset = 0
            extra = 0

        if self.split == "train":
            self._key_id_pairs = self._full_index(
                self._seq_keys, self._seq_data, self._left_offset, extra)
        else:
            self._key_id_pairs = self._load_index(split_path)
        self._skip = 0
        self.length = len(self._key_id_pairs)

    @staticmethod
    def _load_seq_data(data_path, split):
        with open(Path(data_path) / f"{split}.pickle", "rb") as f:
            return pickle.load(f)

    @staticmethod
    def _full_index(seq_keys, seq_data, left_offset, extra_frames):
        pairs = []
        for k in seq_keys:
            seq_len = len(seq_data[k]["timestamps"])
            pairs += [(k, i + left_offset)
                      for i in range(seq_len - extra_frames)]
        return pairs

    @staticmethod
    def _load_index(index_path):
        with open(index_path) as f:
            lines = f.readlines()
        return [(p.split(" ")[0], int(p.split(" ")[1])) for p in lines]

    @staticmethod
    def process_pose(pose):
        """w2c 3x4 -> c2w 4x4, inverted in float32."""
        pose = np.concatenate(
            [pose.astype(np.float32),
             np.array([[0, 0, 0, 1]], dtype=np.float32)], axis=0)
        return np.linalg.inv(pose)

    @staticmethod
    def process_projs(proj):
        """Normalised [fx fy cx cy] -> NDC K."""
        k = np.eye(3, dtype=np.float32)
        k[0, 0] = 2 * proj[0]
        k[1, 1] = 2 * proj[1]
        k[0, 2] = 2 * proj[2] - 1
        k[1, 2] = 2 * proj[3] - 1
        return k

    def _load_image(self, key, frame_id):
        ts = self._seq_data[key]["timestamps"][frame_id]
        img = read_jpeg(os.path.join(self.data_path, "frames", self.split,
                                     key, f"{ts}.jpg"))
        return img.astype(np.float32) / 255.0

    def _process_img(self, img, color_aug_fn=None):
        img = resize_linear(img, self.target_image_size)
        if color_aug_fn is not None:
            img = color_aug_fn(img)
        return img * 2.0 - 1.0

    def frame_ids(self, kf, seq_len):
        """The keyframe and the other frames of its window (clamped), with
        the dilation drawn first where it is random."""
        if self.dilation == "random":
            dilation = int(self._rng.integers(1, 30))
            left_offset = self._left_offset
            if self.frame_count > 2:
                left_offset = dilation * (self.frame_count // 2)
        else:
            dilation = self.dilation
            left_offset = self._left_offset
        return [kf] + [max(min(i, seq_len - 1), 0)
                       for i in range(kf - left_offset,
                                      kf - left_offset
                                      + self.frame_count * dilation,
                                      dilation)
                       if i != kf]

    def __len__(self):
        return self.length

    def __getitem__(self, index):
        if index >= self.length:
            raise IndexError()
        index += self._skip
        key, kf = self._key_id_pairs[index]
        seq = self._seq_data[key]
        ids = self.frame_ids(kf, len(seq["timestamps"]))
        color_aug_fn = sample_color_jitter(self._rng) if self.color_aug \
            else None
        imgs = [self._process_img(self._load_image(key, i), color_aug_fn)
                for i in ids]
        poses = [self.process_pose(seq["poses"][i]) for i in ids]
        projs = [self.process_projs(seq["intrinsics"][i]) for i in ids]
        return {
            "imgs": np.stack(imgs).astype(np.float32),
            "projs": np.stack(projs).astype(np.float32),
            "poses": np.stack(poses).astype(np.float32),
            # Unit dummy depth (reference realestate10k_dataset.py:157).
            "depths": np.ones((1, 1) + self.target_image_size,
                              dtype=np.float32),
        }

    @classmethod
    def make_train_test(cls, conf: dict):
        common = dict(
            data_path=conf["data_path"],
            target_image_size=tuple(conf.get("image_size", (256, 384))),
            frame_count=conf.get("data_fc", 2),
            keyframe_offset=conf.get("keyframe_offset", 0),
        )
        train = cls(split_path=None, dilation=conf.get("dilation", 1),
                    color_aug=conf.get("color_aug", False), **common)
        test = cls(split_path=conf.get("split_path"),
                   dilation=conf.get("test_dilation", 10), **common)
        return train, test
