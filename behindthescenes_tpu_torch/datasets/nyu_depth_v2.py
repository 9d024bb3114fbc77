"""NYU Depth v2 labeled test set (counterpart of
behindthescenes_tpu/datasets/nyu_depth_v2.py; reference
datasets/nyu_depth_v2/nyu_depth_v2_dataset.py): single-frame depth test
items from `nyu_depth_v2_labeled.mat`, with the identity pose and
intrinsics.

The `.mat` is MATLAB v7.3, which is HDF5 behind a 512-byte user block;
the port reads it with its own reader (`datasets/hdf5.py`), one item's
chunks at a time. MATLAB stores its arrays transposed: images are (N, 3,
W, H) uint8 and depths (N, W, H) float32. Images are resized with
OpenCV's float INTER_LINEAR (`png.resize_linear`), depths with
INTER_NEAREST, so items are bit-equal to the JAX loader's.
"""
from __future__ import annotations

import os

import numpy as np

from behindthescenes_tpu_torch.datasets import hdf5
from behindthescenes_tpu_torch.datasets.png import (resize_linear,
                                                    resize_nearest)


class NYUDepthV2Dataset:
    def __init__(self, data_path, target_image_size=(192, 640)):
        self.data_path = data_path
        self.target_image_size = tuple(target_image_size) \
            if target_image_size else None
        self._data = hdf5.File(os.path.join(data_path,
                                            "nyu_depth_v2_labeled.mat"))
        self.length = self._data["images"].shape[0]

    def _process_img(self, img):
        img = np.transpose(img, (2, 1, 0)).astype(np.float32) / 255.0
        if self.target_image_size:
            img = resize_linear(img, self.target_image_size)
        return img * 2.0 - 1.0

    def _process_depth(self, depth):
        depth = np.transpose(depth, (1, 0))
        if self.target_image_size:
            depth = resize_nearest(depth, self.target_image_size)
        return depth[None]

    def __len__(self):
        return self.length

    def __getitem__(self, index):
        img = self._process_img(self._data["images"][index])
        depth = self._process_depth(self._data["depths"][index])
        return {
            "imgs": img[None].astype(np.float32),
            "depths": depth[None].astype(np.float32),
            "poses": np.eye(4, dtype=np.float32)[None],
            "projs": np.eye(3, dtype=np.float32)[None],
        }

    @classmethod
    def make_test(cls, conf: dict):
        return cls(conf["data_path"],
                   tuple(conf.get("image_size", (192, 640))))
