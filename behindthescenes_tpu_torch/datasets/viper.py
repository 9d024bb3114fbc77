"""VIPER synthetic dataset (counterpart of
behindthescenes_tpu/datasets/viper.py; reference
datasets/viper/viper_dataset.py, an unofficial extra): images, instance
segmentations and optical flow with per-frame projection and view
matrices from the camera CSVs. NHWC.

JPEG frames through the port's decoder (bit-equal to `cv2.imread`),
segmentation PNGs read as `cv2.imread` reads them (`png.read_png_color`,
RGB), `.npz` flow with NaN set to 0; every frame cropped twice (the fixed
letterbox, then to the target's aspect ratio), images resized with
OpenCV's float INTER_LINEAR, segmentation and flow with INTER_NEAREST,
so items are bit-equal to the JAX loader's.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from behindthescenes_tpu_torch.datasets.jpeg import read_jpeg
from behindthescenes_tpu_torch.datasets.png import (read_png_color,
                                                    resize_linear,
                                                    resize_nearest)

ID_TO_CLASS = {
    0: "unlabeled", 1: "ambiguous", 2: "sky", 3: "road", 4: "sidewalk",
    5: "railtrack", 6: "terrain", 7: "tree", 8: "vegetation", 9: "building",
    10: "infrastructure", 11: "fence", 12: "billboard", 13: "trafficlight",
    14: "trafficsign", 15: "mobilebarrier", 16: "firehydrant", 17: "chair",
    18: "trash", 19: "trashcan", 20: "person", 21: "animal", 22: "bicycle",
    23: "motorcycle", 24: "car", 25: "van", 26: "bus", 27: "truck",
    28: "trailer", 29: "train", 30: "plane", 31: "boat",
}
DYNAMIC_CLASS_IDS = np.array([20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
                              31])
BASE_SIZE = (1080, 1920)
BASE_CROP = (180, 0, 720, 1920)  # (y, x, h, w)


def _apply_crop(img, box):
    y, x, h, w = box
    return img[int(y):int(y) + int(h), int(x):int(x) + int(w)]


class ViperDataset:
    def __init__(self, base_path: str, frame_count=2, every_nth=10,
                 target_size=(128, 192), load_flow=True, load_segs=True):
        self.base_path = base_path
        self.frame_count = frame_count
        self.every_nth = every_nth
        self.target_size = tuple(target_size)
        self.load_flow = load_flow
        self.load_segs = load_segs

        self.sequences = sorted(os.listdir(os.path.join(base_path, "img")))
        self.img_paths = [sorted(glob.glob(os.path.join(
            base_path, "img", s, "*.jpg"))) for s in self.sequences]
        self.flow_paths = [sorted(glob.glob(os.path.join(
            base_path, "flow", s, "*.npz"))) for s in self.sequences]
        self.seg_paths = [sorted(glob.glob(os.path.join(
            base_path, "inst", s, "*.png"))) for s in self.sequences]

        self.projection_mats, self.view_mats = self._load_cameras()
        self.sequence_lengths = [
            (len(p) - frame_count + 1) // every_nth for p in self.img_paths]
        self.crop, cam_scale = self._precompute_crop()
        self.projection_mats = [p @ cam_scale for p in self.projection_mats]

    def _load_cameras(self):
        cam_dir = os.path.join(self.base_path, "camera")
        projs, views = [], []
        for s in self.sequences:
            raw = np.loadtxt(os.path.join(cam_dir, f"{s}.csv"),
                             delimiter=",", skiprows=1)
            projs.append(raw[:, 1:17].reshape(-1, 4, 4))
            views.append(raw[:, 17:].reshape(-1, 4, 4))
        return projs, views

    def _precompute_crop(self):
        h_ratio = self.target_size[0] / BASE_CROP[2]
        w_ratio = self.target_size[1] / BASE_CROP[3]
        if h_ratio < w_ratio:
            h_new = int(self.target_size[0] / w_ratio)
            w_new = BASE_CROP[3]
            crop = ((BASE_CROP[2] - h_new) // 2, 0, h_new, w_new)
        else:
            h_new = BASE_CROP[2]
            w_new = int(self.target_size[1] / h_ratio)
            crop = (0, (BASE_CROP[3] - w_new) // 2, h_new, w_new)
        cam_scale = np.eye(4)
        cam_scale[0, 0] = BASE_SIZE[1] / w_new
        cam_scale[1, 1] = BASE_SIZE[0] / h_new
        return crop, cam_scale

    def _crops(self, img):
        return _apply_crop(_apply_crop(img, BASE_CROP), self.crop)

    def __len__(self):
        return sum(self.sequence_lengths)

    def __getitem__(self, index):
        if index >= len(self):
            raise IndexError
        seq = 0
        while seq < len(self.sequence_lengths) and \
                index >= self.sequence_lengths[seq]:
            index -= self.sequence_lengths[seq]
            seq += 1

        imgs, segs, flows = [], [], []
        for i in range(self.frame_count):
            frame = index * self.every_nth + i
            img = read_jpeg(self.img_paths[seq][frame]).astype(np.float32) \
                / 255
            imgs.append(resize_linear(self._crops(img), self.target_size)
                        * 2.0 - 1.0)
            if self.load_segs:
                seg = resize_nearest(self._crops(read_png_color(
                    self.seg_paths[seq][frame])), self.target_size)
                cls = np.any(seg[:, :, :1] == DYNAMIC_CLASS_IDS,
                             axis=-1).astype(np.int32)
                iid = seg[:, :, 1].astype(np.int32) * 256 + seg[:, :, 2]
                segs.append(np.stack([cls, iid], axis=-1))

        if self.load_flow:
            flow = np.load(self.flow_paths[seq][index])
            flow = np.stack((flow["u"], flow["v"]), axis=-1)
            flow[np.isnan(flow)] = 0
            flow3 = np.concatenate(
                [flow, np.zeros(BASE_SIZE + (1,))], axis=-1)
            flows.append(resize_nearest(self._crops(flow3),
                                        self.target_size)[:, :, :2])

        out = {
            "imgs": np.stack(imgs).astype(np.float32),
            "projs": np.stack([self.projection_mats[seq][index + i]
                               for i in range(self.frame_count)]),
            "poses": np.stack([self.view_mats[seq][index + i]
                               for i in range(self.frame_count)]),
            "meta-data": np.array([seq, index]),
        }
        if segs:
            out["segs"] = np.stack(segs)
        if flows:
            out["flows"] = np.stack(flows).astype(np.float32)
        return out
