"""KITTI odometry dataset (counterpart of
behindthescenes_tpu/datasets/kitti_odom.py; reference
datasets/kitti_odom/kitti_odometry_dataset.py): sequences 00-21, the
keyframe centred among `frame_count` frames, an optional stereo pair and
custom (e.g. DSO) pose files; a central crop to the target's aspect
ratio and NDC intrinsics.

Frames are PNG, read as `cv2.imread` reads them (`png.read_png_color`:
three 8-bit channels) and resized with OpenCV's float INTER_LINEAR
(`png.resize_linear`), so items are bit-equal to the JAX loader's.
"""
from __future__ import annotations

import os

import numpy as np

from behindthescenes_tpu_torch.datasets.kitti_raw import (apply_crop,
                                                          ndc_intrinsics,
                                                          parse_calib_file)
from behindthescenes_tpu_torch.datasets.png import (read_png_color,
                                                    resize_linear)

BASE_SIZES = {
    "00": (376, 1241), "01": (376, 1241), "02": (376, 1241),
    "03": (375, 1242), "04": (370, 1226), "05": (370, 1226),
    "06": (370, 1226), "07": (370, 1226), "08": (370, 1226),
    "09": (370, 1226), "10": (370, 1226), "11": (370, 1226),
    "12": (370, 1226), "13": (376, 1241), "14": (376, 1241),
    "15": (376, 1241), "16": (376, 1241), "17": (376, 1241),
    "18": (376, 1241), "19": (376, 1241), "20": (376, 1241),
    "21": (376, 1241),
}


class KittiOdometryDataset:
    def __init__(self, base_path: str, frame_count=2, sequences=None,
                 target_image_size=(256, 512), dilation=1,
                 return_stereo=False, custom_pose_path=None,
                 keyframe_offset=0):
        self.dataset_dir = base_path
        self.frame_count = frame_count
        self.sequences = sequences or [f"{i:02d}" for i in range(11)]
        self.target_image_size = tuple(target_image_size)
        self.dilation = dilation
        self.return_stereo = return_stereo
        self.custom_pose_path = custom_pose_path
        self.keyframe_offset = keyframe_offset

        self._sequence_folders = [
            os.path.join(base_path, "sequences", s) for s in self.sequences]
        self._files_cam2 = [sorted(os.listdir(os.path.join(f, "image_2")))
                            for f in self._sequence_folders]
        self._files_cam3 = [sorted(os.listdir(os.path.join(f, "image_3")))
                            if os.path.isdir(os.path.join(f, "image_3"))
                            else [] for f in self._sequence_folders]
        extra = frame_count * dilation
        self._sequence_lengths = [len(fs) - extra for fs in self._files_cam2]
        self._calibs = self._load_calibs(self._sequence_folders,
                                         self.target_image_size)
        self._poses = self._load_poses(base_path, self.sequences,
                                       custom_pose_path)
        self._keyframe_idx = frame_count // 2 + keyframe_offset
        if not 0 <= self._keyframe_idx < frame_count:
            raise ValueError(f"keyframe {self._keyframe_idx} outside the "
                             f"{frame_count} frames")
        self.length = sum(self._sequence_lengths)
        self._skip = 0

    @staticmethod
    def _load_calibs(sequence_folders, target_size):
        calibs = []
        for folder in sequence_folders:
            im_size = BASE_SIZES[folder[-2:]]
            data = parse_calib_file(os.path.join(folder, "calib.txt"))
            p2 = data["P2"].reshape(3, 4)
            p3 = data["P3"].reshape(3, 4)
            t_0 = np.eye(4, dtype=np.float32)
            t_0[0, 3] = p2[0, 3] / p2[0, 0]
            t_1 = np.eye(4, dtype=np.float32)
            t_1[0, 3] = p3[0, 3] / p3[0, 0]
            # Poses centred on the left colour camera (reference
            # kitti_odometry_dataset.py:111-114).
            t_1 = np.linalg.inv(t_1) @ t_0
            t_0 = np.eye(4, dtype=np.float32)
            k_ndc, box = ndc_intrinsics(p2[:3, :3].copy(), im_size,
                                        target_size, keep_aspect_ratio=True)
            calibs.append({"K": k_ndc, "T_0": t_0, "T_1": t_1, "crop": box})
        return calibs

    @staticmethod
    def _load_poses(dataset_dir, sequences, custom_pose_path=None):
        """Each sequence's poses (n, 4, 4) float32 from its KITTI pose
        file (3x4 row-major a line); no file gives none."""
        pose_path = custom_pose_path or os.path.join(dataset_dir, "poses")
        poses = []
        for seq in sequences:
            seq_poses = []
            pose_file = os.path.join(pose_path, seq + ".txt")
            if os.path.exists(pose_file):
                with open(pose_file) as f:
                    for line in f.readlines():
                        mat = np.array(line.split(), dtype=np.float64)
                        seq_poses.append(np.vstack(
                            [mat.reshape(3, 4), [0, 0, 0, 1]]))
            poses.append(np.array(seq_poses, dtype=np.float32))
        return poses

    def get_sequence_index(self, index):
        for ds_index, size in enumerate(self._sequence_lengths):
            if index >= size:
                index -= size
            else:
                return ds_index, index
        return None, None

    def _process_img(self, img, crop_box):
        if crop_box:
            img = apply_crop(img, crop_box)
        img = resize_linear(np.ascontiguousarray(img), self.target_image_size)
        return img * 2.0 - 1.0

    def __len__(self):
        return self.length

    def __getitem__(self, index):
        index += self._skip
        seq_idx, index = self.get_sequence_index(index)
        if seq_idx is None:
            raise IndexError()
        calibs = self._calibs[seq_idx]
        folder = self._sequence_folders[seq_idx]
        ids = [index + i * self.dilation for i in range(self.frame_count)]

        def load(cam_files, cam_dir):
            return [self._process_img(read_png_color(os.path.join(
                folder, cam_dir, cam_files[seq_idx][i])).astype(np.float32)
                / 255, calibs["crop"]) for i in ids]

        imgs = load(self._files_cam2, "image_2")
        imgs_st = load(self._files_cam3, "image_3") if self.return_stereo \
            else []
        poses = [self._poses[seq_idx][i] @ calibs["T_0"] for i in ids]
        poses_st = [self._poses[seq_idx][i] @ calibs["T_1"] for i in ids] \
            if self.return_stereo else []
        projs = [calibs["K"]] * len(ids)

        def key_first(lst):
            k = self._keyframe_idx
            return [lst[k]] + lst[:k] + lst[k + 1:]

        imgs, poses = key_first(imgs), key_first(poses)
        if self.return_stereo:
            imgs_st, poses_st = key_first(imgs_st), key_first(poses_st)
        all_projs = projs + ([calibs["K"]] * len(ids)
                             if self.return_stereo else [])
        return {
            "imgs": np.stack(imgs + imgs_st).astype(np.float32),
            "projs": np.stack(all_projs).astype(np.float32),
            "poses": np.stack(poses + poses_st).astype(np.float32),
            "sequence": np.array([seq_idx], np.int32),
            "ids": np.array(ids, np.int32),
        }

    @classmethod
    def make_train_test(cls, conf: dict):
        common = dict(
            base_path=conf["data_path"],
            frame_count=conf.get("data_fc", 2),
            target_image_size=tuple(conf.get("image_size", (256, 512))),
            dilation=conf.get("dilation", 1),
            return_stereo=conf.get("data_stereo", False),
            custom_pose_path=conf.get("pose_path", None),
        )
        train = cls(sequences=conf.get("train_sequences"), **common)
        test = cls(sequences=conf.get("test_sequences", ["09", "10"]),
                   **common)
        return train, test
