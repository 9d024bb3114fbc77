"""KITTI-360 dataset (counterpart of
behindthescenes_tpu/datasets/kitti_360.py; reference
datasets/kitti_360/kitti_360_dataset.py).

Four cameras per frame: two rectified perspective (image_00/01), mono or
stereo, raw (`data_rect`, resized here) or preprocessed (`data_<h>x<w>`),
and two fisheye (image_02/03), resampled to pinhole here through the
mirror and distortion model (`datasets/remap.py`, OpenCV's remap) or
preprocessed (`data_<h>x<w>_<r0>x<r1>`); the calibration chain
cam <-> pose <-> velo, velodyne depth, 3D bounding boxes, semantic
segmentation maps, and the colour augmentation of training
(`datasets/augmentation.py`, one jitter per item from the dataset's
`seed` generator, applied to every view). Images are read by the port's
own PNG reader and resized with OpenCV's semantics (`datasets/png.py`);
the fisheye calibration is read by the port's YAML parser
(`config.loads`).

Data-dict ABI: imgs (v, h, w, 3) in [-1, 1] NHWC, projs (v, 3, 3) NDC,
poses (v, 4, 4) c2w, plus depths / 3d_bboxes / segs / ts / index.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from collections import Counter, defaultdict
from pathlib import Path
from typing import Optional

import numpy as np

from behindthescenes_tpu_torch.config import loads as yaml_loads
from behindthescenes_tpu_torch.datasets.augmentation import \
    sample_color_jitter
from behindthescenes_tpu_torch.datasets.kitti_raw import parse_calib_file
from behindthescenes_tpu_torch.datasets.png import (read_png, resize_linear,
                                                    resize_nearest)
from behindthescenes_tpu_torch.datasets.remap import remap_linear


def euler_xy(angles_deg) -> np.ndarray:
    """Rotation matrices (n, 3, 3) of extrinsic x-then-y Euler angles in
    degrees, (n, 2): scipy's Rotation.from_euler("xy", angles,
    degrees=True).as_matrix(), i.e. R_y(b) @ R_x(a)."""
    a, b = np.deg2rad(np.asarray(angles_deg, dtype=np.float64)).T
    ca, sa, cb, sb = np.cos(a), np.sin(a), np.cos(b), np.sin(b)
    zero, one = np.zeros_like(a), np.ones_like(a)
    r_x = np.stack([one, zero, zero, zero, ca, -sa, zero, sa, ca],
                   -1).reshape(-1, 3, 3)
    r_y = np.stack([cb, zero, sb, zero, one, zero, -sb, zero, cb],
                   -1).reshape(-1, 3, 3)
    return r_y @ r_x


def read_fisheye_yaml(path) -> dict:
    """An OpenCV-storage fisheye calibration: the first line (`%YAML:1.0`)
    is skipped, as the JAX loader skips it, and so is a `---` document
    marker after it; the rest goes through the port's YAML parser."""
    with open(path) as f:
        f.readline()
        lines = f.read().split("\n")
    if lines and lines[0].strip() == "---":
        lines = lines[1:]
    return yaml_loads("\n".join(lines), str(path))


class FisheyeToPinholeSampler:
    """Fisheye -> pinhole resample map (reference kitti_360_dataset.py:
    21-69): the MEI mirror model and radial distortion map the target
    pinhole rays to fisheye pixels (align_corners=True). The map is built
    as the JAX loader builds it and the resample is OpenCV's bilinear
    remap with a zero border (`remap_linear`)."""

    def __init__(self, k_target, target_image_size, calibs, rotation=None):
        h, w = target_image_size
        x = np.linspace(-1, 1, w, dtype=np.float64)[None, :].repeat(h, 0)
        y = np.linspace(-1, 1, h, dtype=np.float64)[:, None].repeat(w, 1)
        z = np.ones_like(x)
        xyz = np.stack([x, y, z], axis=-1).reshape(-1, 3)
        xyz = (np.linalg.inv(k_target) @ xyz.T).T
        if rotation is not None:
            xyz = (rotation @ xyz.T).T
        xyz = xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)

        xi = calibs["mirror_parameters"]["xi"]
        xs = xyz[:, 0] / (xyz[:, 2] + xi)
        ys = xyz[:, 1] / (xyz[:, 2] + xi)

        k1 = calibs["distortion_parameters"]["k1"]
        k2 = calibs["distortion_parameters"]["k2"]
        r = xs * xs + ys * ys
        factor = 1 + k1 * r + k2 * r * r
        xs = xs * factor
        ys = ys * factor

        pp = calibs["projection_parameters"]
        xs = xs * pp["gamma1"] + pp["u0"]
        ys = ys * pp["gamma2"] + pp["v0"]
        self._src_size = (calibs["image_height"], calibs["image_width"])
        sh, sw = self._src_size
        self.map_x = ((xs + 1) * 0.5 * (sw - 1)).reshape(h, w) \
            .astype(np.float32)
        self.map_y = ((ys + 1) * 0.5 * (sh - 1)).reshape(h, w) \
            .astype(np.float32)

    def resample(self, img: np.ndarray) -> np.ndarray:
        return remap_linear(img, self.map_x, self.map_y)


class KITTI360Bbox3D:
    """3D bounding box record (reference datasets/kitti_360/annotation.py).
    """

    def __init__(self):
        self.vertices = None
        self.faces = None
        self.semanticId = -1
        self.instanceId = -1
        self.timestamp = -1
        self.name = ""

    def _parse_vertices(self, child):
        transform = None
        verts = None
        faces = None
        for grandchild in child:
            if grandchild.tag == "transform":
                rows = grandchild.find("data").text.split()
                transform = np.array(list(map(float, rows))).reshape(4, 4)
            if grandchild.tag == "vertices":
                rows = grandchild.find("data").text.split()
                verts = np.array(list(map(float, rows))).reshape(-1, 3)
            if grandchild.tag == "faces":
                rows = grandchild.find("data").text.split()
                faces = np.array(list(map(float, rows))).reshape(-1, 3) \
                    .astype(np.int32)
        if transform is not None and verts is not None:
            verts_h = np.concatenate(
                [verts, np.ones_like(verts[:, :1])], axis=-1)
            verts = (transform @ verts_h.T).T[:, :3]
        self.vertices = verts
        self.faces = faces

    def parseBbox(self, child):
        self.semanticId = int(child.find("semanticId").text)
        self.instanceId = int(child.find("instanceId").text)
        ts = child.find("timestamp")
        self.timestamp = int(ts.text) if ts is not None else -1
        label = child.find("label")
        self.name = label.text if label is not None else ""
        self._parse_vertices(child)

    def parseStuff(self, child):
        label = child.find("label")
        self.name = label.text if label is not None else ""
        ts = child.find("timestamp")
        self.timestamp = int(ts.text) if ts is not None else -1
        self._parse_vertices(child)


class Kitti360Dataset:
    def __init__(self, data_path, pose_path, split_path: Optional[str],
                 target_image_size=(192, 640), return_stereo=False,
                 return_depth=False, return_fisheye=True,
                 return_3d_bboxes=False, return_segmentation=False,
                 frame_count=2, keyframe_offset=0, dilation=1,
                 fisheye_rotation=0, fisheye_offset=0, eigen_depth=True,
                 color_aug=False, is_preprocessed=False, seed=0):
        self.data_path = data_path
        self.pose_path = pose_path
        self.split_path = split_path
        self.target_image_size = tuple(target_image_size)
        self.return_stereo = return_stereo
        self.return_depth = return_depth
        self.return_fisheye = return_fisheye
        self.return_3d_bboxes = return_3d_bboxes
        self.return_segmentation = return_segmentation
        self.frame_count = frame_count
        self.dilation = dilation
        self.keyframe_offset = keyframe_offset
        self.eigen_depth = eigen_depth
        self.color_aug = color_aug
        self.is_preprocessed = is_preprocessed
        self.fisheye_offset = fisheye_offset
        self._rng = np.random.default_rng(seed)

        if isinstance(fisheye_rotation, (int, float)):
            fisheye_rotation = (0, fisheye_rotation)
        self.fisheye_rotation = tuple(fisheye_rotation)

        self._sequences = self._get_sequences(data_path)
        self._calibs = self._load_calibs(data_path, self.fisheye_rotation)
        self._resampler_02 = FisheyeToPinholeSampler(
            self._calibs["K_fisheye"], self.target_image_size,
            self._calibs["fisheye"]["calib_02"],
            self._calibs["fisheye"]["R_02"])
        self._resampler_03 = FisheyeToPinholeSampler(
            self._calibs["K_fisheye"], self.target_image_size,
            self._calibs["fisheye"]["calib_03"],
            self._calibs["fisheye"]["R_03"])
        self._img_ids, self._poses = self._load_poses(pose_path,
                                                      self._sequences)
        self._left_offset = ((frame_count - 1) // 2 + keyframe_offset) \
            * dilation

        self._perspective_folder = "data_rect" if not is_preprocessed else \
            f"data_{self.target_image_size[0]}x{self.target_image_size[1]}"
        self._fisheye_folder = "data_rgb" if not is_preprocessed else \
            (f"data_{self.target_image_size[0]}x{self.target_image_size[1]}"
             f"_{self.fisheye_rotation[0]}x{self.fisheye_rotation[1]}")

        if split_path is not None:
            self._datapoints = self._load_split(split_path, self._img_ids)
        elif return_segmentation:
            self._datapoints = self._semantics_split(
                self._sequences, data_path, self._img_ids)
        else:
            self._datapoints = self._full_split(
                self._sequences, self._img_ids, self.check_file_integrity)

        if return_3d_bboxes:
            self._3d_bboxes = self._load_3d_bboxes(
                Path(data_path) / "data_3d_bboxes" / "train_full",
                self._sequences)
        if return_segmentation:
            self._datapoints = [dp for dp in self._datapoints if not dp[2]]

        self._skip = 0
        self.length = len(self._datapoints)

    # ----------------------------------------------------------- file layout
    def check_file_integrity(self, seq, id):
        dp = Path(self.data_path)
        image_00 = dp / "data_2d_raw" / seq / "image_00" / self._perspective_folder
        image_01 = dp / "data_2d_raw" / seq / "image_01" / self._perspective_folder
        image_02 = dp / "data_2d_raw" / seq / "image_02" / self._fisheye_folder
        image_03 = dp / "data_2d_raw" / seq / "image_03" / self._fisheye_folder
        seq_len = len(self._img_ids[seq])
        ids = self._frame_ids(id, seq_len, 0)
        ids_fish = self._frame_ids(id + self.fisheye_offset, seq_len, 0)
        for i in ids:
            img_id = self._img_ids[seq][i]
            if not ((image_00 / f"{img_id:010d}.png").exists()
                    and (image_01 / f"{img_id:010d}.png").exists()):
                return False
        if self.return_fisheye:
            for i in ids_fish:
                img_id = self._img_ids[seq][i]
                if not ((image_02 / f"{img_id:010d}.png").exists()
                        and (image_03 / f"{img_id:010d}.png").exists()):
                    return False
        return True

    @staticmethod
    def _get_sequences(data_path):
        seqs_path = Path(data_path) / "data_2d_raw"
        return [s.name for s in seqs_path.iterdir() if s.is_dir()]

    @staticmethod
    def _full_split(sequences, img_ids, check_integrity):
        datapoints = []
        for seq in sorted(sequences):
            ids = [i for i in range(len(img_ids[seq]))
                   if check_integrity(seq, i)]
            datapoints += [(seq, i, False) for i in ids]
            datapoints += [(seq, i, True) for i in ids]
        return datapoints

    @staticmethod
    def _semantics_split(sequences, data_path, img_ids):
        datapoints = []
        for seq in sorted(sequences):
            for i in range(len(img_ids[seq])):
                seg = os.path.join(data_path, "data_2d_semantics", "train",
                                   seq, "image_00", "semantic_rgb",
                                   f"{img_ids[seq][i]:010d}.png")
                if os.path.exists(seg):
                    datapoints.append((seq, i, False))
        return datapoints

    @staticmethod
    def _load_split(split_path, img_ids):
        img_id2id = {seq: {img_id: i for i, img_id in enumerate(ids)}
                     for seq, ids in img_ids.items()}
        with open(split_path) as f:
            lines = f.readlines()
        out = []
        for line in lines:
            seg = line.split(" ")
            seq = seg[0]
            out.append((seq, img_id2id[seq][int(seg[1])], seg[2][0] == "r"))
        return out

    @staticmethod
    def _load_calibs(data_path, fisheye_rotation=(0, 0)):
        data_path = Path(data_path)
        calib_dir = data_path / "calibration"
        cam_to_pose = parse_calib_file(calib_dir / "calib_cam_to_pose.txt")
        with open(calib_dir / "calib_cam_to_velo.txt") as f:
            cam_to_velo = np.array([float(x) for x in f.readline().split()],
                                   dtype=np.float32)
        intrinsics = parse_calib_file(calib_dir / "perspective.txt")
        fisheye_02 = read_fisheye_yaml(calib_dir / "image_02.yaml")
        fisheye_03 = read_fisheye_yaml(calib_dir / "image_03.yaml")

        im_size_rect = (int(intrinsics["S_rect_00"][1]),
                        int(intrinsics["S_rect_00"][0]))
        im_size_fish = (fisheye_02["image_height"],
                        fisheye_02["image_width"])

        p_rect_00 = intrinsics["P_rect_00"].reshape(3, 4)
        r_rect_00 = np.eye(4, dtype=np.float32)
        r_rect_01 = np.eye(4, dtype=np.float32)
        r_rect_00[:3, :3] = intrinsics["R_rect_00"].reshape(3, 3)
        r_rect_01[:3, :3] = intrinsics["R_rect_01"].reshape(3, 3)

        rot = np.array(fisheye_rotation).reshape(1, 2)
        r_02 = np.eye(4, dtype=np.float32)
        r_03 = np.eye(4, dtype=np.float32)
        r_02[:3, :3] = euler_xy(rot[:, [1, 0]]).astype(np.float32)
        r_03[:3, :3] = euler_xy(rot[:, [1, 0]] * np.array([[1, -1]])) \
            .astype(np.float32)

        def tf(arr):
            t = np.eye(4, dtype=np.float32)
            t[:3, :] = arr.reshape(3, 4)
            return t

        t_00_to_pose = tf(cam_to_pose["image_00"])
        t_01_to_pose = tf(cam_to_pose["image_01"])
        t_02_to_pose = tf(cam_to_pose["image_02"])
        t_03_to_pose = tf(cam_to_pose["image_03"])
        t_00_to_velo = tf(cam_to_velo)

        t_rect_00_to_pose = t_00_to_pose @ np.linalg.inv(r_rect_00)
        t_rect_01_to_pose = t_01_to_pose @ np.linalg.inv(r_rect_01)
        t_02_to_pose = t_02_to_pose @ r_02
        t_03_to_pose = t_03_to_pose @ r_03
        t_velo_to_rect_00 = r_rect_00 @ np.linalg.inv(t_00_to_velo)
        t_velo_to_pose = t_rect_00_to_pose @ t_velo_to_rect_00
        t_velo_to_rect_01 = np.linalg.inv(t_rect_01_to_pose) @ t_velo_to_pose

        k = p_rect_00[:3, :3].copy()
        k[0, 0] = k[0, 0] / im_size_rect[1] * 2.0
        k[1, 1] = k[1, 1] / im_size_rect[0] * 2.0
        k[0, 2] = k[0, 2] / im_size_rect[1] * 2.0 - 1
        k[1, 2] = k[1, 2] / im_size_rect[0] * 2.0 - 1

        for fdata in (fisheye_02, fisheye_03):
            pp = fdata["projection_parameters"]
            pp["gamma1"] = pp["gamma1"] / im_size_fish[1] * 2.0
            pp["gamma2"] = pp["gamma2"] / im_size_fish[0] * 2.0
            pp["u0"] = pp["u0"] / im_size_fish[1] * 2.0 - 1.0
            pp["v0"] = pp["v0"] / im_size_fish[0] * 2.0 - 1.0

        return {
            "K_perspective": k,
            "K_fisheye": k,
            "T_cam_to_pose": {"00": t_rect_00_to_pose,
                              "01": t_rect_01_to_pose,
                              "02": t_02_to_pose,
                              "03": t_03_to_pose},
            "T_velo_to_cam": {"00": t_velo_to_rect_00,
                              "01": t_velo_to_rect_01},
            "T_velo_to_pose": t_velo_to_pose,
            "fisheye": {"calib_02": fisheye_02, "calib_03": fisheye_03,
                        "R_02": r_02[:3, :3], "R_03": r_03[:3, :3]},
            "im_size": im_size_rect,
        }

    @staticmethod
    def _load_poses(pose_path, sequences):
        ids, poses = {}, {}
        for seq in sequences:
            pose_data = np.loadtxt(Path(pose_path) / seq / "poses.txt")
            if pose_data.ndim == 1:
                pose_data = pose_data[None]
            ids[seq] = pose_data[:, 0].astype(int)
            p = pose_data[:, 1:].astype(np.float32).reshape(-1, 3, 4)
            p = np.concatenate([p, np.zeros_like(p[:, :1])], axis=1)
            p[:, 3, 3] = 1
            poses[seq] = p
        return ids, poses

    @staticmethod
    def _load_3d_bboxes(bbox_path, sequences):
        bboxes = {}
        for seq in sequences:
            with open(Path(bbox_path) / f"{seq}.xml", "rb") as f:
                tree = ET.parse(f)
            objects = defaultdict(list)
            for child in tree.getroot():
                if child.find("transform") is None:
                    continue
                obj = KITTI360Bbox3D()
                if child.find("semanticId") is not None:
                    obj.parseBbox(child)
                else:
                    obj.parseStuff(child)
                objects[obj.timestamp].append(obj)
            bboxes[seq] = objects
        return bboxes

    # ------------------------------------------------------------------ items
    def _frame_ids(self, id, seq_len, offset=0):
        base = id + offset
        return [max(min(base, seq_len - 1), 0)] + [
            max(min(i, seq_len - 1), 0)
            for i in range(base - self._left_offset,
                           base - self._left_offset
                           + self.frame_count * self.dilation,
                           self.dilation)
            if i != base]

    def get_img_id_from_id(self, sequence, id):
        return self._img_ids[sequence][id]

    def _load_image(self, seq, cam_folder, sub_folder, img_id):
        path = os.path.join(self.data_path, "data_2d_raw", seq, cam_folder,
                            sub_folder, f"{img_id:010d}.png")
        img = read_png(path)
        if img.ndim == 2:       # cv2.imread gives grey as three channels
            img = np.repeat(img[..., None], 3, -1)
        return img.astype(np.float32) / 255.0

    def _process_img(self, img, color_aug_fn=None, resampler=None):
        if resampler is not None and not self.is_preprocessed:
            img = resampler.resample(img)
        elif self.target_image_size and \
                img.shape[:2] != self.target_image_size:
            img = resize_linear(img, self.target_image_size)
        if color_aug_fn is not None:
            img = color_aug_fn(img)
        return img * 2.0 - 1.0

    def load_depth(self, seq, img_id, is_right):
        points = np.fromfile(
            os.path.join(self.data_path, "data_3d_raw", seq,
                         "velodyne_points", "data", f"{img_id:010d}.bin"),
            dtype=np.float32).reshape(-1, 4)
        points[:, 3] = 1.0
        t_velo_to_cam = self._calibs["T_velo_to_cam"][
            "00" if not is_right else "01"]
        k = self._calibs["K_perspective"]
        th, tw = self.target_image_size

        velo = (k @ t_velo_to_cam[:3] @ points.T).T
        velo[:, :2] = velo[:, :2] / velo[:, 2][..., None]
        velo[:, 0] = np.round((velo[:, 0] * 0.5 + 0.5) * tw)
        velo[:, 1] = np.round((velo[:, 1] * 0.5 + 0.5) * th)
        val = ((velo[:, 0] >= 0) & (velo[:, 1] >= 0)
               & (velo[:, 0] < tw) & (velo[:, 1] < th))
        velo = velo[val]
        depth = np.zeros((th, tw), dtype=np.float32)
        depth[velo[:, 1].astype(np.int32), velo[:, 0].astype(np.int32)] = \
            velo[:, 2]
        # The reference's index of a pixel (its duplicate check keeps it).
        inds = velo[:, 1] * (tw - 1) + velo[:, 0] - 1
        for dd, cnt in Counter(inds).items():
            if cnt <= 1:
                continue
            pts = np.where(inds == dd)[0]
            depth[int(velo[pts[0], 1]), int(velo[pts[0], 0])] = \
                velo[pts, 2].min()
        depth[depth < 0] = 0
        return depth[None]

    def get_3d_bboxes(self, seq, img_id, pose, projs):
        """(reference kitti_360_dataset.py:475-498)."""
        pose_w2c = np.linalg.inv(pose)

        def in_frustum(bbox):
            verts = bbox.vertices
            v = (projs @ (pose_w2c[:3, :3] @ verts.T
                          + pose_w2c[:3, 3, None])).T
            v = v.copy()
            with np.errstate(divide="ignore", invalid="ignore"):
                # A vertex at z == 0 yields inf/nan, which the comparisons
                # below already classify as outside the frustum.
                v[:, :2] /= v[:, 2:3]
            valid = (((v[:, 0] >= -1) & (v[:, 0] <= 1))
                     & ((v[:, 1] >= -1) & (v[:, 1] <= 1))
                     & ((v[:, 2] > 0) & (v[:, 2] <= 80)))
            return bool(np.any(valid))

        candidates = (self._3d_bboxes[seq][-1]
                      + self._3d_bboxes[seq][img_id])
        return [{"vertices": b.vertices, "faces": b.faces,
                 "semanticId": b.semanticId, "instanceId": b.instanceId}
                for b in candidates if in_frustum(b)]

    def load_segmentation(self, seq, img_id):
        seg = read_png(os.path.join(
            self.data_path, "data_2d_semantics", "train", seq, "image_00",
            "semantic", f"{img_id:010d}.png"))
        return resize_nearest(seg, self.target_image_size)

    def __len__(self):
        return self.length

    def __getitem__(self, index):
        if index >= self.length:
            raise IndexError()
        index += self._skip
        seq, id, is_right = self._datapoints[index]
        seq_len = len(self._img_ids[seq])

        load_left = (not is_right) or self.return_stereo
        load_right = is_right or self.return_stereo

        ids = self._frame_ids(id, seq_len)
        ids_fish = self._frame_ids(id, seq_len, self.fisheye_offset) \
            if self.return_fisheye else []
        img_ids = [self._img_ids[seq][i] for i in ids]
        img_ids_fish = [self._img_ids[seq][i] for i in ids_fish]

        # One jitter per item, drawn before any image is read (the JAX
        # loader's order), applied to every view.
        aug = sample_color_jitter(self._rng) if self.color_aug else None

        imgs_p_l, imgs_p_r, imgs_f_l, imgs_f_r = [], [], [], []
        for img_id in img_ids:
            if load_left:
                imgs_p_l.append(self._process_img(self._load_image(
                    seq, "image_00", self._perspective_folder, img_id), aug))
            if load_right:
                imgs_p_r.append(self._process_img(self._load_image(
                    seq, "image_01", self._perspective_folder, img_id), aug))
        for img_id in img_ids_fish:
            if load_left:
                imgs_f_l.append(self._process_img(
                    self._load_image(seq, "image_02", self._fisheye_folder,
                                     img_id), aug, self._resampler_02))
            if load_right:
                imgs_f_r.append(self._process_img(
                    self._load_image(seq, "image_03", self._fisheye_folder,
                                     img_id), aug, self._resampler_03))

        calibs = self._calibs
        poses_seq = self._poses[seq]
        poses_p_l = [poses_seq[i] @ calibs["T_cam_to_pose"]["00"]
                     for i in ids] if load_left else []
        poses_p_r = [poses_seq[i] @ calibs["T_cam_to_pose"]["01"]
                     for i in ids] if load_right else []
        poses_f_l = [poses_seq[i] @ calibs["T_cam_to_pose"]["02"]
                     for i in ids_fish] if load_left else []
        poses_f_r = [poses_seq[i] @ calibs["T_cam_to_pose"]["03"]
                     for i in ids_fish] if load_right else []

        if not is_right:
            imgs = imgs_p_l + imgs_p_r + imgs_f_l + imgs_f_r
            poses = poses_p_l + poses_p_r + poses_f_l + poses_f_r
        else:
            imgs = imgs_p_r + imgs_p_l + imgs_f_r + imgs_f_l
            poses = poses_p_r + poses_p_l + poses_f_r + poses_f_l
        projs = [calibs["K_perspective"]] * (len(imgs_p_l) + len(imgs_p_r)) \
            + [calibs["K_fisheye"]] * (len(imgs_f_l) + len(imgs_f_r))

        out = {
            "imgs": np.stack(imgs).astype(np.float32),
            "projs": np.stack(projs).astype(np.float32),
            "poses": np.stack(poses).astype(np.float32),
            "ts": np.array(ids + ids + ids_fish + ids_fish, dtype=np.int32),
            "index": np.array([index], dtype=np.int64),
        }
        if self.return_depth:
            out["depths"] = self.load_depth(seq, img_ids[0], is_right)[None]
        if self.return_3d_bboxes:
            out["3d_bboxes"] = self.get_3d_bboxes(
                seq, img_ids[0], poses[0], projs[0])
        if self.return_segmentation:
            out["segs"] = self.load_segmentation(seq, img_ids[0])[None]
        return out

    @classmethod
    def make_train_test(cls, conf: dict):
        common = dict(
            data_path=conf["data_path"],
            pose_path=conf["pose_path"],
            target_image_size=tuple(conf.get("image_size", (192, 640))),
            frame_count=conf.get("data_fc", 2),
            dilation=conf.get("dilation", 1),
            keyframe_offset=conf.get("keyframe_offset", 0),
            fisheye_rotation=conf.get("fisheye_rotation", 0),
            fisheye_offset=conf.get("fisheye_offset", 0),
            is_preprocessed=conf.get("is_preprocessed", False),
        )
        split_base = conf.get("split_path")
        train = cls(split_path=os.path.join(split_base, "train_files.txt")
                    if split_base else None,
                    return_stereo=conf.get("data_stereo", True),
                    return_fisheye=conf.get("data_fisheye", True),
                    color_aug=conf.get("color_aug", False), **common)
        test = cls(split_path=os.path.join(split_base, "test_files.txt")
                   if split_base else None,
                   return_stereo=conf.get("data_stereo", True),
                   return_fisheye=conf.get("data_fisheye", True),
                   return_3d_bboxes=conf.get("return_3d_bboxes", False),
                   return_segmentation=conf.get("return_segmentation",
                                                False),
                   return_depth=True, **common)
        return train, test
