"""KITTI raw dataset (counterpart of
behindthescenes_tpu/datasets/kitti_raw.py; reference
datasets/kitti_raw/kitti_raw_dataset.py).

A host-side numpy loader producing the data-dict ABI in NHWC: imgs
(v, h, w, 3) float32 in [-1, 1], projs (v, 3, 3) NDC intrinsics, poses
(v, 4, 4) camera-to-world and, for the test split, depths (1, 1, H0, W0):
the velodyne ground truth at the day's base size. The formats are the
reference's: eigen_zhou-style split files `day/seq id l|r`, KITTI's
calib_cam_to_cam / calib_velo_to_cam files and ORB-SLAM pose text files
(3x4 row-major a line). Frames are read by the port's JPEG reader
(`datasets/jpeg.py`, bit-equal to cv2.imread), with a `.png` file where
no `.jpg` exists, and resized with OpenCV's float INTER_LINEAR
(`png.resize_linear`).

The velodyne ground truth has two projectors, as the JAX package has:
`project_velodyne_to_depth` (the reference's Counter-hash duplicate
resolution, `native_depth: false`) and `project_velodyne_depth` (the
per-pixel minimum of the JAX package's C++ projector, in numpy; the
test split's default).
"""
from __future__ import annotations

import os
from collections import Counter
from pathlib import Path

import numpy as np

from behindthescenes_tpu_torch.datasets.augmentation import \
    sample_color_jitter
from behindthescenes_tpu_torch.datasets.jpeg import read_jpeg
from behindthescenes_tpu_torch.datasets.png import read_png, resize_linear

# Per-day base image sizes (reference kitti_raw_dataset.py:16-22).
BASE_SIZES = {
    "2011_09_26": (375, 1242),
    "2011_09_28": (370, 1224),
    "2011_09_29": (374, 1238),
    "2011_09_30": (370, 1226),
    "2011_10_03": (376, 1241),
}

# The Eigen crop, as fractions of (h, h, w, w) (reference
# kitti_raw_dataset.py:294-300).
_EIGEN_CROP = (0.40810811, 0.99189189, 0.03594771, 0.96405229)


def parse_calib_file(path):
    """`key: v0 v1 ...` lines -> {key: float32 array}; lines whose values
    are not numbers are skipped."""
    data = {}
    with open(path) as f:
        for line in f.readlines():
            key, value = line.split(":", 1)
            try:
                data[key] = np.array([float(x) for x in value.split()],
                                     dtype=np.float32)
            except ValueError:
                pass
    return data


def ndc_intrinsics(k, im_size, target_size=None, keep_aspect_ratio=False):
    """Pixel K -> the [-1, 1] NDC convention (reference
    kitti_raw_dataset.py:143-185): (K_ndc 3x3, crop box (y, x, h, w) or
    None). With keep_aspect_ratio the image is first cropped centrally
    to the target's aspect ratio."""
    k = k.copy()
    h, w = im_size
    if keep_aspect_ratio and target_size is not None:
        r_orig = h / w
        r_target = target_size[0] / target_size[1]
        if r_orig >= r_target:
            new_height = r_target * w
            crop_height = h - ((h - new_height) // 2) * 2
            box = ((h - new_height) // 2, 0, crop_height, int(w))
            c_x = k[0, 2] / w
            c_y = (k[1, 2] - (h - new_height) / 2) / new_height
            rescale = w / target_size[1]
        else:
            new_width = h / r_target
            crop_width = w - ((w - new_width) // 2) * 2
            box = (0, (w - new_width) // 2, h, crop_width)
            c_x = (k[0, 2] - (w - new_width) / 2) / new_width
            c_y = k[1, 2] / h
            rescale = h / target_size[0]
        f_x = (k[0, 0] / target_size[1]) / rescale
        f_y = (k[1, 1] / target_size[0]) / rescale
        box = tuple(int(x) for x in box)
    else:
        f_x = k[0, 0] / w
        f_y = k[1, 1] / h
        c_x = k[0, 2] / w
        c_y = k[1, 2] / h
        box = None
    k[0, 0] = f_x * 2.0
    k[1, 1] = f_y * 2.0
    k[0, 2] = c_x * 2.0 - 1.0
    k[1, 2] = c_y * 2.0 - 1.0
    return k, box


def apply_crop(img, box):
    y, x, h, w = box
    return img[int(y):int(y) + int(h), int(x):int(x) + int(w)]


def eigen_mask(depth: np.ndarray, size) -> np.ndarray:
    """Zero the depths outside (1e-3, 80) m and outside the Eigen crop,
    in place."""
    mask = np.logical_and(depth > 1e-3, depth < 80)
    crop = np.array([_EIGEN_CROP[0] * size[0], _EIGEN_CROP[1] * size[0],
                     _EIGEN_CROP[2] * size[1], _EIGEN_CROP[3] * size[1]]) \
        .astype(np.int32)
    crop_mask = np.zeros(mask.shape, dtype=bool)
    crop_mask[crop[0]:crop[1], crop[2]:crop[3]] = True
    depth[~np.logical_and(mask, crop_mask)] = 0
    return depth


def project_velodyne_to_depth(points, p_mat, size, eigen_depth=True):
    """Sparse depth (1, h, w) from raw velodyne points, the reference's
    way (kitti_raw_dataset.py:256-302): round to the pixel with KITTI's
    matlab -1 convention, resolve duplicates through a Counter over the
    index y * (w - 1) + x - 1 (which can collide across pixels: the
    reference's quirk, kept), optionally the Eigen crop and range
    mask."""
    points = points.copy()
    points[:, 3] = 1.0
    points = points[points[:, 0] >= 0, :]
    velo_pts_im = (p_mat @ points.T).T
    velo_pts_im[:, :2] = velo_pts_im[:, :2] / velo_pts_im[:, 2][..., None]
    velo_pts_im[:, 0] = np.round(velo_pts_im[:, 0]) - 1
    velo_pts_im[:, 1] = np.round(velo_pts_im[:, 1]) - 1
    val = ((velo_pts_im[:, 0] >= 0) & (velo_pts_im[:, 1] >= 0)
           & (velo_pts_im[:, 0] < size[1]) & (velo_pts_im[:, 1] < size[0]))
    velo_pts_im = velo_pts_im[val]

    depth = np.zeros(size, dtype=np.float32)
    xs = velo_pts_im[:, 0].astype(np.int64)
    ys = velo_pts_im[:, 1].astype(np.int64)
    depth[ys, xs] = velo_pts_im[:, 2]

    inds = velo_pts_im[:, 1] * (size[1] - 1) + velo_pts_im[:, 0] - 1
    for dd, cnt in Counter(inds).items():
        if cnt <= 1:
            continue
        pts = np.where(inds == dd)[0]
        depth[int(velo_pts_im[pts[0], 1]), int(velo_pts_im[pts[0], 0])] = \
            velo_pts_im[pts, 2].min()
    depth[depth < 0] = 0
    if eigen_depth:
        eigen_mask(depth, size)
    return depth[None]


def project_velodyne_depth(points, p_mat, size) -> np.ndarray:
    """Sparse depth (h, w) float32 from velodyne points (n, 4) and a 3x4
    projection: the per-pixel minimum depth, as the JAX package's C++
    projector (native/velodyne_depth.cpp) computes it. Each homogeneous
    coordinate is p0*x + p1*y + p2*z + p3 in float32, left to right with
    a rounding after every operation (no fused multiply-add); pixels are
    nearbyint(u / d) - 1 (half to even); points with x < 0 or d <= 0 are
    dropped; empty pixels are 0."""
    pts = np.ascontiguousarray(points, dtype=np.float32)
    p = np.ascontiguousarray(p_mat, dtype=np.float32).reshape(-1)
    h, w = size
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    keep = x >= np.float32(0)
    x, y, z = x[keep], y[keep], z[keep]

    def row(i):
        return p[4 * i] * x + p[4 * i + 1] * y + p[4 * i + 2] * z \
            + p[4 * i + 3]

    u_h, v_h, d = row(0), row(1), row(2)
    front = d > np.float32(0)
    u_h, v_h, d = u_h[front], v_h[front], d[front]
    u = np.rint(u_h / d).astype(np.int64) - 1
    v = np.rint(v_h / d).astype(np.int64) - 1
    inside = (u >= 0) & (v >= 0) & (u < w) & (v < h)
    grid = np.full(h * w, np.inf, np.float32)
    np.minimum.at(grid, v[inside] * w + u[inside], d[inside])
    grid[np.isinf(grid)] = 0
    return grid.reshape(h, w)


def read_orbslam_poses(path) -> np.ndarray:
    """An ORB-SLAM pose file (a 3x4 row-major camera-to-world matrix a
    line) -> (n, 4, 4) float32."""
    poses = []
    with open(path) as f:
        for line in f.readlines():
            mat = np.array(line.split(), dtype=np.float64)
            poses.append(np.vstack([mat.reshape(3, 4), [0, 0, 0, 1]]))
    return np.array(poses, dtype=np.float32)


class KittiRawDataset:
    def __init__(self, data_path, pose_path, split_path,
                 target_image_size=(192, 640), return_stereo=False,
                 return_depth=False, frame_count=2, keyframe_offset=0,
                 dilation=1, keep_aspect_ratio=False, eigen_depth=True,
                 color_aug=False, seed=0, native_depth=False):
        self.data_path = data_path
        self.pose_path = pose_path
        self.split_path = split_path
        self.target_image_size = tuple(target_image_size)
        self.return_stereo = return_stereo
        self.return_depth = return_depth
        self.frame_count = frame_count
        self.dilation = dilation
        self.keyframe_offset = keyframe_offset
        self.keep_aspect_ratio = keep_aspect_ratio
        self.eigen_depth = eigen_depth
        self.color_aug = color_aug
        self.native_depth = native_depth
        self._rng = np.random.default_rng(seed)

        self._sequences = self._get_sequences(data_path)
        self._seq_lengths = {(d, s): n for d, s, n in self._sequences}
        self._calibs = self._load_calibs(data_path, self.target_image_size,
                                         keep_aspect_ratio)
        self._poses = self._load_poses(pose_path, self._sequences)
        self._datapoints = self._load_split(split_path)
        self._left_offset = ((self.frame_count - 1) // 2
                             + self.keyframe_offset) * self.dilation
        self._skip = 0
        self.length = len(self._datapoints)

    # ------------------------------------------------------------ metadata
    @staticmethod
    def _get_sequences(data_path):
        out = []
        for day in Path(data_path).iterdir():
            if not day.is_dir():
                continue
            for seq in day.iterdir():
                if not seq.is_dir():
                    continue
                img_dir = seq / "image_02" / "data"
                if img_dir.exists():
                    out.append((day.name, seq.name,
                                len(list(img_dir.iterdir()))))
        return out

    @staticmethod
    def _load_split(split_path):
        """`day/seq id l|r` lines -> [(day, seq, id, is_right)]."""
        with open(split_path) as f:
            lines = f.readlines()
        out = []
        for line in lines:
            seg = line.split(" ")
            day, seq = seg[0].split("/")
            out.append((day, seq, int(seg[1]), seg[2].strip() == "r"))
        return out

    @staticmethod
    def _load_calibs(data_path, target_size, keep_aspect_ratio):
        calibs = {}
        for day in BASE_SIZES:
            day_dir = Path(data_path) / day
            if not day_dir.exists():
                continue
            cam = parse_calib_file(day_dir / "calib_cam_to_cam.txt")
            velo = parse_calib_file(day_dir / "calib_velo_to_cam.txt")
            im_size = BASE_SIZES[day]

            p_rect_l = cam["P_rect_02"].reshape(3, 4)
            p_rect_r = cam["P_rect_03"].reshape(3, 4)
            r_rect = np.eye(4, dtype=np.float32)
            r_rect[:3, :3] = cam["R_rect_00"].reshape(3, 3)
            t_v2c = np.vstack([
                np.hstack([velo["R"].reshape(3, 3), velo["T"][:, None]]),
                np.array([0, 0, 0, 1.0], dtype=np.float32)])

            # Camera 2 and 3 sit beside the rectified camera 0.
            t_l = np.eye(4, dtype=np.float32)
            t_l[0, 3] = p_rect_l[0, 3] / p_rect_l[0, 0]
            t_r = np.eye(4, dtype=np.float32)
            t_r[0, 3] = p_rect_r[0, 3] / p_rect_r[0, 0]

            k_ndc, box = ndc_intrinsics(p_rect_l[:3, :3].copy(), im_size,
                                        target_size, keep_aspect_ratio)
            calibs[day] = {
                "K": k_ndc,
                "T_l": np.linalg.inv(t_l),
                "T_r": np.linalg.inv(t_r),
                "P_v2cl": p_rect_l @ r_rect @ t_v2c,
                "P_v2cr": p_rect_r @ r_rect @ t_v2c,
                "crop": box,
            }
        return calibs

    @staticmethod
    def _load_poses(pose_path, sequences):
        poses = {}
        for day, seq, _ in sequences:
            pose_file = Path(pose_path) / day / f"{seq}.txt"
            poses[(day, seq)] = read_orbslam_poses(pose_file) \
                if pose_file.exists() else np.zeros((0,), np.float32)
        return poses

    # --------------------------------------------------------------- items
    def _load_image(self, day, seq, cam, frame_id):
        """Frame as float32 RGB in [0, 1]: the `.jpg`, or the `.png` of
        the same name where no `.jpg` exists."""
        path = os.path.join(self.data_path, day, seq, cam, "data",
                            f"{frame_id:010d}.jpg")
        if os.path.exists(path):
            img = read_jpeg(path)
        else:
            img = read_png(path[:-4] + ".png")
            if img.ndim == 2:
                img = np.repeat(img[..., None], 3, axis=2)
        return img.astype(np.float32) / 255.0

    def _process_img(self, img, crop_box, color_aug_fn):
        if crop_box:
            img = apply_crop(img, crop_box)
        img = resize_linear(img, self.target_image_size)
        if color_aug_fn is not None:
            img = color_aug_fn(img)
        return img * 2.0 - 1.0

    def frame_ids(self, seq_id, seq_len):
        """The keyframe, then the other frames of the window, each
        clamped to the sequence."""
        return [seq_id] + [
            max(min(i, seq_len - 1), 0)
            for i in range(seq_id - self._left_offset,
                           seq_id - self._left_offset
                           + self.frame_count * self.dilation,
                           self.dilation)
            if i != seq_id]

    def load_depth(self, day, seq, frame_id, is_right):
        """Velodyne ground truth (1, 1, H0, W0) of a frame, seen from the
        left or the right camera."""
        pts = np.fromfile(
            os.path.join(self.data_path, day, seq, "velodyne_points",
                         "data", f"{frame_id:010d}.bin"),
            dtype=np.float32).reshape(-1, 4)
        p_mat = self._calibs[day]["P_v2cr" if is_right else "P_v2cl"]
        size = BASE_SIZES[day]
        if not self.native_depth:
            return project_velodyne_to_depth(pts, p_mat, size,
                                             self.eigen_depth)[None]
        depth = project_velodyne_depth(pts, p_mat, size)
        if self.eigen_depth:
            eigen_mask(depth, size)
        return depth[None, None]

    def __len__(self):
        return self.length

    def __getitem__(self, index):
        if index >= self.length:
            raise IndexError()
        index += self._skip
        day, seq, seq_id, is_right = self._datapoints[index]
        seq_len = self._seq_lengths[(day, seq)]
        calibs = self._calibs[day]

        load_left = (not is_right) or self.return_stereo
        load_right = is_right or self.return_stereo
        ids = self.frame_ids(seq_id, seq_len)
        color_aug_fn = sample_color_jitter(self._rng) if self.color_aug \
            else None

        imgs_l, imgs_r, poses_l, poses_r = [], [], [], []
        for i in ids:
            if load_left:
                imgs_l.append(self._process_img(
                    self._load_image(day, seq, "image_02", i),
                    calibs["crop"], color_aug_fn))
                poses_l.append(self._poses[(day, seq)][i] @ calibs["T_l"])
            if load_right:
                imgs_r.append(self._process_img(
                    self._load_image(day, seq, "image_03", i),
                    calibs["crop"], color_aug_fn))
                poses_r.append(self._poses[(day, seq)][i] @ calibs["T_r"])

        # An `r` datapoint puts the right camera's views first.
        if not is_right:
            imgs, poses = imgs_l + imgs_r, poses_l + poses_r
        else:
            imgs, poses = imgs_r + imgs_l, poses_r + poses_l
        out = {
            "imgs": np.stack(imgs).astype(np.float32),
            "projs": np.stack([calibs["K"]] * len(imgs)).astype(np.float32),
            "poses": np.stack(poses).astype(np.float32),
        }
        if self.return_depth:
            out["depths"] = self.load_depth(day, seq, ids[0], is_right)
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
            keep_aspect_ratio=conf.get("keep_aspect_ratio", False),
        )
        split_dir = conf["split_path"]
        train = cls(split_path=os.path.join(split_dir, "train_files.txt"),
                    return_stereo=conf.get("data_stereo", True),
                    color_aug=conf.get("color_aug", False), **common)
        test = cls(split_path=os.path.join(split_dir, "test_files.txt"),
                   return_stereo=conf.get("data_stereo", True),
                   return_depth=True,
                   native_depth=conf.get("native_depth", True), **common)
        return train, test
