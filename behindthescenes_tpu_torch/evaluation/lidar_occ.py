"""KITTI-360 LiDAR occupancy evaluator (counterpart of
behindthescenes_tpu/evaluation/lidar_occ.py; reference
models/bts/evaluator_lidar.py:27-347).

Per item: build the inclination-adjusted world frame, encode the keyframe,
render its jittered pseudo-depth through the self-view path, query the
density field on a dense x/z slab (on the model's device, in chunks of
`query_batch_size`), and score occupancy and invisible-empty metrics
against polar-binned slices of 20 aggregated LiDAR sweeps. The ground
truth is built on the host in numpy, as the JAX package (and the
reference) build it.
"""
from __future__ import annotations

import math
import os
from typing import Callable, Optional

import numpy as np
import torch

from behindthescenes_tpu_torch.inference import render_depth_selfview
from behindthescenes_tpu_torch.models.bts import BTSNet
from behindthescenes_tpu_torch.platform import exact_f32

EPS = 1e-4

# KITTI-360 cameras have ~5 deg negative inclination
# (reference evaluator_lidar.py:27-34).
CAM_INCL_ADJUST = np.array(
    [[1.0, 0.0, 0.0, 0.0],
     [0.0, 0.9961947, 0.0871557, 0.0],
     [0.0, -0.0871557, 0.9961947, 0.0],
     [0.0, 0.0, 0.0, 1.0]], dtype=np.float32)


def get_pts(x_range, y_range, z_range, ppm, ppm_y, y_res=None):
    """Dense query grid (reference evaluator_lidar.py:37-50)."""
    x_res = abs(int((x_range[1] - x_range[0]) * ppm))
    if y_res is None:
        y_res = abs(int((y_range[1] - y_range[0]) * ppm_y))
    z_res = abs(int((z_range[1] - z_range[0]) * ppm))
    x = np.linspace(x_range[0], x_range[1], x_res)[None, None] \
        .repeat(z_res, 1).repeat(y_res, 0)
    z = np.linspace(z_range[0], z_range[1], z_res)[None, :, None] \
        .repeat(y_res, 0).repeat(x_res, 2)
    if y_res == 1:
        y = np.full((1, z_res, x_res), (y_range[0] + y_range[1]) * 0.5)
    else:
        y = np.linspace(y_range[0], y_range[1], y_res)[:, None, None] \
            .repeat(z_res, 1).repeat(x_res, 2)
    xyz = np.stack([x, y, z], axis=-1).astype(np.float32)
    return xyz, (x_res, y_res, z_res)


def get_lidar_slices(point_clouds, velo_poses, y_range, y_res, max_dist):
    """Polar-binned LiDAR ground truth (reference evaluator_lidar.py:57-115).

    For each y slice and timestep: project points in the slice to polar
    (angle, dist) in velodyne space, bin to 1-degree bins taking the min
    distance, fill empty bins forward, and wrap for 360 coverage.
    """
    slices = []
    ys = np.linspace(y_range[0], y_range[1], y_res)
    slice_height = ys[1] - ys[0] if y_res > 1 else 0
    n_bins = 360

    for y in ys:
        if y_res == 1:
            min_y, max_y = y, y_range[-1]
        else:
            min_y, max_y = y - slice_height / 2, y + slice_height / 2

        per_t = []
        for pc, velo_pose in zip(point_clouds, velo_poses):
            pc_world = (velo_pose @ pc.T).T
            mask = (((pc_world[:, 1] >= min_y) & (pc_world[:, 1] <= max_y))
                    | (np.linalg.norm(pc_world[:, :3], axis=-1) >= max_dist))
            pts2 = pc[mask, :2]
            angles = np.arctan2(pts2[:, 1], pts2[:, 0])
            dists = np.linalg.norm(pts2, axis=-1)
            order = np.argsort(angles)
            angles, dists = angles[order], dists[order]

            bin_borders = np.linspace(-math.pi, math.pi, n_bins + 1)
            border_is = np.searchsorted(angles, bin_borders)
            binned = np.zeros((n_bins, 2), dtype=np.float32)
            dist = dists[0]
            for i in range(n_bins):
                li, ri = border_is[i], border_is[i + 1]
                if ri > li:
                    dist = dists[li:ri].min()
                binned[i, 0] = (bin_borders[i] + bin_borders[i + 1]) * 0.5
                binned[i, 1] = dist

            wrapped = np.concatenate([
                [[binned[-1, 0] - 2 * math.pi, binned[-1, 1]]],
                binned,
                [[binned[0, 0] + 2 * math.pi, binned[0, 1]]]], axis=0)
            per_t.append(wrapped.astype(np.float32))
        slices.append(per_t)
    return slices


def check_occupancy(pts, slices, velo_poses, min_dist=3.0):
    """Occupancy vote over timesteps (reference evaluator_lidar.py:118-160).
    """
    p = pts.shape[0]
    is_occupied = np.ones(p, dtype=np.float64)
    is_visible = np.zeros(p, dtype=bool)
    thresh = (len(slices[0]) - 2) / len(slices[0])

    pts_h = np.concatenate([pts, np.ones((p, 1), dtype=pts.dtype)], -1)
    world_to_velos = np.linalg.inv(velo_poses)
    step = p // len(slices)

    for i, slc in enumerate(slices):
        seg = slice(i * step, (i + 1) * step)
        for j, (lidar_polar, w2v) in enumerate(zip(slc, world_to_velos)):
            pts_velo = (w2v @ pts_h[seg].T).T
            angles = np.arctan2(pts_velo[:, 1], pts_velo[:, 0])
            dists = np.linalg.norm(pts_velo, axis=-1)

            idx = np.searchsorted(lidar_polar[:, 0], angles)
            left_a = lidar_polar[idx - 1, 0]
            right_a = lidar_polar[idx, 0]
            left_d = lidar_polar[idx - 1, 1]
            right_d = lidar_polar[idx, 1]
            interp = (angles - left_a) / (right_a - left_a)
            surface = left_d * (1 - interp) + right_d * interp

            occupied_t = (dists > surface) | (dists < min_dist)
            is_occupied[seg] += occupied_t
            if j == 0:
                is_visible[seg] |= ~occupied_t

    is_occupied /= len(slices[0])
    return is_occupied > thresh, is_visible


def project_into_cam(pts, proj, pose):
    """(reference evaluator_lidar.py:163-168)."""
    pts_h = np.concatenate([pts, np.ones_like(pts[:, :1])], -1)
    cam = (proj @ (np.linalg.inv(pose)[:3] @ pts_h.T)).T
    cam[:, :2] /= cam[:, 2:3]
    return cam, cam[:, 2].copy()


def _grid_sample_nearest_ac_true(img, xy):
    """torch grid_sample(mode=nearest, align_corners=True, border) on a 2D
    map (reference evaluator_lidar.py:297); np.round rounds halves to
    even."""
    h, w = img.shape
    x = (xy[:, 0] + 1) * 0.5 * (w - 1)
    y = (xy[:, 1] + 1) * 0.5 * (h - 1)
    xi = np.clip(np.round(x).astype(np.int64), 0, w - 1)
    yi = np.clip(np.round(y).astype(np.int64), 0, h - 1)
    return img[yi, xi]


def occupancy_metrics(is_occupied_pred, is_occupied, is_visible) -> dict:
    """The occupancy and invisible-empty scores of both evaluators
    (python floats; nan where a mask selects nothing)."""
    def safe_mean(x):
        return float(np.mean(x)) if x.size else float("nan")

    return {
        "o_acc": float(np.mean(is_occupied_pred == is_occupied)),
        "o_prec": safe_mean(is_occupied[is_occupied_pred]),
        "o_rec": safe_mean(is_occupied_pred[is_occupied]),
        "ie_acc": safe_mean(
            (is_occupied_pred == is_occupied)[~is_visible]),
        "ie_prec": safe_mean(
            (~is_occupied)[(~is_occupied_pred) & (~is_visible)]),
        "ie_rec": safe_mean(
            (~is_occupied_pred)[(~is_occupied) & (~is_visible)]),
        "ie_r": float(np.mean((~is_occupied) & (~is_visible))),
        "t_ie": float(np.sum((~is_occupied) & (~is_visible))),
    }


class OccupancyQuery:
    """What both occupancy evaluators run on the model's device: the
    keyframe's encoding with its jittered self-view pseudo-depth, and the
    density of world points in chunks of `query_batch_size`."""

    def __init__(self, net: BTSNet, renderer_cfg, config: dict):
        exact_f32()
        self.net = net
        self.cfg = renderer_cfg
        self.z_near = config["z_near"]
        self.z_far = config["z_far"]
        self.query_batch_size = config.get("query_batch_size", 50000)
        self.occ_threshold = 0.5

    @torch.no_grad()
    def encode_and_depth(self, images, projs, poses, images_alt, out_hw,
                         generator=None, z_samp=None,
                         mark: Optional[Callable[[str], None]] = None):
        """The feature grid of view 0 and its z-depth (out_h, out_w) on the
        host, rendered with stratified jitter from `generator` or at the
        distances z_samp (out_h*out_w, n_coarse); mark(name) is called
        after "encode" and "render"."""
        grid = self.net.encode(images, projs, poses, ids_encoder=[0],
                               ids_render=[0], images_alt=images_alt)
        if mark:
            mark("encode")
        depth, _, _ = render_depth_selfview(
            self.net, grid, out_hw[0], out_hw[1], self.cfg, self.z_near,
            self.z_far, as_z_depth=True, generator=generator, z_samp=z_samp)
        depth = depth[0].float().cpu().numpy()
        if mark:
            mark("render")
        return grid, depth

    @torch.no_grad()
    def query_density(self, grid, pts: np.ndarray) -> np.ndarray:
        """Density (P,) at world points pts (P, 3), on the host."""
        dev = grid.f_ks.device
        pts_t = torch.as_tensor(pts, device=dev)
        out = []
        for i in range(0, pts_t.shape[0], self.query_batch_size):
            _, _, sigma = self.net.query(
                grid, pts_t[None, i:i + self.query_batch_size],
                only_density=True)
            out.append(sigma[0, :, 0])
        return torch.cat(out).float().cpu().numpy()


class LidarOccEvaluator(OccupancyQuery):
    def __init__(self, net: BTSNet, renderer_cfg, config: dict, dataset):
        super().__init__(net, renderer_cfg, config)
        self.x_range = (-4, 4)
        self.y_range = (0, 0.75)
        self.z_range = (20, 4)
        self.ppm = 10
        self.ppm_y = 4
        self.y_res = 1
        self.dataset = dataset
        self.aggregate_timesteps = 20

    def ground_truth(self, index: int, world_transform, q_pts, y_res):
        """(is_occupied, is_visible) of the query points from the LiDAR
        sweeps of the item's frame and the next ones (reference :266-277,
        :327-334), on the host."""
        ds = self.dataset
        seq, frame_id, _ = ds._datapoints[index]
        seq_len = len(ds._img_ids[seq])
        t_velo_to_pose = np.asarray(ds._calibs["T_velo_to_pose"])
        points_all, velo_poses = [], []
        for fid in range(frame_id, min(frame_id + self.aggregate_timesteps,
                                       seq_len)):
            pts = np.fromfile(
                os.path.join(ds.data_path, "data_3d_raw", seq,
                             "velodyne_points", "data",
                             f"{ds._img_ids[seq][fid]:010d}.bin"),
                dtype=np.float32).reshape(-1, 4)
            pts[:, 3] = 1.0
            velo_pose = (world_transform
                         @ ds._poses[seq][fid] @ t_velo_to_pose)
            points_all.append(pts)
            velo_poses.append(velo_pose.astype(np.float32))
        velo_poses = np.stack(velo_poses)
        max_dist = (self.z_range[0] ** 2 + self.x_range[0] ** 2) ** 0.5
        slices = get_lidar_slices(points_all, velo_poses, self.y_range,
                                  y_res, max_dist)
        return check_occupancy(q_pts, slices, velo_poses)

    def evaluate(self, batch, generator=None, z_samp=None,
                 mark: Optional[Callable[[str], None]] = None) -> dict:
        """batch: numpy dict of one item (imgs (1, v, h, w, 3), poses,
        projs, index). The pseudo-depth's jitter comes from `generator`,
        or is z_samp (h*w, n_coarse). mark(name) is called after
        "encode", "render", "query" and "ground_truth". Returns the metric
        dict (python floats)."""
        dev = next(self.net.parameters()).device
        images = torch.as_tensor(batch["imgs"], device=dev)
        if images.shape[0] != 1:
            raise ValueError("the evaluator is per-sample (n == 1)")
        poses_np = np.asarray(batch["poses"])
        projs_np = np.asarray(batch["projs"])
        _, _, h, w, _ = images.shape
        index = int(np.asarray(batch["index"]).ravel()[0]) \
            if "index" in batch else 0

        # Inclination-adjusted world frame (reference :257-261).
        world_transform = CAM_INCL_ADJUST @ np.linalg.inv(poses_np[0, 0])
        poses_w = (world_transform[None, None] @ poses_np).astype(np.float32)

        grid, pred_depth = self.encode_and_depth(
            images, torch.as_tensor(projs_np, device=dev),
            torch.as_tensor(poses_w, device=dev), images[:, :1] * 0.5 + 0.5,
            (h, w), generator, z_samp, mark)

        q_pts, (xd, yd, zd) = get_pts(self.x_range, self.y_range,
                                      self.z_range, self.ppm, self.ppm_y,
                                      self.y_res)
        q_pts = q_pts.reshape(-1, 3)
        densities = self.query_density(grid, q_pts)
        is_occupied_pred = densities > self.occ_threshold
        if mark:
            mark("query")

        cam_pts, dists = project_into_cam(q_pts, projs_np[0, 0],
                                          poses_w[0, 0])
        pred_dist = _grid_sample_nearest_ac_true(pred_depth, cam_pts[:, :2])
        is_visible_pred = dists <= pred_dist

        is_occupied, is_visible = self.ground_truth(index, world_transform,
                                                    q_pts, yd)
        is_visible |= is_visible_pred
        is_occupied &= ~is_visible
        if mark:
            mark("ground_truth")
        return occupancy_metrics(is_occupied_pred, is_occupied, is_visible)
