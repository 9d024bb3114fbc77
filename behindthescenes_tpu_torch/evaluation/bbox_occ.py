"""KITTI-360 3D-bounding-box occupancy evaluator (counterpart of
behindthescenes_tpu/evaluation/bbox_occ.py; reference
models/bts/evaluator_3dbb.py:30-330).

Ground-truth occupancy comes from semantic 3D bounding boxes: vertices are
moved into the keyframe camera frame, frustum-filtered, and represented by
face-normal slab bounds (min/max projections per face normal). Visibility
is derived from a per-pixel label-aware ray/box intercept pseudo-depth plus
the model's own pseudo-depth, rendered with jitter at half resolution. All
geometry is host-side numpy; the encode, the render and the density query
run on the model's device.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from behindthescenes_tpu_torch.datasets.kitti_360_labels import id2label
from behindthescenes_tpu_torch.evaluation.lidar_occ import (
    OccupancyQuery, _grid_sample_nearest_ac_true, occupancy_metrics)

EPS = 1e-4


def verts_to_cam(bbox, pose_w2c):
    verts = np.asarray(bbox["vertices"], dtype=np.float32)
    verts = (pose_w2c[:3, :3] @ verts.T + pose_w2c[:3, 3, None]).T
    out = dict(bbox)
    out["vertices"] = verts
    out["faces"] = np.asarray(bbox["faces"], dtype=np.int64)
    return out


def bbox_in_frustum(bbox, projs, max_d, reducer=np.any):
    """(reference evaluator_3dbb.py:38-44)."""
    verts = (projs @ bbox["vertices"].T).T.copy()
    verts[:, :2] /= verts[:, 2:3]
    valid = (((verts[:, 0] >= -1) & (verts[:, 0] <= 1))
             & ((verts[:, 1] >= -1) & (verts[:, 1] <= 1))
             & ((verts[:, 2] > 0) & (verts[:, 2] <= max_d)))
    return bool(reducer(valid))


def compute_bounds(bbox):
    """Face-normal slab bounds (reference evaluator_3dbb.py:47-60).
    Returns (m, 5): [normal(3), min_proj, max_proj]."""
    vertices = bbox["vertices"]
    faces = bbox["faces"]
    v0 = vertices[faces[:, 0]]
    normals = np.cross(vertices[faces[:, 1]] - v0, vertices[faces[:, 2]] - v0)
    normals = normals / np.linalg.norm(normals, axis=-1, keepdims=True)
    projections = normals @ vertices.T
    return np.concatenate([normals,
                           projections.min(-1, keepdims=True),
                           projections.max(-1, keepdims=True)], axis=-1)


def in_bbox(pts, fnbs):
    """Point-in-convex-polytope via slab bounds
    (reference evaluator_3dbb.py:63-74)."""
    projections = fnbs[:, :3] @ pts.T
    is_in = ((fnbs[:, 3:4] - EPS <= projections)
             & (projections <= fnbs[:, 4:5] + EPS))
    return np.all(is_in, axis=0)


def bbox_intercept_labeled(dirs, labels_px, fnbs, box_label):
    """Per-ray nearest intercept with one labeled box
    (reference evaluator_3dbb.py:102-128). Camera-space rays from origin.
    """
    n = dirs.shape[0]
    m = fnbs.shape[0]
    denom = fnbs[:, :3] @ dirs.T                      # (m, n)
    with np.errstate(divide="ignore", invalid="ignore"):
        i1 = (fnbs[:, 3:4] / denom).T[..., None] * dirs[:, None, :]
        i2 = (fnbs[:, 4:5] / denom).T[..., None] * dirs[:, None, :]
    pts = np.concatenate([i1, i2], axis=1).reshape(-1, 3)  # (n*2m, 3)
    is_in = in_bbox(pts, fnbs) & (pts[:, 2] > 0)
    is_label = np.repeat(labels_px.reshape(n, 1) == box_label, 2 * m,
                         axis=1).reshape(-1)
    pts[~(is_in & is_label)] = np.inf
    pts = pts.reshape(n, 2 * m, 3)
    best = np.argmin(pts[:, :, 2], axis=1)
    return pts[np.arange(n), best]


def get_pts(x_range, y_range, z_range, ppm, ppm_y):
    """Query grid with the 5-degree inclination shear
    (reference evaluator_3dbb.py:131-143)."""
    x_res = abs(int((x_range[1] - x_range[0]) * ppm))
    y_res = abs(int((y_range[1] - y_range[0]) * ppm_y))
    z_res = abs(int((z_range[1] - z_range[0]) * ppm))
    x = np.linspace(x_range[0], x_range[1], x_res)[None, None] \
        .repeat(z_res, 1).repeat(y_res, 0)
    z = np.linspace(z_range[0], z_range[1], z_res)[None, :, None] \
        .repeat(y_res, 0).repeat(x_res, 2)
    y = np.linspace(y_range[0], y_range[1], y_res)[:, None, None] \
        .repeat(z_res, 1).repeat(x_res, 2)
    xyz = np.stack([x, y, z], axis=-1)
    xyz[..., 1] -= xyz[..., 2] * 0.0874886635  # tan(5 deg)
    return xyz.astype(np.float32), (x_res, y_res, z_res)


def project_into_cam(pts, proj):
    cam = (proj @ pts.T).T.copy()
    cam[:, :2] /= cam[:, 2:3]
    return cam, cam[:, 2].copy()


def box_depth(bboxes, seg, k_mat, h, w, ph, pw):
    """The label-aware pseudo-depth (ph, pw) of the boxes: each half-res
    pixel ray's nearest intercept with a box of its pixel's label, inf
    where it meets none (the evaluator's ground truth, :189-209)."""
    fnbs = [compute_bounds(b) for b in bboxes]
    labels_box = [int(b["semanticId"]) for b in bboxes]
    xs = np.linspace(-1, 1, pw)
    ys = np.linspace(-1, 1, ph)
    gx, gy = np.meshgrid(xs, ys)
    dirs = np.stack([(gx - k_mat[0, 2]) / k_mat[0, 0],
                     (gy - k_mat[1, 2]) / k_mat[1, 1],
                     np.ones_like(gx)], -1).reshape(-1, 3)
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    seg_half = seg[(np.arange(ph) * (h / ph)).astype(int)][
        :, (np.arange(pw) * (w / pw)).astype(int)]
    labels_px = seg_half.reshape(-1)
    per_box = [bbox_intercept_labeled(dirs, labels_px, fnb, lb)
               for fnb, lb in zip(fnbs, labels_box)]
    stacked = np.stack(per_box, axis=1)      # (n, nbox, 3)
    best = np.argmin(stacked[:, :, 2], axis=1)
    return stacked[np.arange(len(best)), best, 2] \
        .reshape(ph, pw).astype(np.float32)


class BBoxOccEvaluator(OccupancyQuery):
    def __init__(self, net, renderer_cfg, config: dict, dataset):
        super().__init__(net, renderer_cfg, config)
        self.x_range = (-4, 4)
        self.y_range = (0, 1)
        self.z_range = (20, 3)
        self.ppm = 5
        self.ppm_y = 4
        self.dataset = dataset

    def evaluate(self, batch, generator=None, z_samp=None,
                 mark: Optional[Callable[[str], None]] = None) -> dict:
        """batch: numpy dict of one item (imgs (1, v, h, w, 3), poses,
        projs, 3d_bboxes, segs). Encodes at (h, w) and renders the
        pseudo-depth at (h // 2, w // 2), its jitter from `generator` or
        z_samp (h//2 * w//2, n_coarse). mark(name) is called after
        "encode", "render", "query" and "ground_truth". Returns the metric
        dict (python floats)."""
        dev = next(self.net.parameters()).device
        images = torch.as_tensor(batch["imgs"], device=dev)
        if images.shape[0] != 1:
            raise ValueError("the evaluator is per-sample (n == 1)")
        poses_np = np.asarray(batch["poses"])
        projs_np = np.asarray(batch["projs"])
        bboxes = batch["3d_bboxes"]
        if isinstance(bboxes, (list, tuple)) and len(bboxes) == 1 and \
                isinstance(bboxes[0], (list, tuple)):
            bboxes = bboxes[0]
        _, _, h, w, _ = images.shape
        seg = np.asarray(batch["segs"]).reshape(h, w) if "segs" in batch \
            else None
        ph, pw = h // 2, w // 2

        to_keyframe = np.linalg.inv(poses_np[0, 0])
        poses_w = (to_keyframe[None, None] @ poses_np).astype(np.float32)

        # Encode at full resolution; render the pseudo-depth at half
        # (reference :206-251).
        gray = torch.mean(images, dim=-1, keepdim=True) * 0.5 + 0.5
        grid, pred_depth = self.encode_and_depth(
            images, torch.as_tensor(projs_np, device=dev),
            torch.as_tensor(poses_w, device=dev),
            gray[:, :1].expand(-1, -1, -1, -1, 3), (ph, pw), generator,
            z_samp, mark)

        q_pts, _ = get_pts(self.x_range, self.y_range, self.z_range,
                           self.ppm, self.ppm_y)
        q_pts = q_pts.reshape(-1, 3)
        densities = self.query_density(grid, q_pts)
        is_occupied_pred = densities > self.occ_threshold
        if mark:
            mark("query")

        bboxes = [b for b in bboxes
                  if id2label[int(b["semanticId"])].category != "flat"]
        bboxes = [verts_to_cam(b, to_keyframe) for b in bboxes]
        bboxes = [b for b in bboxes
                  if bbox_in_frustum(b, projs_np[0, 0], self.z_range[0])]
        gt_depth = np.full((ph, pw), np.inf, dtype=np.float32)
        if bboxes and seg is not None:
            gt_depth = box_depth(bboxes, seg, projs_np[0, 0], h, w, ph, pw)

        cam_pts, dists = project_into_cam(q_pts, projs_np[0, 0])
        gt_dist = _grid_sample_nearest_ac_true(
            np.nan_to_num(gt_depth, posinf=1e6), cam_pts[:, :2])
        pred_dist = _grid_sample_nearest_ac_true(pred_depth, cam_pts[:, :2])
        is_visible = (dists <= gt_dist) | (dists <= pred_dist)

        is_occupied = np.zeros(q_pts.shape[0], dtype=bool)
        for b in bboxes:
            is_occupied |= in_bbox(q_pts, compute_bounds(b))
        is_occupied &= ~is_visible
        if mark:
            mark("ground_truth")
        return occupancy_metrics(is_occupied_pred, is_occupied, is_visible)
