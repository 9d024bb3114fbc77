"""Depth evaluator (counterpart of
behindthescenes_tpu/evaluation/depth.py:23-182).

Encodes the keyframe, renders its depth through the dense self-view query
or through the general cross-view path, optionally aligns scale (median /
L2 least squares), and computes the 7 standard depth metrics. The NVS
metrics are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from behindthescenes_tpu_torch import geometry
from behindthescenes_tpu_torch.inference import render_depth_selfview
from behindthescenes_tpu_torch.models.bts import BTSNet
from behindthescenes_tpu_torch.platform import exact_f32
from behindthescenes_tpu_torch.ray_sampler import ImageRaySampler
from behindthescenes_tpu_torch.renderer import render_rays_chunked

# Rays per chunk of the general path: a 192x640 frame's per-sample tensors
# take about 17.5 GB at once (the JAX evaluator's chunk).
EVAL_RAY_CHUNK = 16384


class DepthEvaluator:
    """The self-view path unless the config says `eval_selfview: false`:
    with `jitter=False` (code_mode z) the deterministic shared-z ladder, the
    JAX evaluator's default; with `jitter=True` stratified jitter per ray
    (the reference's sampling), drawn from the generator given to
    `evaluate`. The general path renders every view's rays through the
    cross-view query in chunks, with stratified jitter, as the JAX
    evaluator does."""

    def __init__(self, net: BTSNet, renderer_cfg, config: dict,
                 jitter: bool = False):
        sv = config.get("eval_selfview", "auto")
        self.use_selfview = True if sv == "auto" else bool(sv)
        exact_f32()
        self.net = net
        self.cfg = renderer_cfg
        self.z_near = config["z_near"]
        self.z_far = config["z_far"]
        self.depth_scaling = config.get("depth_scaling", None)
        code_mode = config.get("code_mode", "z")
        if code_mode not in ("z", "distance"):
            raise NotImplementedError(code_mode)
        self.deterministic = code_mode == "z" and not jitter

    @torch.no_grad()
    def render(self, images, projs, poses, generator=None, z_samp=None,
               z_jitter=None):
        """Keyframe z-depth (1, h, w) of a batch (n = 1) on the model's
        device. z_samp (self-view) and z_jitter (general path) replace the
        generator's draws."""
        if not self.use_selfview:
            return self.render_general(images, projs, poses, generator,
                                       z_jitter)[:, 0]
        _, _, h, w, _ = images.shape
        poses_r = geometry.rebase_poses_to_keyframe(poses)
        grid = self.net.encode(images, projs, poses_r, ids_encoder=[0],
                               ids_render=[0])
        depth, _, _ = render_depth_selfview(
            self.net, grid, h, w, self.cfg, self.z_near, self.z_far,
            as_z_depth=True, deterministic=self.deterministic,
            generator=generator, z_samp=z_samp)
        return depth

    @torch.no_grad()
    def render_general(self, images, projs, poses, generator=None,
                       z_jitter=None):
        """z-depth (1, v, h, w) of every view through the general path
        (behindthescenes_tpu/evaluation/depth.py:61-88): all rays of all
        views, the cross-view query with the keyframe encoded, chunks of
        EVAL_RAY_CHUNK rays, ray distance to z. z_jitter (1, v*h*w, K)
        replaces the generator's coarse jitter."""
        _, _, h, w, _ = images.shape
        poses_r = geometry.rebase_poses_to_keyframe(poses)
        grid = self.net.encode(images, projs, poses_r, ids_encoder=[0],
                               ids_render=[0])
        sampler = ImageRaySampler(self.z_near, self.z_far, height=h,
                                  width=w)
        rays, _ = sampler.sample(None, poses_r, projs)

        def query_fn(xyz, coarse):
            return self.net.query(grid, xyz, coarse=coarse)

        out = render_rays_chunked(query_fn, rays, self.cfg,
                                  ray_chunk=EVAL_RAY_CHUNK,
                                  generator=generator, z_jitter=z_jitter)
        render_dict = sampler.reconstruct(
            {"coarse": out["coarse"], "fine": dict(out["coarse"])})
        return geometry.distance_to_z(render_dict["fine"]["depth"], projs)

    def evaluate(self, batch, generator=None) -> dict:
        """batch: numpy dict with imgs (1, v, h, w, 3), poses, projs,
        depths (1, 1, H0, W0). Returns the metric dict (python floats)."""
        dev = next(self.net.parameters()).device
        images = torch.as_tensor(batch["imgs"], device=dev)
        if images.shape[0] != 1:
            raise ValueError("the evaluator is per-sample (n == 1)")
        depth = self.render(images, torch.as_tensor(batch["projs"],
                                                    device=dev),
                            torch.as_tensor(batch["poses"], device=dev),
                            generator)
        return self.compute_depth_metrics(depth[None].cpu().numpy(),
                                          np.asarray(batch["depths"]))

    def compute_depth_metrics(self, depth_pred_all, depth_gt_all) -> dict:
        """(reference evaluator.py:96-151)."""
        depth_gt = depth_gt_all[0, 0]                  # (H0, W0)
        if depth_gt.ndim == 3:
            depth_gt = depth_gt[0]
        depth_pred = depth_pred_all[0, 0]              # (h, w)

        gh, gw = depth_gt.shape
        ph, pw = depth_pred.shape
        if (ph, pw) != (gh, gw):
            ys = (np.arange(gh) * (ph / gh)).astype(np.int64)
            xs = (np.arange(gw) * (pw / gw)).astype(np.int64)
            depth_pred = depth_pred[ys][:, xs]

        mask = depth_gt > 0
        if self.depth_scaling == "median" and mask.any():
            scaling = np.median(depth_gt[mask]) / np.median(depth_pred[mask])
            depth_pred = depth_pred * scaling
        elif self.depth_scaling == "l2" and mask.any():
            dp = depth_pred[mask]
            a = np.stack([dp, np.ones_like(dp)], -1)
            x, *_ = np.linalg.lstsq(a, depth_gt[mask][:, None], rcond=None)
            depth_pred = depth_pred * x[0, 0] + x[1, 0]

        depth_pred = np.clip(depth_pred, 1e-3, 80.0)
        gt = depth_gt[mask]
        pred = depth_pred[mask]

        thresh = np.maximum(gt / pred, pred / gt)
        return {
            "abs_rel": float(np.mean(np.abs(gt - pred) / gt)),
            "sq_rel": float(np.mean((gt - pred) ** 2 / gt)),
            "rmse": float(np.sqrt(np.mean((gt - pred) ** 2))),
            "rmse_log": float(np.sqrt(np.mean(
                (np.log(gt) - np.log(pred)) ** 2))),
            "a1": float(np.mean(thresh < 1.25)),
            "a2": float(np.mean(thresh < 1.25 ** 2)),
            "a3": float(np.mean(thresh < 1.25 ** 3)),
        }
