"""Depth evaluator (counterpart of
behindthescenes_tpu/evaluation/depth.py:23-205).

Encodes the keyframe, renders its depth through the dense self-view query
or through the general cross-view path, optionally aligns scale (median /
L2 least squares), and computes the 7 standard depth metrics; with
`eval_nvs` (the task runner's `mode: nvs`) it renders every view through
the general path and adds the NVS metrics of the middle frame.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from behindthescenes_tpu_torch import geometry
from behindthescenes_tpu_torch.evaluation import metrics as M
from behindthescenes_tpu_torch.evaluation.nvs import crop_box, render_general
from behindthescenes_tpu_torch.inference import render_depth_selfview
from behindthescenes_tpu_torch.models.bts import BTSNet
from behindthescenes_tpu_torch.platform import exact_f32


class DepthEvaluator:
    """The self-view path unless the config says `eval_selfview: false`
    or `eval_nvs` is set: with `jitter=False` (code_mode z) the
    deterministic shared-z ladder, the JAX evaluator's default; with
    `jitter=True` stratified jitter per ray (the reference's sampling),
    drawn from the generator given to `evaluate`. The general path renders
    every view's rays through the cross-view query in chunks, with
    stratified jitter and the config's fine pass, as the JAX evaluator
    does."""

    def __init__(self, net: BTSNet, renderer_cfg, config: dict,
                 jitter: bool = False, eval_nvs: bool = False,
                 lpips_weights: Optional[str] = None):
        sv = config.get("eval_selfview", "auto")
        self.use_selfview = (True if sv == "auto" else bool(sv)) \
            and not eval_nvs
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
        self.eval_nvs = eval_nvs
        self.lpips = M.LPIPSVGG.maybe_create(
            lpips_weights, next(net.parameters()).device) if eval_nvs \
            else None

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
    def render_dict_general(self, images, projs, poses, generator=None,
                            z_jitter=None, fine_draws=None) -> dict:
        """Both branches' render dicts of every view through the general
        path (behindthescenes_tpu/evaluation/depth.py:61-88), the depth
        converted from ray distance to z: `nvs.render_general`'s
        arguments."""
        render_dict = render_general(self.net, images, projs, poses,
                                     self.cfg, self.z_near, self.z_far,
                                     generator, z_jitter, fine_draws)
        for branch in ("coarse", "fine"):
            render_dict[branch]["depth"] = geometry.distance_to_z(
                render_dict[branch]["depth"], projs)
        return render_dict

    def render_general(self, images, projs, poses, generator=None,
                       z_jitter=None):
        """z-depth (1, v, h, w) of every view through the general path."""
        return self.render_dict_general(images, projs, poses, generator,
                                        z_jitter)["fine"]["depth"]

    def evaluate(self, batch, generator=None, **draws) -> dict:
        """batch: numpy dict with imgs (1, v, h, w, 3), poses, projs,
        depths (1, 1, H0, W0). draws: z_samp (self-view), or z_jitter and
        fine_draws (general path). Returns the metric dict (python
        floats)."""
        dev = next(self.net.parameters()).device
        images = torch.as_tensor(batch["imgs"], device=dev)
        if images.shape[0] != 1:
            raise ValueError("the evaluator is per-sample (n == 1)")
        projs = torch.as_tensor(batch["projs"], device=dev)
        poses = torch.as_tensor(batch["poses"], device=dev)
        if not self.eval_nvs:
            depth = self.render(images, projs, poses, generator, **draws)
            return self.compute_depth_metrics(depth[None].cpu().numpy(),
                                              np.asarray(batch["depths"]))
        render_dict = self.render_dict_general(images, projs, poses,
                                               generator, **draws)
        out = self.compute_depth_metrics(
            render_dict["fine"]["depth"].cpu().numpy(),
            np.asarray(batch["depths"]))
        out.update(self.compute_nvs_metrics(render_dict, batch))
        return out

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

    def compute_nvs_metrics(self, render_dict, batch) -> dict:
        """(reference evaluator.py:153-187): the middle frame, 5% crop."""
        rgb_gt = np.asarray(batch["imgs"]) * 0.5 + 0.5   # (1, v, h, w, 3)
        v = rgb_gt.shape[1]
        sf_id = v // 2
        gt = rgb_gt[0, sf_id]
        pred = render_dict["fine"]["rgb"][0, sf_id].float().cpu().numpy()
        pred = pred.reshape(gt.shape[0], gt.shape[1], -1, 3).mean(-2)
        y0, y1, x0, x1 = crop_box(*gt.shape[:2])
        gt = gt[y0:y1, x0:x1]
        pred = pred[y0:y1, x0:x1]
        out = {"ssim": M.ssim(pred, gt, data_range=1.0),
               "psnr": M.psnr(pred, gt, data_range=1.0)}
        if self.lpips is not None:
            out["lpips"] = self.lpips(pred, gt)
        return out
