"""BTSWrapper: the task forward pass that turns a data batch into render
outputs and supervision targets (counterpart of
behindthescenes_tpu/training/wrapper.py:26-284; reference
models/bts/trainer.py:32-276).

`forward(batch, ids, train, draws)` encodes, samples rays, renders and
reconstructs. The step's random choices are a `Draws` record: the flip,
the ray sampler's choices and the coarse jitter. Each field left None is
drawn from the generator passed in.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from behindthescenes_tpu_torch import geometry
from behindthescenes_tpu_torch import renderer as renderer_lib
from behindthescenes_tpu_torch.models.bts import BTSNet
from behindthescenes_tpu_torch.models.image_processor import (
    RGBProcessor, make_image_processor)
from behindthescenes_tpu_torch.ray_sampler import (ImageRaySampler,
                                                   make_ray_sampler)
from behindthescenes_tpu_torch.training.view_select import (ViewIds,
                                                            select_views)


@dataclasses.dataclass
class Draws:
    """The random choices of one forward pass, the JAX package's draws
    from `k_flip`, `k_rays` and `k_render` (wrapper.py:115):
    flip: flip the encoder's input (bool); rays: the train sampler's
    choices (ray_sampler.PatchDraws, or pixel indices (n, R) for the
    random sampler); z_jitter: the coarse jitter (n, R, n_coarse) in [0,
    1)."""
    flip: Optional[bool] = None
    rays: Any = None
    z_jitter: Optional[torch.Tensor] = None


class BTSWrapper:
    """Holds the task config and the net; the forward pass."""

    def __init__(self, net: BTSNet, renderer_cfg: renderer_lib.RendererConfig,
                 config: dict):
        self.net = net
        self.renderer_cfg = renderer_cfg
        self.z_near = config["z_near"]
        self.z_far = config["z_far"]
        self.ray_batch_size = config.get("ray_batch_size", 2048)
        frames_render = config.get("n_frames_render", 2)
        self.frame_sample_mode = config.get("frame_sample_mode", "default")
        self.loss_from_single_img = config.get("loss_from_single_img", False)
        self.sample_mode = config.get("sample_mode", "random")
        self.patch_size = config.get("patch_size", 16)
        self.prediction_mode = config.get("prediction_mode", "multiscale")
        self.flip_augmentation = config.get("flip_augmentation", False)
        if config.get("use_automasking", False):
            raise NotImplementedError(
                "automasking is not ported: ROADMAP Queue A item 5")
        if config.get("alternating_ratio", None) is not None:
            raise NotImplementedError(
                "alternating_ratio is not ported: ROADMAP Queue A item 5")
        self.remat_render = config.get("remat_render", False)
        self.train_ray_chunk = config.get("train_ray_chunk", 512)
        self.eval_ray_chunk = config.get("eval_ray_chunk", 16384)
        self.train_image_processor = make_image_processor(
            config.get("image_processor", {}))
        self.val_image_processor = RGBProcessor()
        self.frames_render = list(range(frames_render)) \
            if isinstance(frames_render, int) else list(frames_render)
        self.train_sampler = make_ray_sampler(
            self.sample_mode, self.ray_batch_size, self.z_near, self.z_far,
            patch_size=self.patch_size,
            channels=self.train_image_processor.channels)
        self.val_sampler = ImageRaySampler(self.z_near, self.z_far)

    def select_views(self, rng: np.random.Generator, v: int,
                     training: bool) -> ViewIds:
        return select_views(rng, v, self.frames_render,
                            self.frame_sample_mode, training,
                            self.loss_from_single_img)

    def net_scales(self):
        return tuple(self.net.encoder.scales)

    def forward(self, batch: dict, ids: ViewIds, train: bool = False,
                renderer_cfg: Optional[renderer_lib.RendererConfig] = None,
                draws: Optional[Draws] = None,
                generator: Optional[torch.Generator] = None,
                mark: Optional[Callable[[str], None]] = None) -> dict:
        """encode -> ray sampling -> render -> reconstruct.

        batch: {"imgs": (n, v, h, w, 3) in [-1, 1], "poses": (n, v, 4, 4)
        c2w, "projs": (n, v, 3, 3)} tensors on the net's device. In train
        mode BatchNorm uses batch statistics and moves its running
        statistics. mark(stage) is called after "encode" and "render".
        Returns the data dict: coarse / fine per-scale lists, rgb_gt,
        rays."""
        cfg = renderer_cfg or self.renderer_cfg
        if cfg.using_fine:
            raise NotImplementedError(
                "training with the fine pass (n_fine > 0) is not ported: "
                "ROADMAP Queue A item 5")
        draws = draws or Draws()
        net = self.net
        images, projs = batch["imgs"], batch["projs"]
        n, v, h, w, _ = images.shape
        dev = images.device
        poses = geometry.rebase_poses_to_keyframe(batch["poses"])
        images_ip = (self.train_image_processor if train
                     else self.val_image_processor)(images)

        do_flip = False
        if self.flip_augmentation and train:
            do_flip = draws.flip if draws.flip is not None else bool(
                torch.rand((), generator=generator, device=dev) > 0.5)
        grid = net.encode(images, projs, poses, ids_encoder=ids.ids_encoder,
                          ids_render=ids.ids_render, images_alt=images_ip,
                          combine_ids=ids.combine_ids,
                          combine_encoder=ids.combine_encoder,
                          combine_render=ids.combine_render,
                          do_flip=do_flip, train=train)
        if mark:
            mark("encode")

        sampler = self.train_sampler if train else dataclasses.replace(
            self.val_sampler, height=h, width=w)
        il = torch.as_tensor(np.asarray(ids.ids_loss, dtype=np.int64),
                             device=dev)
        all_rays, all_rgb_gt = sampler.sample(
            images_ip[:, il], poses[:, il], projs[:, il], draws=draws.rays,
            generator=generator)
        z_jitter = draws.z_jitter
        if z_jitter is None:
            # One draw for every scale, as the JAX package's one k_render.
            z_jitter = torch.rand(all_rays.shape[:2] + (cfg.n_coarse,),
                                  generator=generator, device=dev)

        data = dict(batch)
        data["coarse"], data["fine"] = [], []
        scales = list(self.net_scales()) \
            if self.prediction_mode == "multiscale" else [0]
        for scale in scales:
            def query_fn(xyz, coarse, _scale=scale):
                return net.query(grid, xyz, coarse=coarse, scale=_scale)
            if train and self.remat_render:
                render_dict = renderer_lib.render_rays_chunked(
                    query_fn, all_rays, cfg, ray_chunk=self.train_ray_chunk,
                    remat_body=True, z_jitter=z_jitter, want_weights=True,
                    want_alphas=True, want_rgb_samps=True)
            elif not train:
                # A 192x640 frame's per-sample tensors take about 17.5 GB
                # at once; render it in chunks, without rgb_samps.
                render_dict = renderer_lib.render_rays_chunked(
                    query_fn, all_rays, cfg, ray_chunk=self.eval_ray_chunk,
                    z_jitter=z_jitter, want_weights=True, want_alphas=True)
            else:
                render_dict = renderer_lib.render_rays(
                    query_fn, all_rays, cfg, z_jitter=z_jitter,
                    want_weights=True, want_alphas=True,
                    want_rgb_samps=True)
            render_dict["fine"] = dict(render_dict["coarse"])
            render_dict["rgb_gt"] = all_rgb_gt
            render_dict = sampler.reconstruct(render_dict)
            data["coarse"].append(render_dict["coarse"])
            data["fine"].append(render_dict["fine"])
            data["rgb_gt"] = render_dict.get("rgb_gt")
        data["rays"] = all_rays
        data["z_near"], data["z_far"] = self.z_near, self.z_far
        if not train:
            for branch in ("coarse", "fine"):
                data[branch][0] = dict(data[branch][0])
                data[branch][0]["depth"] = geometry.distance_to_z(
                    data[branch][0]["depth"], projs)
        if mark:
            mark("render")
        return data


def compute_depth_metrics(data: dict, clip_max: float = 80.0) -> dict:
    """The 7 depth metrics (reference trainer.py:278-316) of the first
    view's fine depth against data["depths"], over pixels with depth."""
    depth_gt = data["depths"][:, 0]
    depth_pred = data["fine"][0]["depth"][:, 0]
    if depth_gt.ndim == 4:
        depth_gt = depth_gt[:, 0]
    if depth_pred.shape != depth_gt.shape:
        gh, gw = depth_gt.shape[-2:]
        ph, pw = depth_pred.shape[-2:]
        ys = (torch.arange(gh, device=depth_pred.device) * (ph / gh)).long()
        xs = (torch.arange(gw, device=depth_pred.device) * (pw / gw)).long()
        depth_pred = depth_pred[:, ys][:, :, xs]
    depth_pred = torch.clamp(depth_pred, 1e-3, clip_max)
    mask = depth_gt != 0
    safe_gt = torch.where(mask, depth_gt, torch.ones_like(depth_gt))
    cnt = torch.clamp_min(mask.sum(), 1)

    def mmean(x):
        return torch.where(mask, x, torch.zeros_like(x)).sum() / cnt

    thresh = torch.maximum(safe_gt / depth_pred, depth_pred / safe_gt)
    return {
        "abs_rel": mmean((safe_gt - depth_pred).abs() / safe_gt),
        "sq_rel": mmean((safe_gt - depth_pred) ** 2 / safe_gt),
        "rmse": torch.sqrt(mmean((safe_gt - depth_pred) ** 2)),
        "rmse_log": torch.sqrt(mmean((torch.log(safe_gt)
                                      - torch.log(depth_pred)) ** 2)),
        "a1": mmean((thresh < 1.25).float()),
        "a2": mmean((thresh < 1.25 ** 2).float()),
        "a3": mmean((thresh < 1.25 ** 3).float()),
    }
