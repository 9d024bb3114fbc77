"""BTSWrapper: the task forward pass that turns a data batch into render
outputs and supervision targets (counterpart of
behindthescenes_tpu/training/wrapper.py:26-284; reference
models/bts/trainer.py:32-276).

`forward(batch, ids, train, draws)` encodes, samples rays, renders and
reconstructs. The step's random choices are a `Draws` record: the flip,
the ray sampler's choices, the coarse jitter and the fine pass's draws.
Each field left None is drawn from the generator passed in; with a
process group of several ranks (each holding its rows of the global
batch) every rank draws the global batch's values from the same
generator state and takes its rows, as each device of the JAX package's
sharded step takes its slice of the global draws.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from behindthescenes_tpu_torch import geometry, tracing
from behindthescenes_tpu_torch import renderer as renderer_lib
from behindthescenes_tpu_torch.losses import compute_errors_l1ssim
from behindthescenes_tpu_torch.models.bts import BTSNet
from behindthescenes_tpu_torch.models.image_processor import (
    RGBProcessor, make_image_processor)
from behindthescenes_tpu_torch.parallel.mesh import rank_world
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
    1); fine: the fine pass's importance and around-depth draws
    (renderer.FineDraws of (n, R, ...) tensors). Every scale takes the
    same draws, as every scale of the JAX step takes the one k_render;
    the scales after the first render no fine pass."""
    flip: Optional[bool] = None
    rays: Any = None
    z_jitter: Optional[torch.Tensor] = None
    fine: Optional[renderer_lib.FineDraws] = None


def draw_rows(draw, lo: int, hi: int):
    """Rows lo..hi-1 of a draw: a tensor, or each field of a record of
    draws (Draws, PatchDraws, FineDraws); other values (the flip, None)
    as they are."""
    if isinstance(draw, torch.Tensor):
        return draw[lo:hi]
    if dataclasses.is_dataclass(draw):
        return type(draw)(**{f.name: draw_rows(getattr(draw, f.name), lo, hi)
                             for f in dataclasses.fields(draw)})
    return draw


class BTSWrapper:
    """Holds the task config and the net; the forward pass."""

    def __init__(self, net: BTSNet, renderer_cfg: renderer_lib.RendererConfig,
                 config: dict):
        self.net = net
        self.renderer_cfg = renderer_cfg
        if renderer_cfg.fine_reuse_coarse and net.mlp_fine is not None:
            # With a distinct fine MLP the reference fine pass re-queries
            # the coarse z's through it (nerf.py:230-238 and the coarse
            # flag's dispatch, models_bts.py:311-321); values cached from
            # the coarse MLP would differ.
            raise ValueError(
                "renderer.fine_reuse_coarse requires mlp_fine: empty "
                "(the fine pass must evaluate the same network as coarse)")
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
        self.use_automasking = config.get("use_automasking", False)
        self.remat_render = config.get("remat_render", False)
        self.train_ray_chunk = config.get("train_ray_chunk", 512)
        self.eval_ray_chunk = config.get("eval_ray_chunk", 16384)
        self.train_image_processor = make_image_processor(
            config.get("image_processor", {}))
        self.val_image_processor = RGBProcessor()
        self.frames_render = list(range(frames_render)) \
            if isinstance(frames_render, int) else list(frames_render)
        # The automask's baseline error rides along as one more channel.
        self.train_sampler = make_ray_sampler(
            self.sample_mode, self.ray_batch_size, self.z_near, self.z_far,
            patch_size=self.patch_size,
            channels=self.train_image_processor.channels
            + int(self.use_automasking))
        self.val_sampler = ImageRaySampler(self.z_near, self.z_far)
        # The tile fetch (model_conf.tile_fetch_region): only patch-mode
        # training rays come in tiles (one patch's samples project into a
        # compact quad); validation renders whole frames through the
        # gathers.
        self.query_tiles = None
        if self.sample_mode == "patch" and net.tile_region is not None:
            self.query_tiles = self.train_sampler.patch_count

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
                mark: Optional[Callable[[str], None]] = None,
                group=None) -> dict:
        """encode -> ray sampling -> render -> reconstruct.

        batch: {"imgs": (n, v, h, w, 3) in [-1, 1], "poses": (n, v, 4, 4)
        c2w, "projs": (n, v, 3, 3)} tensors on the net's device. In train
        mode BatchNorm uses batch statistics and moves its running
        statistics. mark(stage) is called after "encode" and "render".
        group: the ranks whose batches join into the global batch, this
        one's rows at rank * n (module docstring). Returns the data dict:
        coarse / fine per-scale lists, rgb_gt, rays."""
        cfg = renderer_cfg or self.renderer_cfg
        draws = draws or Draws()
        net = self.net
        images, projs = batch["imgs"], batch["projs"]
        n, v, h, w, _ = images.shape
        dev = images.device
        poses = geometry.rebase_poses_to_keyframe(batch["poses"])
        images_ip = (self.train_image_processor if train
                     else self.val_image_processor)(images)
        if self.use_automasking and train:
            images_ip = torch.cat(
                [images_ip, automask_error(images_ip, ids.ids_loss)], -1)

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
        il = tracing.to_device(np.asarray(ids.ids_loss, dtype=np.int64),
                               dev)
        rank, world = rank_world(group)
        lo, hi = rank * n, (rank + 1) * n
        ray_draws = draws.rays
        if ray_draws is None and world > 1 and hasattr(sampler, "draw"):
            ray_draws = draw_rows(sampler.draw(
                (n * world, len(il), h, w), generator, dev), lo, hi)
        all_rays, all_rgb_gt = sampler.sample(
            images_ip[:, il], poses[:, il], projs[:, il], draws=ray_draws,
            generator=generator)
        # One draw for every scale, as the JAX package's one k_render.
        z_jitter = draws.z_jitter
        if z_jitter is None:
            z_jitter = draw_rows(torch.rand(
                (n * world,) + all_rays.shape[1:2] + (cfg.n_coarse,),
                generator=generator, device=dev), lo, hi)
        fine_draws = draws.fine
        if cfg.using_fine and fine_draws is None:
            fine_draws = draw_rows(renderer_lib.draw_fine(
                all_rays, cfg, generator, n=n * world), lo, hi)

        data = dict(batch)
        data["coarse"], data["fine"] = [], []
        scales = list(self.net_scales()) \
            if self.prediction_mode == "multiscale" else [0]
        for si, scale in enumerate(scales):
            scale_cfg = cfg if si == 0 else dataclasses.replace(
                cfg, n_fine=0, n_fine_depth=0)

            def query_fn(xyz, coarse, _scale=scale):
                return net.query(grid, xyz, coarse=coarse, scale=_scale,
                                 n_tiles=self.query_tiles if train else None)
            kw = dict(z_jitter=z_jitter, want_weights=True, want_alphas=True,
                      fine_draws=fine_draws if scale_cfg.using_fine
                      else None)
            if train and self.remat_render:
                # Each chunk's query splits its points into query_tiles
                # tiles, as the JAX package's does, padded chunks too.
                render_dict = renderer_lib.render_rays_chunked(
                    query_fn, all_rays, scale_cfg,
                    ray_chunk=self.train_ray_chunk, remat_body=True,
                    want_rgb_samps=True,
                    pad_last=self.query_tiles is not None, **kw)
            elif not train:
                # A 192x640 frame's per-sample tensors take about 17.5 GB
                # at once; render it in chunks, without rgb_samps.
                render_dict = renderer_lib.render_rays_chunked(
                    query_fn, all_rays, scale_cfg,
                    ray_chunk=self.eval_ray_chunk, **kw)
            else:
                render_dict = renderer_lib.render_rays(
                    query_fn, all_rays, scale_cfg, want_rgb_samps=True, **kw)
            if "fine" not in render_dict:
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


def automask_error(images_ip, ids_loss):
    """The automask's baseline (reference trainer.py:201-206): the l1+SSIM
    error between each view and each loss view, both at 0.5x, averaged
    over the loss views. images_ip (n, v, h, w, 3) -> (n, v, h, w, 1)."""
    n, v, h, w, c = images_ip.shape
    il = tracing.to_device(np.asarray(ids_loss, dtype=np.int64),
                           images_ip.device)
    cand = images_ip[:, il] * 0.5                       # (n, nc, h, w, c)
    nc = cand.shape[1]
    a = (images_ip * 0.5)[:, :, :, :, None, :].expand(n, v, h, w, nc, c)
    b = cand.permute(0, 2, 3, 1, 4)[:, None].expand(n, v, h, w, nc, c)
    return compute_errors_l1ssim(a, b).mean(-2)


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
