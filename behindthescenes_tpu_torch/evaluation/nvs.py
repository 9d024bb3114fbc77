"""Novel-view-synthesis evaluator (counterpart of
behindthescenes_tpu/evaluation/nvs.py:27-129; reference
models/bts/evaluator_nvs.py): encode frame 0 (optionally at a reduced
resolution), render every frame from that encoding through the general
cross-view path, and compute PSNR/SSIM/LPIPS with a 5% border crop on
every frame but the source.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from behindthescenes_tpu_torch import geometry
from behindthescenes_tpu_torch.evaluation import metrics as M
from behindthescenes_tpu_torch.models.bts import BTSNet
from behindthescenes_tpu_torch.platform import exact_f32
from behindthescenes_tpu_torch.ray_sampler import ImageRaySampler
from behindthescenes_tpu_torch.renderer import render_rays_chunked

# Rays per chunk of a frame's render (the JAX evaluator's chunk).
EVAL_RAY_CHUNK = 16384


def crop_box(h: int, w: int):
    """The reference's 5% border crop: (y0, y1, x0, x1)."""
    return (int(math.ceil(0.05 * h)), int(math.floor(0.95 * h)),
            int(math.ceil(0.05 * w)), int(math.floor(0.95 * w)))


def render_general(net: BTSNet, images, projs, poses, cfg, z_near: float,
                   z_far: float, generator=None, z_jitter=None,
                   fine_draws=None, images_alt=None, enc_images=None,
                   mark: Optional[Callable[[str], None]] = None) -> dict:
    """Every view's rays of a batch (n = 1) through the cross-view query
    with view 0 encoded, in chunks of EVAL_RAY_CHUNK rays: the render
    dict of both branches (the coarse one standing in for a missing fine
    pass), reconstructed to (1, v, h, w, ...). enc_images replaces the
    encoder's input; z_jitter (1, v*h*w, n_coarse) and fine_draws replace
    the generator's draws; mark(name) is called after "encode" and
    "render"."""
    _, _, h, w, _ = images.shape
    poses_r = geometry.rebase_poses_to_keyframe(poses)
    grid = net.encode(images if enc_images is None else enc_images, projs,
                      poses_r, ids_encoder=[0], ids_render=[0],
                      images_alt=images_alt)
    if mark:
        mark("encode")
    sampler = ImageRaySampler(z_near, z_far, height=h, width=w)
    rays, _ = sampler.sample(None, poses_r, projs)

    def query_fn(xyz, coarse):
        return net.query(grid, xyz, coarse=coarse)

    out = render_rays_chunked(query_fn, rays, cfg, ray_chunk=EVAL_RAY_CHUNK,
                              generator=generator, z_jitter=z_jitter,
                              fine_draws=fine_draws)
    render_dict = sampler.reconstruct(
        {"coarse": out["coarse"],
         "fine": out.get("fine", dict(out["coarse"]))})
    if mark:
        mark("render")
    return render_dict


class NVSEvaluator:
    """Renders every frame of a batch from frame 0's encoding, with
    stratified coarse jitter and the config's fine pass, the draws taken
    from the generator given to `evaluate` unless passed in."""

    def __init__(self, net: BTSNet, renderer_cfg, config: dict,
                 eval_resolution=None, lpips_weights: Optional[str] = None):
        if config.get("nvs_sweep"):
            raise NotImplementedError(
                "model_conf.nvs_sweep (sweep-mode serving, models/sweep.py) "
                "is not ported: ROADMAP Queue A item 10")
        exact_f32()
        self.net = net
        self.cfg = renderer_cfg
        self.z_near = config["z_near"]
        self.z_far = config["z_far"]
        self.eval_resolution = tuple(eval_resolution) if eval_resolution \
            else None
        self.lpips = M.LPIPSVGG.maybe_create(
            lpips_weights, next(net.parameters()).device)

    @torch.no_grad()
    def render(self, images, projs, poses, generator=None, z_jitter=None,
               fine_draws=None, mark=None):
        """rgb (v, h, w, 3) of every frame of a batch (n = 1), averaged
        over the render views, on the model's device (`render_general`'s
        arguments)."""
        _, _, h, w, _ = images.shape
        enc_images = None
        if self.eval_resolution is not None:
            er_h, er_w = self.eval_resolution
            ys = (torch.arange(er_h, device=images.device) * (h / er_h)).long()
            xs = (torch.arange(er_w, device=images.device) * (w / er_w)).long()
            enc_images = images[:, :, ys][:, :, :, xs]
        rd = render_general(self.net, images, projs, poses, self.cfg,
                            self.z_near, self.z_far, generator, z_jitter,
                            fine_draws, images_alt=images[:, :1] * 0.5 + 0.5,
                            enc_images=enc_images, mark=mark)
        return rd["fine"]["rgb"][0].mean(-2)

    def evaluate(self, batch, generator=None, **draws) -> dict:
        """batch: numpy dict with imgs (1, v, h, w, 3), poses, projs.
        draws: z_jitter, fine_draws. Returns psnr, ssim (and lpips) means
        over frames 1..v-1 (python floats)."""
        dev = next(self.net.parameters()).device
        images = torch.as_tensor(batch["imgs"], device=dev)
        if images.shape[0] != 1:
            raise ValueError("the evaluator is per-sample (n == 1)")
        rgb_pred = self.render(
            images, torch.as_tensor(batch["projs"], device=dev),
            torch.as_tensor(batch["poses"], device=dev), generator,
            **draws).float().cpu().numpy()
        rgb_gt = np.asarray(batch["imgs"]) * 0.5 + 0.5
        v, h, w = rgb_pred.shape[:3]
        y0, y1, x0, x1 = crop_box(h, w)
        psnrs, ssims, lpipss = [], [], []
        for vi in range(1, v):   # frame 0 is the source; evaluate the rest
            gt = rgb_gt[0, vi, y0:y1, x0:x1]
            pred = np.clip(rgb_pred[vi, y0:y1, x0:x1], 0, 1)
            psnrs.append(M.psnr(pred, gt))
            ssims.append(M.ssim(pred, gt))
            if self.lpips is not None:
                lpipss.append(self.lpips(pred, gt))
        out = {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims))}
        if lpipss:
            out["lpips"] = float(np.mean(lpipss))
        return out
