"""Self-supervised reconstruction loss (counterpart of
behindthescenes_tpu/losses.py:19-298; reference models/bts/model/loss.py).

A pure function of the render dict, with the JAX package's branches: the
criteria, the invalid policies, the regularizers, the Monodepth2-style
minimum over the reconstructing views, and median thresholding as a
masked mean. The minimum is `torch.amin`, which shares the gradient among
tied views as `jnp.min` does (`torch.min(dim)` would send it to one).

With a process group of several ranks (data parallel training) each rank
holds its rows of the global batch, and every mean over the batch, masked
or not, takes the numerator and denominator of the whole global batch
(`parallel.mesh.global_mean`); per-item statistics (the disparity's
normalisation, the median threshold) stay per item. Every rank then
holds the global loss and its terms; the reduction's gradient reaches
each rank `world` times, which the trainer divides out.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from behindthescenes_tpu_torch.ops.ssim import ssim
from behindthescenes_tpu_torch.parallel.mesh import all_reduce_sum, global_mean


def compute_errors_l1ssim(img0, img1):
    """0.85 SSIM + 0.15 L1 (reference loss.py:10-18).
    img0 (n, pc, h, w, nv, c); img1 broadcastable, (n, pc, h, w, 1, c).
    Returns (n, pc, h, w, nv, 1)."""
    n, pc, h, w, nv, c = img0.shape
    img1 = img1.expand(img0.shape)
    a = img0.permute(0, 1, 4, 2, 3, 5).reshape(-1, h, w, c)
    b = img1.permute(0, 1, 4, 2, 3, 5).reshape(-1, h, w, c)
    s = ssim(a, b, pad_reflection=False, gaussian_average=True,
             comp_mode=True)
    err = 0.85 * s.mean(-1) + 0.15 * (a - b).abs().mean(-1)
    return err.reshape(n, pc, nv, h, w).permute(0, 1, 3, 4, 2)[..., None]


def _nearest_index(out_size: int, in_size: int, device) -> torch.Tensor:
    return (torch.arange(out_size, device=device)
            * (in_size / out_size)).long()


def edge_aware_smoothness(gt_img, depth):
    """Disparity smoothness weighted by image gradients (reference
    loss.py:21-40). gt_img (n, pc, h', w', nv, 3) or (n, pc, h', w', 3);
    depth (n, pc, h, w). Returns (n, pc, h, w)."""
    n, pc, h, w = depth.shape
    img = gt_img[..., 0, :] if gt_img.ndim == 6 else gt_img
    if tuple(img.shape[2:4]) != (h, w):
        img = img[:, :, _nearest_index(h, img.shape[2], img.device)]
        img = img[:, :, :, _nearest_index(w, img.shape[3], img.device)]
    disp = 1.0 / torch.clamp(depth, 1e-3, 80.0)
    disp = disp / disp.mean(dim=(-2, -1), keepdim=True)
    d_dx = (disp[..., :, :-1] - disp[..., :, 1:]).abs()
    d_dy = (disp[..., :-1, :] - disp[..., 1:, :]).abs()
    i_dx = (img[..., :, :-1, :] - img[..., :, 1:, :]).abs().mean(-1)
    i_dy = (img[..., :-1, :, :] - img[..., 1:, :, :]).abs().mean(-1)
    d_dx = d_dx * torch.exp(-i_dx)
    d_dy = d_dy * torch.exp(-i_dy)
    return (torch.nn.functional.pad(d_dx, (0, 1))
            + torch.nn.functional.pad(d_dy, (0, 0, 0, 1)))


def _masked_mean(x, keep_mask, group=None):
    return all_reduce_sum(torch.sum(x * keep_mask), group) \
        / torch.clamp_min(all_reduce_sum(keep_mask.sum(), group), 1.0)


@dataclasses.dataclass(frozen=True)
class ReconstructionLoss:
    """Mirrors the reference ReconstructionLoss (loss.py:43-293).
    use_automasking: the last channel of the predictions and of rgb_gt is
    the automask's baseline error (training/wrapper.py); it is stripped
    off, and each ray's photometric error is capped at it."""
    criterion: str = "l2"
    invalid_policy: str = "strict"
    lambda_coarse: float = 1.0
    lambda_fine: float = 1.0
    lambda_entropy: float = 0.0
    lambda_depth_reg: float = 0.0
    lambda_alpha_reg: float = 0.0
    lambda_surfaceness_reg: float = 0.0
    lambda_edge_aware_smoothness: float = 0.0
    lambda_depth_smoothness: float = 0.0
    median_thresholding: bool = False
    alpha_reg_reduction: str = "ray"
    alpha_reg_fraction: float = 1.0 / 8
    use_automasking: bool = False

    @classmethod
    def from_conf(cls, conf: dict, use_automasking: bool = False):
        return cls(
            criterion=conf.get("criterion", "l2"),
            invalid_policy=conf.get("invalid_policy", "strict"),
            lambda_coarse=conf.get("lambda_coarse", 1),
            lambda_fine=conf.get("lambda_fine", 1),
            lambda_entropy=conf.get("lambda_entropy", 0),
            lambda_depth_reg=conf.get("lambda_depth_reg", 0),
            lambda_alpha_reg=conf.get("lambda_alpha_reg", 0),
            lambda_surfaceness_reg=conf.get("lambda_surfaceness_reg", 0),
            lambda_edge_aware_smoothness=conf.get(
                "lambda_edge_aware_smoothness", 0),
            lambda_depth_smoothness=conf.get("lambda_depth_smoothness", 0),
            median_thresholding=conf.get("median_thresholding", False),
            alpha_reg_reduction=conf.get("alpha_reg_reduction", "ray"),
            alpha_reg_fraction=conf.get("alpha_reg_fraction", 1 / 8),
            use_automasking=use_automasking)

    @property
    def ignore_invalid(self) -> bool:
        return self.invalid_policy not in (None, "none")

    def _crit(self, pred, gt):
        if self.criterion == "l2":
            return (pred - gt) ** 2
        if self.criterion == "l1":
            return (pred - gt).abs()
        if self.criterion == "l1+ssim":
            return compute_errors_l1ssim(pred, gt)
        raise NotImplementedError(self.criterion)

    def _invalid_mask(self, branch):
        """Per-ray invalid indicator (n, pc, h, w, 1) bool."""
        invalid = branch["invalid"]
        if self.invalid_policy == "strict":
            return (invalid > 0.5).any(-2).all(-1, keepdim=True)
        if self.invalid_policy in ("weight_guided", "weight_guided_diverse"):
            mass = torch.sum(invalid.float() * branch["weights"][..., None],
                             -2)
            mask = mass > 0.9
            if self.invalid_policy == "weight_guided_diverse":
                ray_std = branch["rgb_samps"].std(dim=-3,
                                                  unbiased=False).mean(-1)
                mask = mask | (ray_std < 0.01)
            return mask.all(-1, keepdim=True)
        if self.invalid_policy in (None, "none"):
            return torch.zeros(invalid.shape[:-2] + (1,), dtype=torch.bool,
                               device=invalid.device)
        raise NotImplementedError(self.invalid_policy)

    def _rgb_loss(self, rgb_pred, rgb_gt_b, invalid_ray, thresh_gt=None,
                  group=None):
        rl = self._crit(rgb_pred, rgb_gt_b)         # (n, pc, h, w, nv, c|1)
        rl = torch.amin(rl, dim=-2)                 # min over views
        if thresh_gt is not None:
            rl = torch.minimum(rl, thresh_gt)
        if self.ignore_invalid:
            rl = rl * (1.0 - invalid_ray.to(rl.dtype))
        if self.median_thresholding:
            thr = torch.quantile(rl.reshape(rl.shape[0], -1), 0.5, dim=-1)
            keep = rl <= thr.reshape((-1,) + (1,) * (rl.ndim - 1))
            return _masked_mean(rl, keep.to(rl.dtype), group)
        return global_mean(rl, group)

    def __call__(self, data, group=None):
        """data: "coarse" / "fine" per-scale lists of reconstructed render
        dicts ((n, pc, h, w, ...)) and "rgb_gt" (n, pc, h, w, c); group:
        the ranks whose rows make up the global batch (module docstring).
        Returns (total loss, dict of scalar terms)."""

        def mean(x):
            return global_mean(x, group)

        n_scales = len(data["coarse"])
        coarse_0, fine_0 = data["coarse"][0], data["fine"][0]
        invalid_coarse = self._invalid_mask(coarse_0)
        invalid_fine = self._invalid_mask(fine_0)
        zero = torch.zeros((), device=invalid_coarse.device)
        loss = zero
        terms = {k: zero for k in ("loss_rgb_coarse", "loss_rgb_fine",
                                   "loss_depth_reg", "loss_alpha_reg",
                                   "loss_surfaceness_reg", "loss_eas",
                                   "loss_depth_smoothness")}
        for scale in range(n_scales):
            coarse, fine = data["coarse"][scale], data["fine"][scale]
            rgb_coarse, rgb_fine = coarse["rgb"], fine.get("rgb")
            rgb_gt, thresh_gt = data["rgb_gt"], None
            if self.use_automasking:
                thresh_gt = rgb_gt[..., -1:]
                rgb_gt = rgb_gt[..., :-1]
                rgb_coarse = rgb_coarse[..., :-1]
                if rgb_fine is not None:
                    rgb_fine = rgb_fine[..., :-1]
            rgb_gt_b = rgb_gt[..., None, :]           # (n, pc, h, w, 1, c)
            rgb_loss = self._rgb_loss(rgb_coarse, rgb_gt_b, invalid_coarse,
                                      thresh_gt, group)
            terms["loss_rgb_coarse"] = terms["loss_rgb_coarse"] \
                + rgb_loss * self.lambda_coarse
            if len(fine) > 0:
                fine_loss = self._rgb_loss(rgb_fine, rgb_gt_b, invalid_fine,
                                           thresh_gt, group)
                terms["loss_rgb_fine"] = terms["loss_rgb_fine"] \
                    + fine_loss * self.lambda_fine
                rgb_loss = (rgb_loss * self.lambda_coarse
                            + fine_loss * self.lambda_fine)
            loss = loss + rgb_loss

            depths = coarse["depth"]
            valid = 1.0 - invalid_coarse[..., 0].float()
            if self.lambda_depth_reg > 0:
                diffs_x = depths[:, :, 1:, :] - depths[:, :, :-1, :]
                diffs_y = depths[:, :, :, 1:] - depths[:, :, :, :-1]
                term = mean(diffs_x ** 2) + mean(diffs_y ** 2)
                terms["loss_depth_reg"] = terms["loss_depth_reg"] + term
                loss = loss + term * self.lambda_depth_reg
            if self.lambda_alpha_reg > 0:
                alphas = coarse["alphas"]
                alpha_sum = alphas[..., :-1].sum(-1)
                min_cap = torch.full_like(
                    alpha_sum, alphas.shape[-1] * self.alpha_reg_fraction)
                if self.ignore_invalid:
                    alpha_sum = alpha_sum * valid
                    min_cap = min_cap * valid
                if self.alpha_reg_reduction == "ray":
                    term = torch.clamp_min(alpha_sum - min_cap, 0.0)
                elif self.alpha_reg_reduction == "slice":
                    term = torch.clamp_min(
                        alpha_sum.sum(-1) - min_cap.sum(-1), 0.0) \
                        / alpha_sum.shape[-1]
                else:
                    raise ValueError(self.alpha_reg_reduction)
                term = mean(term)
                terms["loss_alpha_reg"] = terms["loss_alpha_reg"] + term
                loss = loss + term * self.lambda_alpha_reg
            if self.lambda_surfaceness_reg > 0:
                alphas = coarse["alphas"]
                p = -torch.log(torch.exp(-alphas.abs())
                               + torch.exp(-(1.0 - alphas).abs())).mean(-1)
                if self.ignore_invalid:
                    p = p * valid
                term = mean(p)
                terms["loss_surfaceness_reg"] = \
                    terms["loss_surfaceness_reg"] + term
                loss = loss + term * self.lambda_surfaceness_reg
            if self.lambda_edge_aware_smoothness > 0:
                l_map = edge_aware_smoothness(rgb_gt_b, depths)
                if self.ignore_invalid:
                    inv = invalid_coarse[..., 0].float()
                    if inv.shape[-2:] != l_map.shape[-2:]:
                        inv = inv[..., _nearest_index(
                            l_map.shape[-2], inv.shape[-2], inv.device), :]
                        inv = inv[..., _nearest_index(
                            l_map.shape[-1], inv.shape[-1], inv.device)]
                    l_map = l_map * (1.0 - torch.ceil(inv))
                term = mean(l_map)
                terms["loss_eas"] = terms["loss_eas"] + term
                loss = loss + (term * self.lambda_edge_aware_smoothness
                               / (2 ** scale))
            if self.lambda_depth_smoothness > 0:
                term = (mean((depths[..., :-1, :] - depths[..., 1:, :]) ** 2)
                        + mean((depths[..., :, :-1]
                                - depths[..., :, 1:]) ** 2))
                terms["loss_depth_smoothness"] = \
                    terms["loss_depth_smoothness"] + term
                loss = loss + term * self.lambda_depth_smoothness
        loss = loss / n_scales

        loss_ray_entropy = zero
        if self.lambda_entropy > 0:
            alphas = coarse_0["alphas"] + 1e-5
            ray_density = alphas / alphas.sum(-1, keepdim=True)
            ray_entropy = -(ray_density * torch.log(ray_density)).sum(-1) \
                / math.log2(alphas.shape[-1])
            ray_entropy = ray_entropy * (
                1.0 - invalid_coarse[..., 0].to(ray_entropy.dtype))
            loss_ray_entropy = mean(ray_entropy)
        loss = loss + loss_ray_entropy * self.lambda_entropy
        loss_dict = {
            "loss_rgb_coarse": terms["loss_rgb_coarse"],
            "loss_rgb_fine": terms["loss_rgb_fine"],
            "loss_ray_entropy": loss_ray_entropy,
            "loss_depth_reg": terms["loss_depth_reg"],
            "loss_alpha_reg": terms["loss_alpha_reg"],
            "loss_eas": terms["loss_eas"],
            "loss_depth_smoothness": terms["loss_depth_smoothness"],
            "loss_invalid_ratio": mean(invalid_coarse.float()),
            "loss": loss,
        }
        return loss, loss_dict
