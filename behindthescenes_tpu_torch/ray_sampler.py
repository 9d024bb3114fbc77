"""Ray samplers (counterpart of behindthescenes_tpu/ray_sampler.py:20-224).

`sample(images, poses, projs, ...)` -> (rays (n, R, 8), rgb_gt (n, R, c));
images are (n, v, h, w, c) channel-last. The random choices of the random
and the patch samplers are passed in as data (`PatchDraws`, pixel
indices) or drawn from a `torch.Generator`; `draw` makes them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from behindthescenes_tpu_torch import geometry


def _gen_all_rays(poses, projs, w, h, z_near, z_far, norm_dir=True):
    """(v, 4, 4), (v, 3, 3) -> (v, h, w, 8)."""
    focals = torch.stack([projs[:, 0, 0], projs[:, 1, 1]], -1)
    centers = torch.stack([projs[:, 0, 2], projs[:, 1, 2]], -1)
    return geometry.gen_rays(poses, w, h, z_near, z_far, focal=focals,
                             c=centers, norm_dir=norm_dir)


def _reshape_render_dict(render_dict, reshape_ray_dim, channels):
    """Apply `reshape_ray_dim(x, extra_dims)` to every per-ray tensor of
    the coarse and fine branches."""
    for branch_name in ("coarse", "fine"):
        branch = render_dict[branch_name]
        v = branch["rgb"].shape[-1] // channels
        out = dict(branch)
        out["rgb"] = reshape_ray_dim(branch["rgb"], (v, channels))
        out["depth"] = reshape_ray_dim(branch["depth"], ())
        out["invalid"] = reshape_ray_dim(branch["invalid"],
                                         tuple(branch["invalid"].shape[-2:]))
        for key in ("weights", "alphas", "z_samps"):
            if key in branch:
                out[key] = reshape_ray_dim(branch[key],
                                           (branch[key].shape[-1],))
        if "rgb_samps" in branch:
            ns = branch["rgb_samps"].shape[-2]
            out["rgb_samps"] = reshape_ray_dim(branch["rgb_samps"],
                                               (ns, v, channels))
        render_dict[branch_name] = out
    return render_dict


@dataclasses.dataclass
class PatchDraws:
    """The patch sampler's choices, each (n, patch_count) int64: the view
    among the loss views, and the top-left corner's row and column."""
    views: torch.Tensor
    ys: torch.Tensor
    xs: torch.Tensor


@dataclasses.dataclass(frozen=True)
class RandomRaySampler:
    """Uniform random pixel rays (reference ray_sampler.py:15-106). Draws:
    pixel indices (n, ray_batch_size) into the flattened (v, h, w) rays."""
    ray_batch_size: int
    z_near: float
    z_far: float
    channels: int = 3

    def draw(self, shape, generator, device) -> torch.Tensor:
        n, v, h, w = shape
        return torch.randint(0, v * h * w, (n, self.ray_batch_size),
                             generator=generator, device=device)

    def sample(self, images, poses, projs, draws=None, generator=None):
        n, v, h, w, c = images.shape
        if draws is None:
            draws = self.draw((n, v, h, w), generator, images.device)
        rays, rgb = [], []
        for i in range(n):
            r = _gen_all_rays(poses[i], projs[i], w, h, self.z_near,
                              self.z_far).reshape(-1, 8)
            rays.append(r[draws[i]])
            rgb.append(images[i].reshape(-1, c)[draws[i]])
        return torch.stack(rays), torch.stack(rgb)

    def reconstruct(self, render_dict, channels: Optional[int] = None):
        channels = channels or self.channels

        def reshape(x, extra):
            return x.reshape((x.shape[0], self.ray_batch_size) + extra)

        render_dict = _reshape_render_dict(render_dict, reshape, channels)
        if "rgb_gt" in render_dict:
            render_dict["rgb_gt"] = reshape(render_dict["rgb_gt"],
                                            (channels,))
        return render_dict


@dataclasses.dataclass(frozen=True)
class PatchRaySampler:
    """Random p x p pixel patches, which the SSIM and smoothness losses
    need (reference ray_sampler.py:109-221)."""
    ray_batch_size: int
    z_near: float
    z_far: float
    patch_size: int | tuple = 8
    channels: int = 3

    @property
    def patch_size_yx(self):
        if isinstance(self.patch_size, int):
            return self.patch_size, self.patch_size
        return tuple(self.patch_size)

    @property
    def patch_count(self):
        py, px = self.patch_size_yx
        if self.ray_batch_size % (py * px):
            raise ValueError("ray_batch_size must be a multiple of the "
                             "patch area")
        return self.ray_batch_size // (py * px)

    def draw(self, shape, generator, device) -> PatchDraws:
        """Views in [0, v), rows in [0, h - py), columns in [0, w - px), as
        the JAX sampler's randint draws them."""
        n, v, h, w = shape
        py, px = self.patch_size_yx
        size = (n, self.patch_count)

        def randint(high):
            return torch.randint(0, high, size, generator=generator,
                                 device=device)
        return PatchDraws(views=randint(v), ys=randint(h - py),
                          xs=randint(w - px))

    def sample(self, images, poses, projs, draws: PatchDraws = None,
               generator=None):
        n, v, h, w, c = images.shape
        py, px = self.patch_size_yx
        pc = self.patch_count
        dev = images.device
        if draws is None:
            draws = self.draw((n, v, h, w), generator, dev)
        dy = torch.arange(py, device=dev)[None, :, None]
        dx = torch.arange(px, device=dev)[None, None, :]
        rays, rgb = [], []
        for i in range(n):
            all_rays = _gen_all_rays(poses[i], projs[i], w, h, self.z_near,
                                     self.z_far)                # (v, h, w, 8)
            yy = draws.ys[i].to(dev)[:, None, None] + dy
            xx = draws.xs[i].to(dev)[:, None, None] + dx
            vv = draws.views[i].to(dev)[:, None, None].expand(pc, py, px)
            yy = yy.expand(pc, py, px)
            xx = xx.expand(pc, py, px)
            rays.append(all_rays[vv, yy, xx].reshape(-1, 8))
            rgb.append(images[i][vv, yy, xx].reshape(-1, c))
        return torch.stack(rays), torch.stack(rgb)

    def reconstruct(self, render_dict, channels: Optional[int] = None):
        channels = channels or self.channels
        py, px = self.patch_size_yx
        pc = self.patch_count

        def reshape(x, extra):
            return x.reshape((x.shape[0], pc, py, px) + extra)

        render_dict = _reshape_render_dict(render_dict, reshape, channels)
        if "rgb_gt" in render_dict:
            render_dict["rgb_gt"] = reshape(render_dict["rgb_gt"],
                                            (channels,))
        return render_dict


@dataclasses.dataclass(frozen=True)
class ImageRaySampler:
    """All rays of all views (reference ray_sampler.py:224-321); draws
    nothing."""
    z_near: float
    z_far: float
    height: Optional[int] = None
    width: Optional[int] = None
    channels: int = 3
    norm_dir: bool = True

    def sample(self, images, poses, projs, draws=None, generator=None):
        n, v = poses.shape[:2]
        h, w = (images.shape[2:4] if images is not None
                else (self.height, self.width))
        h = self.height or h
        w = self.width or w
        rays = torch.stack([
            _gen_all_rays(poses[i], projs[i], w, h, self.z_near, self.z_far,
                          norm_dir=self.norm_dir).reshape(-1, 8)
            for i in range(n)])
        rgb = None if images is None else \
            images.reshape(n, v * h * w, images.shape[-1])
        return rays, rgb

    def reconstruct(self, render_dict, channels: Optional[int] = None,
                    height: Optional[int] = None,
                    width: Optional[int] = None):
        channels = channels or self.channels
        h = height or self.height
        w = width or self.width
        n, n_pts, _ = render_dict["coarse"]["rgb"].shape
        v_in = n_pts // (h * w)

        def reshape(x, extra):
            return x.reshape((n, v_in, h, w) + extra)

        render_dict = _reshape_render_dict(render_dict, reshape, channels)
        if render_dict.get("rgb_gt") is not None:
            render_dict["rgb_gt"] = reshape(render_dict["rgb_gt"],
                                            (channels,))
        return render_dict


def make_ray_sampler(sample_mode: str, ray_batch_size: int, z_near, z_far,
                     patch_size=8, channels: int = 3):
    """Sampler factory (reference models/bts/trainer.py:64-71)."""
    if sample_mode == "random":
        return RandomRaySampler(ray_batch_size, z_near, z_far, channels)
    if sample_mode == "patch":
        return PatchRaySampler(ray_batch_size, z_near, z_far, patch_size,
                               channels)
    if sample_mode == "image":
        return ImageRaySampler(z_near, z_far, channels=channels)
    raise NotImplementedError(sample_mode)
