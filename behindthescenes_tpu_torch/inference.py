"""Inference helpers (counterpart of behindthescenes_tpu/inference.py;
reference scripts/inference_setup.py:100-229): full-frame self-view
depth, novel views through the general path, and the top-down (BEV)
density profile."""
from __future__ import annotations

import torch

from behindthescenes_tpu_torch import geometry
from behindthescenes_tpu_torch import renderer as renderer_lib
from behindthescenes_tpu_torch.models.bts import BTSNet, FeatureGrid
from behindthescenes_tpu_torch.ray_sampler import ImageRaySampler


def render_depth_selfview(net: BTSNet, grid: FeatureGrid, height: int,
                          width: int, cfg: renderer_lib.RendererConfig,
                          z_near: float, z_far: float, scale: int = 0,
                          as_z_depth: bool = True,
                          deterministic: bool = False,
                          generator: torch.Generator | None = None,
                          z_samp: torch.Tensor | None = None):
    """Expected depth of the keyframe through the dense self-view query.
    Returns (depth (1, h, w), weights (1, h*w, K), z (h*w, K)).

    deterministic=True (code_mode z): one camera-z ladder at the bin
    midpoints, shared by every ray; the decode tail is the shared_z
    kernel. Otherwise each ray gets stratified jitter from `generator`,
    or the distances `z_samp` (h*w, K) that the caller passes (the tests
    feed both frameworks the same jitter that way)."""
    k = cfg.n_coarse
    dev = grid.f_ks.device
    if deterministic and net.code_mode == "z":
        s = (torch.arange(k, dtype=torch.float32, device=dev) + 0.5) / k
        if cfg.lindisp:
            z_cam = 1.0 / (1.0 / z_near * (1.0 - s) + 1.0 / z_far * s)
        else:
            z_cam = z_near * (1.0 - s) + z_far * s
        sigma = net.query_selfview_density_shared_z(
            grid, z_cam, scale=scale, out_hw=(height, width))   # (1, hw, K)
        k_mat = grid.f_ks[0, 0]
        xs = torch.linspace(-1.0, 1.0, width, device=dev)
        ys = torch.linspace(-1.0, 1.0, height, device=dev)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        dirs = torch.stack([(gx - k_mat[0, 2]) / k_mat[0, 0],
                            (gy - k_mat[1, 2]) / k_mat[1, 1],
                            torch.ones_like(gx)], -1)
        norms = torch.linalg.norm(dirs, dim=-1).reshape(-1)     # (hw,)
        # Per-ray sample DISTANCES scale by the ray norm: |p| = z_cam |d|.
        z_dist = z_cam[None, :] * norms[:, None]                # (hw, K)
        weights, _ = renderer_lib.weights_from_sigma(sigma[0], z_dist, cfg)
        depth = torch.sum(weights * z_cam[None, :], -1) \
            .reshape(1, height, width)
        if not as_z_depth:
            depth = depth * norms.reshape(1, height, width)
        return depth, weights[None], z_dist

    if z_samp is None:
        hw = height * width
        rays_stub = torch.cat([
            torch.zeros((hw, 6), device=dev),
            torch.full((hw, 1), float(z_near), device=dev),
            torch.full((hw, 1), float(z_far), device=dev)], -1)
        z_samp = renderer_lib.sample_coarse(rays_stub, k, cfg.lindisp,
                                            generator)          # (hw, K)
    sigma = net.query_selfview_density(grid, z_samp, scale=scale,
                                       out_hw=(height, width))  # (1, hw, K)
    weights, _ = renderer_lib.weights_from_sigma(sigma[0], z_samp, cfg)
    depth = torch.sum(weights * z_samp, -1).reshape(1, height, width)
    if as_z_depth:
        depth = geometry.distance_to_z(depth[None], grid.f_ks[:, :1])[0]
    return depth, weights[None], z_samp


def render_poses(net: BTSNet, grid: FeatureGrid, poses, projs, height: int,
                 width: int, cfg: renderer_lib.RendererConfig, z_near: float,
                 z_far: float, ray_chunk: int = 16384,
                 generator: torch.Generator | None = None,
                 z_jitter: torch.Tensor | None = None,
                 fine_draws: renderer_lib.FineDraws | None = None) -> dict:
    """Novel views through the general path in chunks of `ray_chunk` rays
    (behindthescenes_tpu/inference.py:82-109; reference
    inference_setup.py:182-198), the coarse jitter and fine draws from
    `generator` unless passed in (z_jitter (1, v*h*w, n_coarse)).

    poses (v, 4, 4) c2w; projs (v, 3, 3). Returns rgb (v, h, w, 3) (the
    render views averaged), depth (v, h, w) and invalid (v, h, w) of the
    coarse pass."""
    sampler = ImageRaySampler(z_near, z_far, height=height, width=width)
    rays, _ = sampler.sample(None, poses[None], projs[None])

    def query_fn(xyz, coarse):
        return net.query(grid, xyz, coarse=coarse)

    out = renderer_lib.render_rays_chunked(
        query_fn, rays, cfg, ray_chunk=ray_chunk, generator=generator,
        z_jitter=z_jitter, fine_draws=fine_draws)
    render_dict = sampler.reconstruct(
        {"coarse": out["coarse"],
         "fine": out.get("fine", dict(out["coarse"]))})
    c = render_dict["coarse"]
    v = poses.shape[0]
    return {"rgb": c["rgb"].reshape(v, height, width, -1, 3).mean(-2),
            "depth": c["depth"].reshape(v, height, width),
            "invalid": c["invalid"].reshape(v, height, width, -1).mean(-1)}


def render_profile(net: BTSNet, grid: FeatureGrid, x_range=(-9.0, 9.0),
                   y_val: float = 0.0, z_range=(21.0, 3.0), ppm: float = 10.0,
                   sigma_cutoff: float = 8.0):
    """Top-down (BEV) density profile (behindthescenes_tpu/inference.py:
    112-141; reference scripts/inference_setup.py:201-229): the field's
    density on an x/z grid at height y_val, accumulated along z from the
    far end, faded out where the accumulation passes the cutoff.
    Returns (profile (zn, xn) in [0, 1], sigma (zn, xn))."""
    x0, x1 = x_range
    z0, z1 = z_range
    xn = int(abs(x1 - x0) * ppm)
    zn = int(abs(z0 - z1) * ppm)
    dev = grid.f_ks.device
    xs = torch.linspace(x0, x1, xn, device=dev)
    zs = torch.linspace(z0, z1, zn, device=dev)
    zz, xx = torch.meshgrid(zs, xs, indexing="ij")
    pts = torch.stack([xx, torch.full_like(xx, y_val), zz], -1)
    _, _, sigma = net.query(grid, pts.reshape(1, -1, 3), only_density=True)
    sigma = sigma.reshape(zn, xn)
    acc = torch.cumsum(sigma.flip(0), 0).flip(0)
    profile = torch.clamp(sigma, 0.0, 1.0) * (acc < sigma_cutoff)
    return profile, sigma
