"""Full-frame self-view depth rendering (counterpart of
behindthescenes_tpu/inference.py:22-79)."""
from __future__ import annotations

import torch

from behindthescenes_tpu_torch import geometry
from behindthescenes_tpu_torch import renderer as renderer_lib
from behindthescenes_tpu_torch.models.bts import BTSNet, FeatureGrid


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
