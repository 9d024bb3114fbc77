"""Sweep-mode novel-view frame rendering (counterpart of
behindthescenes_tpu/models/sweep.py).

At serving time every ray of a frame shares one deterministic z-ladder
(the bin midpoints), so for each sample index k the fetch positions
x_src(pixel, k) = project(o + z_k d(pixel)) form a smooth 2-D warp of the
novel view's pixel lattice. Per block of planes the frame

  1. fetches features on a coarse warp lattice (`warp_scale` x the
     feature map's resolution; None fetches every sample exactly);
  2. resamples the warped planes to render resolution with the separable
     align-corners lattice resample (planes folded into channels);
  3. computes projections, invalid masks and the positional code exactly
     per (ray, sample), so only the fetched feature values carry the warp
     approximation (or, with `mlp_at_warp`, decodes at the lattice and
     resamples the density logits);
  4. decodes with the field MLP and composites.

Colours composite in a second pass from the weights, without the (rays,
K, 3) sample colours, in one of four modes: "exact" (every sample),
"topm" (the M highest-weight samples, renormalised), "expected" (one fetch
at the weight-averaged source position) or "none" (depth only).

Scope: one frame (n = 1) from one encoder view and one render view, the
NVS serving workload (every frame rendered from the frame-0 encoding).
Training keeps the general query: stratified jitter breaks the shared
ladder.
"""
from __future__ import annotations

from typing import Optional

import torch

from behindthescenes_tpu_torch import geometry
from behindthescenes_tpu_torch import renderer as renderer_lib
from behindthescenes_tpu_torch.models.bts import EPS, BTSNet, FeatureGrid
from behindthescenes_tpu_torch.ops.grid_sample import (
    grid_sample_2d, grid_sample_2d_packed, grid_sample_2d_xpair,
    resample_uniform_lattice)


def sweep_z_ladder(n_samples: int, z_near, z_far, lindisp: bool,
                   dtype=torch.float32, device=None) -> torch.Tensor:
    """The shared coarse ladder (K,): stratified-bin midpoints, the
    zero-jitter limit of renderer.sample_coarse."""
    s = (torch.arange(n_samples, dtype=dtype, device=device) + 0.5) \
        / n_samples
    if lindisp:
        return 1.0 / (1.0 / z_near * (1.0 - s) + 1.0 / z_far * s)
    return z_near * (1.0 - s) + z_far * s


def _project_single(xyz, pose_w2c, k_mat):
    """project_points for one view: xyz (P, 3) -> xy (P, 2), z (P, 1),
    distance (P, 1), invalid (P, 1)."""
    xy, z, dist, invalid = geometry.project_points(
        xyz[None], pose_w2c[None, None], k_mat[None, None], eps=EPS)
    return xy[0, 0], z[0, 0], dist[0, 0], invalid[0, 0]


def _fetch_features(grid: FeatureGrid, xy, scale: int):
    """Bilinear feature fetch at NDC coords xy (P, 2), with
    BTSNet.sample_features' dtype dispatch."""
    fmap = grid.features[scale][0, 0]
    if fmap.dtype not in (torch.bfloat16, torch.float16):
        return grid_sample_2d(fmap, xy, align_corners=False,
                              padding_mode="border")
    if fmap.shape[-1] > 32:
        return grid_sample_2d_xpair(fmap, xy)
    return grid_sample_2d_packed(fmap, xy)


def _fetch_colors(grid: FeatureGrid, xy):
    """Colours at xy (P, 2): the 4-corner lerp with f32 weights from the
    render view (f16 at bf16, as FeatureGrid holds it)."""
    return grid_sample_2d_packed(grid.color_imgs[0, 0], xy)


def _resample_batched(x, out_hw):
    """Align-corners lattice resample of P planes (P, h, w, C) -> (P, oh,
    ow, C) in one separable resample, the planes folded into channels."""
    p, h, w, c = x.shape
    y = resample_uniform_lattice(x.permute(1, 2, 0, 3).reshape(h, w, p * c),
                                 out_hw, align_corners=True)
    oh, ow = out_hw
    return y.reshape(oh, ow, p, c).permute(2, 0, 1, 3)


def _block_divisor(k: int, p: int) -> int:
    p = max(1, min(p, k))
    while k % p:
        p -= 1
    return p


def _empty_where(net: BTSNet, feats, invalid):
    if not net.learn_empty:
        return feats
    return torch.where(invalid, net.empty_feature.to(feats.dtype), feats)


def _decode(net: BTSNet, mlp, feats, xy, z, dist):
    """The field MLP on [features, code(xy, coord)] of P points -> (P,)
    logits in the MLP's output dtype."""
    coord = net.code_coord(z if net.code_mode == "z" else dist)
    code = net.code_xyz(torch.cat([xy, coord], -1))
    mlp_in = torch.cat([feats, code.to(feats.dtype)], -1)
    p = mlp_in.shape[0]
    return mlp(mlp_in[None], combine_inner_dims=(p,))[0, :, 0]


def sweep_block_density(net: BTSNet, grid: FeatureGrid, origin, dirs_full,
                        z_blk, full_hw, dirs_warp=None, warp_hw=None,
                        mlp_at_warp: bool = False, coarse: bool = True,
                        scale: int = 0):
    """Density logits of a block of P planes z_blk (P,). Returns (logits
    (P, HW), invalid (P, HW) bool)."""
    h, w = full_hw
    hw = h * w
    p = z_blk.shape[0]
    mlp = net._mlp(coarse)
    pose_f = grid.f_poses_w2c[0, 0]
    k_f = grid.f_ks[0, 0]
    c_l = grid.features[scale].shape[-1]

    pts_full = origin + z_blk[:, None, None] * dirs_full[None]  # (P, HW, 3)
    xy_f, z_f, dist_f, inv_f = _project_single(pts_full.reshape(p * hw, 3),
                                               pose_f, k_f)
    if dirs_warp is not None:
        wh, ww = warp_hw
        pts_w = (origin + z_blk[:, None, None] * dirs_warp[None]) \
            .reshape(-1, 3)
        xy_w, z_w, dist_w, inv_w = _project_single(pts_w, pose_f, k_f)
        f_w = _empty_where(net, _fetch_features(grid, xy_w, scale), inv_w)
        if mlp_at_warp:
            # Decoded at the lattice; the logits resampled in f32.
            out = _decode(net, mlp, f_w, xy_w, z_w, dist_w)
            logit = _resample_batched(out.float().reshape(p, wh, ww, 1),
                                      (h, w)).reshape(p, hw)
            return logit, inv_f[:, 0].reshape(p, hw)
        feats = _resample_batched(f_w.reshape(p, wh, ww, c_l),
                                  (h, w)).reshape(p * hw, c_l)
    else:
        feats = _fetch_features(grid, xy_f, scale)             # (P*HW, C)
    feats = _empty_where(net, feats, inv_f)
    # The logits stay in the MLP's output dtype into the density.
    out = _decode(net, mlp, feats, xy_f, z_f, dist_f)
    return out.reshape(p, hw), inv_f[:, 0].reshape(p, hw)


def query_sweep_density(net: BTSNet, grid: FeatureGrid, origin, dirs_full,
                        z_samp, full_hw, dirs_warp=None, warp_hw=None,
                        mlp_at_warp: bool = False, coarse: bool = True,
                        scale: int = 0,
                        planes_per_step: Optional[int] = None):
    """Density over a full frame, the shared ladder z_samp (K,) taken in
    blocks of `planes_per_step` planes (default 16 for the decode at the
    warp lattice, 8 otherwise, lowered to a divisor of K).

    Returns sigma (1, HW, K), invalid (1, HW, K) bool."""
    if grid.features[scale].shape[0] != 1:
        raise ValueError("the sweep path renders one frame (n == 1)")
    if grid.features[scale].shape[1] != 1 or grid.f_combine is not None:
        raise ValueError("the sweep path needs a single encoder view")
    k = z_samp.shape[0]
    if planes_per_step is None:
        planes_per_step = 16 if (mlp_at_warp and dirs_warp is not None) \
            else 8
    p = _block_divisor(k, planes_per_step)
    blocks = [sweep_block_density(
        net, grid, origin, dirs_full, z_blk, full_hw, dirs_warp=dirs_warp,
        warp_hw=warp_hw, mlp_at_warp=mlp_at_warp, coarse=coarse,
        scale=scale) for z_blk in z_samp.reshape(k // p, p)]
    logits = torch.cat([lg for lg, _ in blocks]).transpose(0, 1)[None]
    invalid = torch.cat([inv for _, inv in blocks]).transpose(0, 1)[None]
    sigma = net._density(logits)
    if net.empty_empty:
        sigma = torch.where(invalid, 0.0, sigma)
    return sigma, invalid


def sweep_colors(grid: FeatureGrid, origin, dirs_full, z_samp, weights,
                 color_mode: str = "exact", top_m: int = 8):
    """Colours composited against the weights (1, HW, K) without the (HW,
    K, 3) sample colours. Returns (rgb (1, HW, 3) f32, invalid): per
    sample (1, HW, K) in "exact" mode, as the general path gives it; the
    any-relevant-sample mask (1, HW, 1) in "topm" and "expected"; "none"
    gives zeros and an all-valid mask."""
    hw = dirs_full.shape[0]
    dev = dirs_full.device
    if color_mode == "none":
        return (torch.zeros((1, hw, 3), device=dev),
                torch.zeros((1, hw, 1), dtype=torch.bool, device=dev))
    if grid.color_imgs.shape[1] != 1 or grid.c_combine is not None:
        raise ValueError("the sweep path needs a single render view")
    pose_c = grid.c_poses_w2c[0, 0]
    k_c = grid.c_ks[0, 0]
    w_ = weights[0]                                            # (HW, K)

    if color_mode == "exact":
        k = z_samp.shape[0]
        p = _block_divisor(k, 8)   # each fetch at P*HW rows
        rgb = torch.zeros((hw, 3), device=dev)
        inv_k = []
        for z_blk, wk in zip(z_samp.reshape(k // p, p),
                             w_.transpose(0, 1).reshape(k // p, p, hw)):
            pts = (origin + z_blk[:, None, None] * dirs_full[None]) \
                .reshape(-1, 3)
            xy, _, _, inv = _project_single(pts, pose_c, k_c)
            col = _fetch_colors(grid, xy).float().reshape(p, hw, 3)
            rgb = rgb + torch.sum(wk[..., None] * col, 0)
            inv_k.append(inv[:, 0].reshape(p, hw))
        return rgb[None], torch.cat(inv_k).transpose(0, 1)[None]

    if color_mode == "topm":
        # torch.topk and lax.top_k may order equal weights differently.
        # Only zero weights tie in practice: they add nothing to the
        # colour, and inv_any counts only samples above 1e-4.
        wv, wi = torch.topk(w_, top_m, dim=-1)                 # (HW, M)
        z_sel = z_samp[wi]                                     # (HW, M)
        pts = origin + z_sel[..., None] * dirs_full[:, None]
        xy, _, _, inv = _project_single(pts.reshape(hw * top_m, 3), pose_c,
                                        k_c)
        col = _fetch_colors(grid, xy).float().reshape(hw, top_m, 3)
        inv = inv.reshape(hw, top_m, 1)
        # The kept mass renormalised to the full mass, so the dropped tail
        # does not darken the pixel.
        kept = torch.clamp_min(wv.sum(-1, keepdim=True), 1e-8)
        total = w_.sum(-1, keepdim=True)
        rgb = torch.sum(wv[..., None] * col, 1) * (total / kept)
        inv_any = torch.any(inv & (wv[..., None] > 1e-4), 1)
        return rgb[None], inv_any[None]

    if color_mode == "expected":
        xy_bar = torch.zeros((hw, 2), device=dev)
        inv_any = torch.zeros((hw, 1), dtype=torch.bool, device=dev)
        for z_k, wk in zip(z_samp, w_.transpose(0, 1)):
            xy, _, _, inv = _project_single(origin + z_k * dirs_full, pose_c,
                                            k_c)
            xy_bar = xy_bar + wk[:, None] * xy
            inv_any = inv_any | inv
        wsum = torch.clamp_min(w_.sum(-1, keepdim=True), 1e-8)
        col = _fetch_colors(grid, xy_bar / wsum).float()
        return (col * wsum)[None], inv_any[None]

    raise NotImplementedError(color_mode)


def render_frame_sweep(net: BTSNet, grid: FeatureGrid, pose_c2w, proj, hw,
                       cfg: renderer_lib.RendererConfig,
                       warp_scale: Optional[float] = 0.5,
                       mlp_at_warp: bool = True, color_mode: str = "topm",
                       top_m: int = 8, z_near: Optional[float] = None,
                       z_far: Optional[float] = None,
                       planes_per_step: Optional[int] = None, mesh=None):
    """One full novel-view frame in sweep mode.

    pose_c2w (4, 4) novel camera; proj (3, 3) NDC intrinsics; hw (H, W)
    render resolution. warp_scale: the warp lattice's resolution as a
    multiple of the feature map's (h, w) (None: the exact per-sample
    fetch). z_near / z_far: the ladder's bounds (default: the net's).
    mesh: the JAX package's ray-sharding mesh, not ported (ROADMAP Queue A
    item 5). Returns render_rays' dict {"coarse", "fine"}: rgb (1, HW, 3),
    depth (1, HW), invalid (1, HW, K, 1), weights, alphas, z_samps."""
    if mesh is not None:
        raise NotImplementedError(
            "render_frame_sweep(mesh=...): ray sharding over several cards "
            "is not ported (ROADMAP Queue A item 5)")
    h, w = hw
    zn = net.z_near if z_near is None else z_near
    zf = net.z_far if z_far is None else z_far
    focal = torch.stack([proj[0, 0], proj[1, 1]])
    center = torch.stack([proj[0, 2], proj[1, 2]])
    rays = geometry.gen_rays(pose_c2w[None], w, h, zn, zf, focal=focal,
                             c=center)
    dirs_full = rays[0, ..., 3:6].reshape(h * w, 3)
    origin = pose_c2w[:3, 3]
    z_samp = sweep_z_ladder(cfg.n_coarse, zn, zf, cfg.lindisp,
                            device=dirs_full.device)

    dirs_warp = warp_hw = None
    if warp_scale is not None:
        fh, fw = grid.features[0].shape[2:4]
        warp_hw = (max(2, int(round(fh * warp_scale))),
                   max(2, int(round(fw * warp_scale))))
        rays_w = geometry.gen_rays(pose_c2w[None], warp_hw[1], warp_hw[0],
                                   zn, zf, focal=focal, c=center)
        dirs_warp = rays_w[0, ..., 3:6].reshape(-1, 3)

    sigma, invalid = query_sweep_density(
        net, grid, origin, dirs_full, z_samp, (h, w), dirs_warp=dirs_warp,
        warp_hw=warp_hw, mlp_at_warp=mlp_at_warp,
        planes_per_step=planes_per_step)
    z_b = z_samp.expand(sigma.shape)
    weights, alphas = renderer_lib.weights_from_sigma(sigma, z_b, cfg)
    depth = torch.sum(weights * z_b, -1)
    rgb, inv_c = sweep_colors(grid, origin, dirs_full, z_samp, weights,
                              color_mode=color_mode, top_m=top_m)
    out = {"rgb": rgb, "depth": depth,
           "invalid": (invalid | inv_c)[..., None].to(rgb.dtype),
           "weights": weights, "alphas": alphas, "z_samps": z_b}
    return {"coarse": out, "fine": dict(out)}
