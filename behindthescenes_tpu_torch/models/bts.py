"""BTSNet: the pixel-aligned density field (counterpart of
behindthescenes_tpu/models/bts.py:38-626).

- `encode`: the CNN over the encoder views, with flip augmentation,
  substitute color images, combine groups and BatchNorm in train mode.
- `query`: the general cross-view field query at world points
  (`sample_features`, `sample_colors`), which training and the general
  depth path run.
- `query_selfview_density*`: the dense self-view density queries of
  single-image depth, deterministic (one camera-z ladder shared by every
  ray) and jittered (per-ray samples).

Feature maps keep the JAX layout (n, nv, h, w, c).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from behindthescenes_tpu_torch import geometry
from behindthescenes_tpu_torch.models.encoder import make_backbone
from behindthescenes_tpu_torch.models.mlp import ResnetFC, make_mlp
from behindthescenes_tpu_torch.ops.grid_sample import (
    grid_sample_2d, grid_sample_2d_packed, grid_sample_2d_xpair,
    resample_uniform_lattice)
from behindthescenes_tpu_torch.ops.kernels import selfview
from behindthescenes_tpu_torch.ops.kernels.selfview import softplus
from behindthescenes_tpu_torch.ops.posenc import PositionalEncoding

EPS = 1e-3


@dataclasses.dataclass
class FeatureGrid:
    """What the queries need about the encoded views. Features are in the
    compute dtype; colors in f16 when it is bf16 (the JAX package samples
    colors from f16 corner-packed maps then), else in f32."""
    features: Tuple[torch.Tensor, ...]     # per scale: (n, nv_e, h, w, c)
    f_ks: torch.Tensor                     # (n, nv_e, 3, 3)
    f_poses_w2c: torch.Tensor              # (n, nv_e, 4, 4)
    color_imgs: torch.Tensor               # (n, nv_r, h, w, 3) in [0, 1]
    c_ks: torch.Tensor                     # (n, nv_r, 3, 3)
    c_poses_w2c: torch.Tensor              # (n, nv_r, 4, 4)
    f_combine: Optional[Tuple[Tuple[int, ...], ...]] = None
    c_combine: Optional[Tuple[Tuple[int, ...], ...]] = None

    @property
    def n_render_groups(self) -> int:
        if self.c_combine is not None:
            return len(self.c_combine)
        return self.color_imgs.shape[1]


def _resolve_combine(combine_ids, n_views, ids_encoder, ids_render):
    """Per-grid combine groups: positions within the encoder and the render
    views (behindthescenes_tpu/models/bts.py:66-87)."""
    if combine_ids is None:
        return None, None
    ids_encoder = [int(i) for i in ids_encoder]
    ids_render = [int(i) for i in ids_render]
    combine_ids = [list(map(int, g)) for g in combine_ids]
    covered = set(sum(combine_ids, []))
    combine_ids += [[i] for i in range(n_views) if i not in covered]
    remap_e = {v: i for i, v in enumerate(ids_encoder)}
    remap_r = {v: i for i, v in enumerate(ids_render)}
    comb_e = tuple(tuple(remap_e[i] for i in g if i in remap_e)
                   for g in combine_ids)
    comb_r = tuple(tuple(remap_r[i] for i in g if i in remap_r)
                   for g in combine_ids)
    return tuple(g for g in comb_e if g), tuple(g for g in comb_r if g)


def _combine_first_valid(values, invalid, groups):
    """For each group of views, the first valid view's value (its first
    view where none is valid). values (n, nv, p, d), invalid (n, nv, p, 1)
    bool -> (n, n_groups, p, d), (n, n_groups, p, 1)."""
    out_v, out_i = [], []
    for group in groups:
        g = list(group)
        inv_g, val_g = invalid[:, g], values[:, g]
        idx = torch.argmin(inv_g.to(torch.int32), dim=1, keepdim=True)
        out_i.append(torch.gather(inv_g, 1, idx))
        out_v.append(torch.gather(
            val_g, 1, idx.expand(idx.shape[:-1] + (val_g.shape[-1],))))
    return torch.cat(out_v, 1), torch.cat(out_i, 1)


def _index(ids, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ids, dtype=np.int64), device=device)


def _nearest_resize(x, h, w):
    """Nearest-neighbor resize of an NHWC batch (F.interpolate
    mode='nearest': index = floor(i * scale))."""
    n, h0, w0, c = x.shape
    if (h0, w0) == (h, w):
        return x
    ys = (torch.arange(h, device=x.device) * (h0 / h)).long()
    xs = (torch.arange(w, device=x.device) * (w0 / w)).long()
    return x[:, ys][:, :, xs]


@contextlib.contextmanager
def _bn_mode(module: nn.Module, train: bool):
    """`module` in train mode (BatchNorm with batch statistics) or eval
    mode for the block, and back to its mode before."""
    before = module.training
    module.train(train)
    try:
        yield
    finally:
        module.train(before)


def _linspace(n: int, dtype, device) -> torch.Tensor:
    """linspace(-1, 1, n) rounded in `dtype` as jnp.linspace rounds it
    (each operation in `dtype`). In bf16 torch.linspace differs from it
    by up to 1.2e-2 at n = 640, which the x/y code's top octave (48 rad
    per unit) turns into a different static input."""
    div = torch.tensor(n - 1, dtype=dtype, device=device)
    step = torch.arange(n - 1, dtype=dtype, device=device) / div
    return torch.cat([-(1 - step) + step,
                      torch.ones(1, dtype=dtype, device=device)])


def pixel_lattice(h: int, w: int, dtype, device) -> torch.Tensor:
    """(h*w, 2) NDC pixel coordinates, x fastest: the projection of every
    sample on a ray cast from the encoder camera."""
    xs = _linspace(w, dtype, device)
    ys = _linspace(h, dtype, device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)


def selfview_decode_route(resnet: bool, fusable: bool, include_input: bool,
                          bf16: bool, sample_color: bool, k: int, h: int,
                          n_freqs: int) -> str:
    """How `BTSNet.query_selfview_density` decodes, chosen from the model
    and the shapes before any call, as the JAX package chooses
    (behindthescenes_tpu/models/bts.py:574-591):
    - "generic": an MLP other than ResnetFC, on the full input;
    - "jitter": a no-block ResnetFC at bf16 with the input in its code,
      through the jitter_density kernels (any H: the wrapper picks the
      tensor-core or the runtime-shape kernel), as JAX sends it to its
      jitter_density kernel;
    - "selfview": the same at f32 with a softplus density, at the shapes
      the selfview kernel takes;
    - "call_split": every other ResnetFC, JAX's jnp route for it (JAX
      decodes every f32 model so)."""
    if not resnet:
        return "generic"
    if fusable and include_input:
        if bf16:
            return "jitter"
        if sample_color and selfview.kernel_takes(k, h, n_freqs):
            return "selfview"
    return "call_split"


class BTSNet(nn.Module):
    """Density-field model (reference models_bts.py:17-338); the config
    mirrors the reference's `model_conf` block."""

    def __init__(self, z_near: float, z_far: float, encoder_conf: dict,
                 code_conf: dict, mlp_coarse_conf: dict,
                 mlp_fine_conf: Optional[dict] = None,
                 learn_empty: bool = True, inv_z: bool = True,
                 code_mode: str = "z", sample_color: bool = True,
                 compute_dtype=torch.float32):
        super().__init__()
        if code_mode not in ("z", "distance"):
            raise NotImplementedError(code_mode)
        self.z_near, self.z_far = z_near, z_far
        self.inv_z = inv_z
        self.code_mode = code_mode
        self.sample_color = sample_color
        self.compute_dtype = compute_dtype
        self.learn_empty = learn_empty
        self.encoder = make_backbone(dict(encoder_conf), compute_dtype)
        self.code_xyz = PositionalEncoding.from_conf(dict(code_conf), d_in=3)
        d_in = self.encoder.latent_size + self.code_xyz.d_out
        d_out = 1 if sample_color else 4
        mlp_dtype = None if compute_dtype == torch.float32 else compute_dtype
        self.mlp_coarse = make_mlp(dict(mlp_coarse_conf), d_in, d_out,
                                   dtype=mlp_dtype)
        self.mlp_fine = make_mlp(dict(mlp_fine_conf or {"type": "empty"}),
                                 d_in, d_out, allow_empty=True,
                                 dtype=mlp_dtype)
        if learn_empty:
            self.empty_feature = nn.Parameter(
                torch.randn(self.encoder.latent_size))
        # BatchNorm reads its running statistics, as the JAX encode does by
        # default (train=False); `encode(train=True)` switches it to batch
        # statistics for the one call.
        self.eval()

    @classmethod
    def from_conf(cls, conf: dict, compute_dtype=torch.float32) -> "BTSNet":
        if conf.get("tile_fetch_region"):
            raise NotImplementedError(
                "tile_fetch_region (the tile fetch) is not ported: ROADMAP "
                "Queue A item 10")
        unported = {k: v for k, v in (("empty_empty", False),
                                      ("color_interpolation", "bilinear"),
                                      ("return_sample_depth", False))
                    if conf.get(k, v) != v}
        if unported:
            raise NotImplementedError(
                f"model keys {sorted(unported)} are not ported (no shipped "
                "config sets them): ROADMAP Queue A item 3")
        return cls(z_near=conf["z_near"], z_far=conf["z_far"],
                   encoder_conf=dict(conf["encoder"]),
                   code_conf=dict(conf.get("code", {})),
                   mlp_coarse_conf=dict(conf["mlp_coarse"]),
                   mlp_fine_conf=dict(conf.get("mlp_fine",
                                               {"type": "empty"})),
                   learn_empty=conf.get("learn_empty", True),
                   inv_z=conf.get("inv_z", True),
                   code_mode=conf.get("code_mode", "z"),
                   sample_color=conf.get("sample_color", True),
                   compute_dtype=compute_dtype)

    # ------------------------------------------------------------ encode
    def encode(self, images, ks, poses_c2w, ids_encoder=None,
               ids_render=None, images_alt=None, combine_ids=None,
               do_flip: bool = False, train: bool = False,
               combine_encoder=None, combine_render=None) -> FeatureGrid:
        """Run the CNN over the encoder views and build the feature grid
        (behindthescenes_tpu/models/bts.py:183-272).

        images (n, v, h, w, 3) in [-1, 1]; ks (n, v, 3, 3) NDC intrinsics;
        poses_c2w (n, v, 4, 4). ids_encoder / ids_render: view indices
        (lists or integer arrays; None means all). images_alt: color
        images in [0, 1] to sample instead of the input's. combine_ids:
        groups of view ids to combine; combine_encoder / combine_render:
        groups already resolved to positions within the encoder and the
        render views. do_flip: flip the encoder's input and its latents
        horizontally. train: BatchNorm normalises with
        batch statistics and moves its running statistics, as Flax's
        encode with train=True and mutable batch_stats."""
        n, v, h, w, _ = images.shape
        dev = images.device
        poses_w2c = geometry.invert_pose(poses_c2w)
        ids_encoder = list(range(v)) if ids_encoder is None else ids_encoder
        ids_render = list(range(v)) if ids_render is None else ids_render
        if combine_encoder is not None or combine_render is not None:
            comb_e, comb_r = combine_encoder, combine_render
        else:
            comb_e, comb_r = _resolve_combine(combine_ids, v, ids_encoder,
                                              ids_render)
        ie, ir = _index(ids_encoder, dev), _index(ids_render, dev)
        nv = ie.shape[0]
        imgs = images[:, ie].reshape(n * nv, h, w, 3)
        if do_flip:
            imgs = imgs.flip(2)
        with _bn_mode(self.encoder, train):
            latents = self.encoder(imgs.permute(0, 3, 1, 2))    # NCHW
        if do_flip:
            latents = [lat.flip(3) for lat in latents]
        h0, w0 = latents[0].shape[2:]
        c = self.encoder.latent_size
        feats = tuple(
            _nearest_resize(lat.permute(0, 2, 3, 1), h0, w0)
            .reshape(n, nv, h0, w0, c).to(self.compute_dtype)
            for lat in latents)
        colors = images_alt if images_alt is not None \
            else images * 0.5 + 0.5
        colors = colors[:, ir]
        if self.compute_dtype == torch.bfloat16:
            colors = colors.to(torch.float16)
        return FeatureGrid(
            features=feats, f_ks=ks[:, ie], f_poses_w2c=poses_w2c[:, ie],
            color_imgs=colors, c_ks=ks[:, ir], c_poses_w2c=poses_w2c[:, ir],
            f_combine=comb_e, c_combine=comb_r)

    # ----------------------------------------------------------- queries
    def _mlp(self, coarse: bool):
        return self.mlp_coarse if (coarse or self.mlp_fine is None) \
            else self.mlp_fine

    def sample_features(self, grid: FeatureGrid, xyz, scale: int = 0,
                        use_single_featuremap: bool = True):
        """Pixel-aligned features and positional code of world points xyz
        (n, p, 3) (behindthescenes_tpu/models/bts.py:275-358). Sampling
        follows the JAX package's dtype: f32 maps bilinearly in f32; bf16
        maps with C > 32 through the x-pair lerp in bf16, narrower ones
        through the 4-corner lerp with f32 weights. Returns (features (n,
        [nv,] p, c + d_code), invalid (n, [nv,] p, 1) bool)."""
        feature_map = grid.features[scale]
        c = feature_map.shape[-1]
        xy, z, distance, invalid = geometry.project_points(
            xyz, grid.f_poses_w2c, grid.f_ks, eps=EPS)
        coord = self.code_coord(z if self.code_mode == "z" else distance)
        xyz_code = self.code_xyz(torch.cat([xy, coord], -1))
        if feature_map.dtype not in (torch.bfloat16, torch.float16):
            sampled = grid_sample_2d(feature_map, xy, align_corners=False,
                                     padding_mode="border")
        elif c > 32:
            sampled = grid_sample_2d_xpair(feature_map, xy)
        else:
            sampled = grid_sample_2d_packed(feature_map, xy)
        if self.learn_empty:
            sampled = torch.where(invalid,
                                  self.empty_feature.to(sampled.dtype),
                                  sampled)
        sampled = torch.cat([sampled, xyz_code.to(sampled.dtype)], -1)
        if grid.f_combine is not None:
            sampled, invalid = _combine_first_valid(sampled, invalid,
                                                    grid.f_combine)
        if use_single_featuremap:
            sampled = sampled.mean(1)
            invalid = invalid.any(1)
        return sampled, invalid

    def sample_colors(self, grid: FeatureGrid, xyz):
        """Colors of world points xyz (n, p, 3) in the render views
        (behindthescenes_tpu/models/bts.py:360-386): bilinear, border
        padding, the lerp weights in f32 (or wider). Returns (colors (n,
        nv, p, 3), invalid (n, nv, p, 1) bool)."""
        xy, _, _, invalid = geometry.project_points(
            xyz, grid.c_poses_w2c, grid.c_ks, eps=EPS)
        colors = grid_sample_2d_packed(grid.color_imgs, xy)
        if grid.c_combine is not None:
            colors, invalid = _combine_first_valid(colors, invalid,
                                                   grid.c_combine)
        return colors, invalid

    def query(self, grid: FeatureGrid, xyz, coarse: bool = True,
              only_density: bool = False, scale: int = 0):
        """The field at world points xyz (n, p, 3)
        (behindthescenes_tpu/models/bts.py:388-441). Returns rgb (n, p,
        nv*3), invalid (n, p, nv) float and sigma (n, p, 1)."""
        n, n_pts, _ = xyz.shape
        feats, invalid_features = self.sample_features(
            grid, xyz, scale=scale, use_single_featuremap=not only_density)
        if only_density and feats.ndim == 4:
            if feats.shape[1] != 1:
                raise ValueError("only_density requires a single encoder "
                                 "view or group")
            feats, invalid_features = feats[:, 0], invalid_features[:, 0]
        mlp_output = self._mlp(coarse)(feats, combine_inner_dims=(n_pts,))
        sigma = self._density(mlp_output[..., :1])
        if only_density:
            nv = grid.n_render_groups
            rgb = torch.zeros((n, n_pts, nv * 3), dtype=sigma.dtype,
                              device=sigma.device)
            return rgb, invalid_features.to(sigma.dtype), sigma
        if self.sample_color:
            rgb, invalid_colors = self.sample_colors(grid, xyz)
        else:
            rgb = torch.sigmoid(mlp_output[..., 1:4])[:, None]
            invalid_colors = invalid_features[:, None]
        nv, cc = rgb.shape[1], rgb.shape[-1]
        rgb = rgb.transpose(1, 2).reshape(n, n_pts, nv * cc)
        invalid_colors = invalid_colors.transpose(1, 2).reshape(n, n_pts, nv)
        invalid = invalid_colors | invalid_features
        return rgb, invalid.to(rgb.dtype), sigma

    def code_coord(self, coord):
        """Depth (z or distance) -> the normalized code input in [-1, 1]."""
        if self.inv_z:
            coord = ((1.0 / torch.clamp_min(coord, EPS) - 1.0 / self.z_far)
                     / (1.0 / self.z_near - 1.0 / self.z_far))
        else:
            coord = (coord - self.z_near) / (self.z_far - self.z_near)
        return 2.0 * coord - 1.0

    def _density(self, out):
        return softplus(out) if self.sample_color else torch.relu(out)

    def selfview_static(self, grid: FeatureGrid, scale: int = 0,
                        out_hw=None):
        """Per-ray static inputs of the self-view decode: the lattice xy
        (hw, 2), the MLP's static input [features, xy code] (hw, c + cxy)
        and the lin_in rows of the static and the z-code inputs."""
        feature_map = grid.features[scale]
        n, nv, fh, fw, c = feature_map.shape
        if n != 1:
            raise ValueError("the self-view path is per-image (n == 1)")
        h, w = out_hw if out_hw is not None else (fh, fw)
        xy = pixel_lattice(h, w, feature_map.dtype, feature_map.device)
        # One bilinear resample per frame onto the render lattice.
        feats = resample_uniform_lattice(feature_map[0, 0], (h, w)) \
            .reshape(h * w, c)
        pe = self.code_xyz
        x_static = torch.cat([feats, pe.subset((0, 1))(xy)], dim=-1)
        rows_static = list(range(c)) + [c + r for r in pe.subset_rows((0, 1))]
        rows_dyn = [c + r for r in pe.subset_rows((2,))]
        return xy, x_static, rows_static, rows_dyn

    def query_selfview_density_shared_z(self, grid: FeatureGrid, z_cam,
                                        coarse: bool = True, scale: int = 0,
                                        out_hw=None):
        """Deterministic self-view density: one camera-z ladder z_cam (K,)
        shared by every ray, so the z-code half of lin_in is a (K, H)
        table and the decode tail is the shared_z kernel.
        Returns sigma (1, hw, K)."""
        if self.code_mode != "z":
            raise ValueError("the shared-z path needs code_mode == 'z'")
        mlp = self._mlp(coarse)
        if not isinstance(mlp, ResnetFC):
            raise TypeError("the shared-z path needs a ResnetFC")
        _, x_static, rows_static, rows_dyn = self.selfview_static(
            grid, scale, out_hw)
        code_z = self.code_xyz.subset((2,))(self.code_coord(z_cam)[:, None])
        out = mlp.call_split_shared(x_static, code_z, rows_static, rows_dyn)
        return self._density(out[..., 0])[None]

    def selfview_coord(self, grid: FeatureGrid, xy, z_samp):
        """Per-sample code input (hw, K) of rays through the lattice xy
        with distances z_samp (hw, K) along the unit ray."""
        k_mat = grid.f_ks[0, 0]
        xy = xy.to(k_mat.dtype)     # the lattice may be bf16; rays are f32
        dirs = torch.stack([(xy[:, 0] - k_mat[0, 2]) / k_mat[0, 0],
                            (xy[:, 1] - k_mat[1, 2]) / k_mat[1, 1],
                            torch.ones_like(xy[:, 0])], -1)
        if self.code_mode == "z":
            # Camera z of a sample: the unit ray's z component is 1/|dir|.
            coord = z_samp * (1.0 / torch.linalg.norm(dirs, dim=-1))[:, None]
        else:
            coord = z_samp
        return self.code_coord(coord)

    def query_selfview_density(self, grid: FeatureGrid, z_samp,
                               coarse: bool = True, scale: int = 0,
                               out_hw=None):
        """Density along rays cast FROM the encoder camera, each sampled at
        its own distances z_samp (hw, K): every sample projects back to its
        own pixel, so only the z code varies along a ray.

        The route is `selfview_decode_route`'s. Returns sigma (1, hw, K)."""
        xy, x_static, rows_static, rows_dyn = self.selfview_static(
            grid, scale, out_hw)
        coord = self.selfview_coord(grid, xy, z_samp)
        hw, k = z_samp.shape
        mlp = self._mlp(coarse)
        pe = self.code_xyz
        resnet = isinstance(mlp, ResnetFC)
        route = selfview_decode_route(
            resnet, resnet and mlp.fusable(), pe.include_input,
            resnet and (mlp.dtype or x_static.dtype) == torch.bfloat16,
            self.sample_color, k, mlp.lin_in.out_features if resnet else 0,
            pe.num_freqs)
        kw = dict(n_freqs=pe.num_freqs, freq_factor=pe.freq_factor)
        if route == "jitter":
            out = mlp.call_split_jitter(x_static, coord, rows_static,
                                        rows_dyn, **kw)
            return self._density(out)[None]
        if route == "selfview":
            return mlp.call_split_selfview(x_static, coord, rows_static,
                                           rows_dyn, **kw)[None]
        if route == "call_split":
            code_z = pe.subset((2,))(coord[..., None])         # (hw, K, 13)
            out = mlp.call_split(x_static, code_z, rows_static, rows_dyn)
            return self._density(out[..., 0])[None]
        c = grid.features[scale].shape[-1]
        xyz = torch.cat([xy[:, None, :].expand(hw, k, 2).to(coord.dtype),
                         coord[..., None]], dim=-1)
        mlp_in = torch.cat([x_static[:, None, :c].expand(hw, k, c)
                            .to(coord.dtype), self.code_xyz(xyz)], dim=-1)
        out = mlp(mlp_in.reshape(1, hw * k, -1), combine_inner_dims=(hw * k,))
        return self._density(out[..., 0].reshape(1, hw, k))
