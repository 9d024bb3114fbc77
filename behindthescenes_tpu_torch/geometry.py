"""Camera geometry (counterpart of behindthescenes_tpu/geometry.py:19-141,
208-251), exact in float32.

Conventions as in the JAX package: 3x3 NDC intrinsics, camera-to-world
4x4 poses, pixel lattice linspace(-1, 1) inclusive, a ray is the 8-vector
[origin(3), direction(3), near, far].
"""
from __future__ import annotations

import torch


def unproj_map(width: int, height: int, focal, c=None, norm_dir: bool = True,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Camera-frame ray directions (B, H, W, 3) of NDC pinhole cameras;
    focal and c are scalars, (2,) or (B, 2) (c None means 0)."""
    def as_b2(v):
        v = torch.as_tensor(v, dtype=dtype, device=device)
        if v.ndim == 0:
            return v.reshape(1, 1).repeat(1, 2)
        return v[None] if v.ndim == 1 else v
    focal = as_b2(focal)
    c = torch.zeros((1, 2), dtype=dtype, device=focal.device) if c is None \
        else as_b2(c).to(focal.device)
    x = torch.linspace(-1.0, 1.0, width, dtype=dtype, device=focal.device)
    y = torch.linspace(-1.0, 1.0, height, dtype=dtype, device=focal.device)
    gy, gx = torch.meshgrid(y, x, indexing="ij")
    xy = torch.stack([gx, gy], -1)                            # (H, W, 2)
    xy = (xy[None] - c[:, None, None, :]) / focal[:, None, None, :]
    unproj = torch.cat([xy, torch.ones_like(xy[..., :1])], -1)
    if norm_dir:
        unproj = unproj / torch.linalg.norm(unproj, dim=-1, keepdim=True)
    n = focal.shape[0]
    if unproj.shape[0] != n:
        unproj = unproj.expand((n,) + unproj.shape[1:])
    return unproj


def gen_rays(poses: torch.Tensor, width: int, height: int, z_near, z_far,
             focal=None, c=None, norm_dir: bool = True) -> torch.Tensor:
    """World-space rays (V, H, W, 8) of cameras poses (V, 4, 4) c2w with
    focal (V, 2) and principal point c (V, 2), NDC units."""
    v = poses.shape[0]
    dirs_cam = unproj_map(width, height, focal, c=c, norm_dir=norm_dir,
                          dtype=poses.dtype, device=poses.device)
    dirs_cam = dirs_cam.expand(v, height, width, 3)
    origins = poses[:, None, None, :3, 3].expand(v, height, width, 3)
    dirs_world = torch.einsum("vij,vhwj->vhwi", poses[:, :3, :3], dirs_cam)
    nears = torch.full((v, height, width, 1), float(z_near),
                       dtype=poses.dtype, device=poses.device)
    fars = torch.full((v, height, width, 1), float(z_far),
                      dtype=poses.dtype, device=poses.device)
    return torch.cat([origins, dirs_world, nears, fars], -1)


def distance_to_z(depths: torch.Tensor, projs: torch.Tensor) -> torch.Tensor:
    """Ray-distance depth maps (n, nv, h, w) -> planar z-depth, given NDC
    intrinsics (n, nv, 3, 3)."""
    n, nv, h, w = depths.shape
    inv_k = torch.linalg.inv(projs)
    gx = torch.linspace(-1.0, 1.0, w, dtype=depths.dtype,
                        device=depths.device)
    gy = torch.linspace(-1.0, 1.0, h, dtype=depths.dtype,
                        device=depths.device)
    gyy, gxx = torch.meshgrid(gy, gx, indexing="ij")
    pts = torch.stack([gxx, gyy, torch.ones_like(gxx)], 0).reshape(3, -1)
    cam_pts = torch.einsum("nvij,jp->nvip", inv_k, pts)      # (n, nv, 3, hw)
    factors = cam_pts[:, :, 2, :] / torch.linalg.norm(cam_pts, dim=2)
    return depths * factors.reshape(n, nv, h, w)


def invert_pose(poses: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of rigid 4x4 poses (..., 4, 4)."""
    rot_t = poses[..., :3, :3].transpose(-1, -2)
    t_new = -(rot_t @ poses[..., :3, 3:])
    top = torch.cat([rot_t, t_new], dim=-1)
    bottom = torch.zeros_like(poses[..., 3:, :])
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def rebase_poses_to_keyframe(poses: torch.Tensor) -> torch.Tensor:
    """(n, v, 4, 4) camera-to-world -> relative to view 0 (identity)."""
    return invert_pose(poses[:, :1]) @ poses


def project_points(xyz: torch.Tensor, poses_w2c: torch.Tensor,
                   ks: torch.Tensor, eps: float = 1e-3):
    """World points xyz (n, p, 3) into the NDC images of cameras poses_w2c
    (n, v, 4, 4) with intrinsics ks (n, v, 3, 3). Returns xy (n, v, p, 2),
    camera z (n, v, p, 1), camera distance (n, v, p, 1) and invalid (n, v,
    p, 1) bool, with the JAX package's unrolled 3x3 products."""
    rot = poses_w2c[:, :, :3, :3]
    trans = poses_w2c[:, :, :3, 3]
    px, py, pz = (xyz[:, None, :, 0], xyz[:, None, :, 1], xyz[:, None, :, 2])

    def matvec3(m, x, y, z, t=None):
        out = []
        for i in range(3):
            o = (m[:, :, i, 0, None] * x + m[:, :, i, 1, None] * y
                 + m[:, :, i, 2, None] * z)
            if t is not None:
                o = o + t[:, :, i, None]
            out.append(o)
        return out

    cx, cy, cz = matvec3(rot, px, py, pz, trans)
    distance = torch.sqrt(cx * cx + cy * cy + cz * cz)[..., None]
    ux, uy, uz = matvec3(ks, cx, cy, cz)
    z = uz[..., None]
    xy = torch.stack([ux, uy], -1) / torch.clamp_min(z, eps)
    invalid = ((z <= eps) | (xy[..., :1] < -1) | (xy[..., :1] > 1)
               | (xy[..., 1:2] < -1) | (xy[..., 1:2] > 1))
    return xy, z, distance, invalid
