"""Camera geometry the self-view depth path needs (counterpart of
behindthescenes_tpu/geometry.py:89-141), exact in float32.

Conventions as in the JAX package: 3x3 NDC intrinsics, camera-to-world
4x4 poses, pixel lattice linspace(-1, 1) inclusive.
"""
from __future__ import annotations

import torch


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
