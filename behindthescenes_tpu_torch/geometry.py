"""Camera geometry (counterpart of behindthescenes_tpu/geometry.py),
exact in float32.

Conventions as in the JAX package: 3x3 NDC intrinsics, camera-to-world
4x4 poses, pixel lattice linspace(-1, 1) inclusive, a ray is the 8-vector
[origin(3), direction(3), near, far].
"""
from __future__ import annotations

import numpy as np
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


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternions (w, x, y, z) (..., 4) -> rotation matrices (..., 3,
    3) (behindthescenes_tpu/geometry.py:143-154; reference
    util.py:481-510)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rot = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1)
    return rot.reshape(q.shape[:-1] + (3, 3))


def rot_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> unit quaternions (w, x, y, z) (...,
    4), branch-free (behindthescenes_tpu/geometry.py:157-173)."""
    m00, m01, m02 = rot[..., 0, 0], rot[..., 0, 1], rot[..., 0, 2]
    m10, m11, m12 = rot[..., 1, 0], rot[..., 1, 1], rot[..., 1, 2]
    m20, m21, m22 = rot[..., 2, 0], rot[..., 2, 1], rot[..., 2, 2]
    tr = m00 + m11 + m22

    def half_sqrt(v):
        return torch.sqrt(torch.clamp_min(v, 0.0)) / 2

    def sign(d):
        return torch.sign(torch.where(d == 0, torch.ones_like(d), d))
    w = half_sqrt(1 + tr)
    x = half_sqrt(1 + m00 - m11 - m22) * sign(m21 - m12)
    y = half_sqrt(1 - m00 + m11 - m22) * sign(m02 - m20)
    z = half_sqrt(1 - m00 - m11 + m22) * sign(m10 - m01)
    return torch.stack([w, x, y, z], -1)


def look_at(origin, target, world_up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Camera-to-world (4, 4) float32 numpy matrix looking from origin at
    target (behindthescenes_tpu/geometry.py:176-193; reference
    util.py:180-196)."""
    origin = np.asarray(origin, dtype=np.float32)
    target = np.asarray(target, dtype=np.float32)
    world_up = np.asarray(world_up, dtype=np.float32)
    back = origin - target
    back = back / np.linalg.norm(back)
    right = np.cross(world_up, back)
    right = right / np.linalg.norm(right)
    up = np.cross(back, right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = right, up, back
    c2w[:3, 3] = origin
    return c2w


def _matrix_to_quat(rot: np.ndarray) -> np.ndarray:
    """Rotation matrices (..., 3, 3) -> unit quaternions (x, y, z, w) in
    float64 by the larger of the trace and the diagonal (Markley's method,
    as scipy's Rotation.from_matrix)."""
    rot = np.asarray(rot, np.float64)
    m = rot.reshape(-1, 3, 3)
    diag = np.stack([m[:, 0, 0], m[:, 1, 1], m[:, 2, 2]], -1)
    pick = np.argmax(np.concatenate([diag, diag.sum(-1, keepdims=True)],
                                    -1), -1)
    q = np.empty((len(m), 4))
    for n, k in enumerate(pick):
        r = m[n]
        if k == 3:
            q[n] = [r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1],
                    1 + r[0, 0] + r[1, 1] + r[2, 2]]
        else:
            i, j, l = k, (k + 1) % 3, (k + 2) % 3
            q[n, i] = 1 - r[0, 0] - r[1, 1] - r[2, 2] + 2 * r[i, i]
            q[n, j] = r[j, i] + r[i, j]
            q[n, l] = r[l, i] + r[i, l]
            q[n, 3] = r[l, j] - r[j, l]
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return q.reshape(rot.shape[:-2] + (4,))


def _quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamilton products of (x, y, z, w) quaternions."""
    av, aw = a[..., :3], a[..., 3:]
    bv, bw = b[..., :3], b[..., 3:]
    return np.concatenate([aw * bv + bw * av + np.cross(av, bv),
                           aw * bw - np.sum(av * bv, -1, keepdims=True)], -1)


def _quat_to_matrix(q: np.ndarray) -> np.ndarray:
    x, y, z, w = np.moveaxis(q, -1, 0)
    rot = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1)
    return rot.reshape(q.shape[:-1] + (3, 3))


def slerp_rotations(rot_a, rot_b, ts) -> np.ndarray:
    """Rotation matrices (len(ts), 3, 3) in float64 on the shortest arc
    from rot_a (t = 0) to rot_b (t = 1), as scipy's
    `Slerp([0, 1], Rotation.from_matrix([rot_a, rot_b]))(ts).as_matrix()`
    computes them (the relative rotation's rotation vector scaled by t),
    in numpy: the port runs without scipy."""
    qa, qb = _matrix_to_quat(np.stack([rot_a, rot_b]))
    rel = _quat_mul(qa * [-1, -1, -1, 1], qb)
    if rel[3] < 0:
        rel = -rel
    norm = np.linalg.norm(rel[:3])
    angle = 2 * np.arctan2(norm, rel[3])
    axis = rel[:3] / norm if norm > 0 else np.zeros(3)
    half = np.asarray(ts, np.float64)[:, None] * angle / 2
    step = np.concatenate([np.sin(half) * axis, np.cos(half)], -1)
    return _quat_to_matrix(_quat_mul(qa[None], step))


def coord_from_blender() -> np.ndarray:
    """Blender -> standard coordinates (reference util.py:152-163)."""
    return np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, -1, 0, 0],
                     [0, 0, 0, 1]], dtype=np.float32)


def coord_to_blender() -> np.ndarray:
    """Standard -> Blender coordinates (reference util.py:166-177)."""
    return np.array([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0],
                     [0, 0, 0, 1]], dtype=np.float32)


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
