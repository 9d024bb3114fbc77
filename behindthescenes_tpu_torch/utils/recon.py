"""Mesh extraction from the density field (counterpart of
behindthescenes_tpu/utils/recon.py; reference
models/common/util/recon.py:12-50, which used PyMCubes).

Marching tetrahedra in numpy, the JAX package's own copy line for line
(bit-equal): each grid cube splits into 6 tetrahedra sharing its main
diagonal; each tetrahedron gives 0-2 triangles by its 4-bit
inside/outside pattern; duplicate vertices are welded on a 1e-6 lattice.
`density_volume` queries a BTSNet's density on a dense grid in chunks on
the net's device; `extract_mesh_from_density` meshes that volume.
"""
from __future__ import annotations

import numpy as np
import torch

# Cube corner offsets (z-minor order).
_CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], dtype=np.int64)

# 6 tetrahedra per cube sharing the main diagonal 0-6.
_TETS = np.array([
    [0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
    [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]], dtype=np.int64)

# For each of the 16 sign patterns: up to 2 triangles, each triangle as
# 3 edges, each edge as a pair of local tet vertex ids. -1 padded.
_TET_EDGES = np.array([
    [0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64)

# Triangulation table: index = bitmask of "inside" verts (bit i = vert i).
_TET_TRIS = {
    0b0001: [[0, 1, 2]],
    0b0010: [[0, 4, 3]],
    0b0100: [[1, 3, 5]],
    0b1000: [[2, 5, 4]],
    0b0011: [[1, 2, 4], [1, 4, 3]],
    0b0101: [[0, 3, 5], [0, 5, 2]],
    0b1001: [[0, 1, 5], [0, 5, 4]],
    0b0110: [[0, 4, 5], [0, 5, 1]],
    0b1010: [[0, 2, 5], [0, 5, 3]],
    0b1100: [[1, 3, 4], [1, 4, 2]],
    0b0111: [[2, 4, 5]],
    0b1011: [[1, 5, 3]],
    0b1101: [[0, 3, 4]],
    0b1110: [[0, 2, 1]],
}


def marching_tetrahedra(volume: np.ndarray, threshold: float = 0.5,
                        spacing=(1.0, 1.0, 1.0), origin=(0.0, 0.0, 0.0)):
    """Extract an isosurface mesh from a scalar volume.

    Args:
      volume: (nx, ny, nz) scalar field; surface at volume == threshold.
    Returns:
      verts (m, 3) float32 world coords, faces (k, 3) int32.
    """
    nx, ny, nz = volume.shape
    if min(nx, ny, nz) < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    # All cube base corners.
    bx, by, bz = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1),
                             np.arange(nz - 1), indexing="ij")
    base = np.stack([bx.ravel(), by.ravel(), bz.ravel()], -1)  # (c, 3)

    corner_idx = base[:, None, :] + _CORNERS[None]             # (c, 8, 3)
    vals = volume[corner_idx[..., 0], corner_idx[..., 1],
                  corner_idx[..., 2]]                           # (c, 8)
    inside = vals > threshold

    verts_out = []
    faces_out = []
    n_verts = 0

    for tet in _TETS:
        tvals = vals[:, tet]                    # (c, 4)
        tins = inside[:, tet]
        mask_bits = (tins * np.array([1, 2, 4, 8])).sum(-1)     # (c,)
        tpos = corner_idx[:, tet].astype(np.float64)            # (c, 4, 3)

        for pattern, tris in _TET_TRIS.items():
            sel = np.nonzero(mask_bits == pattern)[0]
            if sel.size == 0:
                continue
            sv = tvals[sel]                       # (s, 4)
            sp = tpos[sel]                        # (s, 4, 3)
            # Interpolated vertex on each of the 6 tet edges.
            a = _TET_EDGES[:, 0]
            b = _TET_EDGES[:, 1]
            va = sv[:, a]                         # (s, 6)
            vb = sv[:, b]
            denom = vb - va
            t = np.where(np.abs(denom) > 1e-12,
                         (threshold - va) / np.where(denom == 0, 1, denom),
                         0.5)
            t = np.clip(t, 0.0, 1.0)
            edge_pts = sp[:, a] + t[..., None] * (sp[:, b] - sp[:, a])

            for tri in tris:
                pts = edge_pts[:, tri]            # (s, 3, 3)
                verts_out.append(pts.reshape(-1, 3))
                idx = n_verts + np.arange(pts.shape[0] * 3) \
                    .reshape(-1, 3)
                faces_out.append(idx)
                n_verts += pts.shape[0] * 3

    if not verts_out:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    verts = np.concatenate(verts_out).astype(np.float64)
    faces = np.concatenate(faces_out).astype(np.int64)

    # Weld duplicate vertices.
    verts_q = np.round(verts * 1e6).astype(np.int64)
    _, unique_idx, inverse = np.unique(verts_q, axis=0, return_index=True,
                                       return_inverse=True)
    verts = verts[unique_idx]
    faces = inverse[faces]

    spacing = np.asarray(spacing, dtype=np.float64)
    origin = np.asarray(origin, dtype=np.float64)
    verts = verts * spacing + origin
    return verts.astype(np.float32), faces.astype(np.int32)


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray):
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for face in faces:
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")


def density_volume(net, grid, x_range=(-10, 10), y_range=(-5, 2),
                   z_range=(3, 40), resolution=64,
                   query_batch=50000) -> np.ndarray:
    """The density (resolution,) * 3 float32 of `net` (a BTSNet) on the
    feature grid `grid` at a dense world grid, x slowest: the axes are
    linspace in float64, the points cast to float32, and
    `BTSNet.query(grid, pts, only_density=True)` runs on chunks of
    `query_batch` points on the net's device, as the JAX package builds
    and queries them."""
    xs = np.linspace(*x_range, resolution)
    ys = np.linspace(*y_range, resolution)
    zs = np.linspace(*z_range, resolution)
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    pts = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float32)
    dev = next(net.parameters()).device
    sigmas = []
    with torch.no_grad():
        for i in range(0, len(pts), query_batch):
            chunk = torch.as_tensor(pts[i:i + query_batch], device=dev)[None]
            _, _, sigma = net.query(grid, chunk, only_density=True)
            sigmas.append(sigma[0, :, 0].float().cpu().numpy())
    return np.concatenate(sigmas).reshape(resolution, resolution,
                                          resolution)


def extract_mesh_from_density(net, grid, x_range=(-10, 10), y_range=(-5, 2),
                              z_range=(3, 40), resolution=64, threshold=0.5,
                              query_batch=50000, volume=None):
    """The isosurface at `threshold` of `density_volume` (or of `volume`,
    that volume computed before) over the ranges: (verts (m, 3) float32
    in world coordinates, faces (k, 3) int32)."""
    if volume is None:
        volume = density_volume(net, grid, x_range, y_range, z_range,
                                resolution, query_batch)
    spacing = ((x_range[1] - x_range[0]) / (resolution - 1),
               (y_range[1] - y_range[0]) / (resolution - 1),
               (z_range[1] - z_range[0]) / (resolution - 1))
    origin = (x_range[0], y_range[0], z_range[0])
    return marching_tetrahedra(volume, threshold, spacing, origin)
