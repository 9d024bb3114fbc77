"""Analytic box-world raycaster (host-side numpy): the port's own copy of
behindthescenes_tpu/datasets/raycast.py, kept bit-identical.

Shared by `SyntheticBoxDataset` (tests / overfit harnesses) and the
synthetic KITTI-360 drive generator
(scripts/datasets/gen_synthetic_kitti_360.py). The reference repo ships no
synthetic data; this scene family is the rebuild's substitute for real
captures in tests and accuracy runs (SURVEY.md §4).
"""
from __future__ import annotations

import numpy as np


def raycast_boxes(origin, dirs, boxes, ground_y=-1.0,
                  ground_colors=(0.75, 0.35), sky_color=(0.5, 0.7, 0.9),
                  checker_period=1.0, texture_amp=0.0):
    """Cast rays into a ground-plane + axis-aligned-boxes scene.

    origin: (3,) ray origin (world). dirs: (..., 3) ray directions (any
    norm; t is measured in units of |dir|). boxes: sequence of
    (lo (3,), hi (3,), color (3,)). ground_y: the plane y == ground_y,
    checkered in world x/z with `ground_colors`.

    Returns (rgb (..., 3) float64 in [0, 1], t_hit (...) float64 — np.inf
    for sky, hit_id (...) int32: -1 sky, 0 ground, 1 + i for boxes[i]).
    Later boxes win ties exactly like the pre-refactor
    SyntheticBoxDataset._raycast (strict `<` against the running t)."""
    dirs = np.asarray(dirs, dtype=np.float64)
    origin = np.asarray(origin, dtype=np.float64)
    shape = dirs.shape[:-1]
    flat = dirs.reshape(-1, 3)

    t_hit = np.full(flat.shape[0], np.inf, dtype=np.float64)
    rgb = np.zeros((flat.shape[0], 3), dtype=np.float64)
    hit_id = np.full(flat.shape[0], -1, dtype=np.int32)

    denom = flat[:, 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        t_plane = np.where(np.abs(denom) > 1e-8,
                           (ground_y - origin[1]) / denom, np.inf)
    t_plane = np.where(t_plane > 0, t_plane, np.inf)
    hit = t_plane < t_hit
    t_safe = np.where(np.isfinite(t_plane), t_plane, 0.0)
    px = origin[0] + t_safe * flat[:, 0]
    pz = origin[2] + t_safe * flat[:, 2]
    checker = (np.floor(px / checker_period)
               + np.floor(pz / checker_period)) % 2
    ground_col = np.where(checker[:, None] > 0.5, ground_colors[0],
                          ground_colors[1])
    rgb = np.where(hit[:, None], ground_col, rgb)
    hit_id = np.where(hit, 0, hit_id)
    t_hit = np.where(hit, t_plane, t_hit)

    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / flat
    for i, (lo, hi, color) in enumerate(boxes):
        lo = np.asarray(lo, dtype=np.float64)
        hi = np.asarray(hi, dtype=np.float64)
        t0 = (lo[None] - origin[None]) * inv
        t1 = (hi[None] - origin[None]) * inv
        tmin = np.minimum(t0, t1).max(-1)
        tmax = np.maximum(t0, t1).min(-1)
        t_box = np.where((tmax >= tmin) & (tmax > 0),
                         np.where(tmin > 0, tmin, tmax), np.inf)
        hit = t_box < t_hit
        rgb = np.where(hit[:, None], np.asarray(color, dtype=np.float64)[None],
                       rgb)
        hit_id = np.where(hit, i + 1, hit_id)
        t_hit = np.where(hit, t_box, t_hit)

    if texture_amp > 0.0:
        # Smooth world-space brightness modulation on every surface:
        # flat-colored faces carry no photometric depth signal between
        # edges (any wrong depth reprojects to the same color), which
        # starves self-supervised training. A bandlimited sine product
        # (wavelengths ~2.5-4m) adds view-CONSISTENT texture that stays
        # benign under bilinear resampling, unlike a fine checker.
        t_safe = np.where(np.isfinite(t_hit), t_hit, 0.0)
        p = origin[None] + t_safe[:, None] * flat
        mod = (1.0 - texture_amp
               + texture_amp * (0.5 + 0.5
                                * np.sin(2.6 * p[:, 0] + 1.8 * p[:, 1] + 0.9)
                                * np.sin(1.6 * p[:, 2] - 1.1 * p[:, 0] + 2.2)))
        rgb = np.where((hit_id >= 0)[:, None], rgb * mod[:, None], rgb)

    sky = hit_id < 0
    rgb = np.where(sky[:, None], np.asarray(sky_color, dtype=np.float64)[None],
                   rgb)
    return (rgb.reshape(shape + (3,)), t_hit.reshape(shape),
            hit_id.reshape(shape))
