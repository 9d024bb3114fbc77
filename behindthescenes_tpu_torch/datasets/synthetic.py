"""Synthetic in-memory dataset: procedurally rendered box scenes with exact
analytic depth. The port's own copy of
behindthescenes_tpu/datasets/synthetic.py; it makes bit-identical scenes
for the same seed. Replaces disk loaders in tests and overfit harnesses
(SURVEY.md §4: the rebuild's substitute for the reference's missing tests).

Scene: a ground plane plus a few colored axis-aligned boxes; cameras translate
along +x with small rotations. Images are ray-cast on the host with numpy —
slow but exact, giving ground-truth depth for metric tests.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from behindthescenes_tpu_torch.datasets.raycast import raycast_boxes


@dataclasses.dataclass
class SyntheticBoxDataset:
    """Returns the reference data-dict ABI: imgs (v,h,w,3) in [-1,1],
    projs (v,3,3) NDC, poses (v,4,4) c2w, depths (1,h,w)."""
    length: int = 16
    frame_count: int = 2
    height: int = 48
    width: int = 64
    z_near: float = 1.0
    z_far: float = 40.0
    return_depth: bool = True
    seed: int = 0
    # "street" (default): ground plane + boxes + sky, sideways-translating
    # cameras (the stereo-like family every committed gate checkpoint was
    # trained on — its RNG draw order is frozen). "indoor": a closed
    # textured room with furniture and a forward-dolly trajectory, the
    # RealEstate10K-workload stand-in (reference
    # datasets/realestate10k/realestate10k_dataset.py is mono video of
    # interiors; no real RE10K data ships in this environment).
    scene_type: str = "street"
    # Street-only: N thin vertical poles (0.25-0.5 m wide) in front of the
    # larger boxes. At lindisp coarse sampling their depth extent is far
    # below one z-bin, so flat coarse sampling blurs them — the scene
    # family that shows the importance-fine pass doing real work
    # (PERF.md serving sweep). Default 0: draws happen AFTER the base
    # scene's, so existing datasets are bit-identical.
    thin_structures: int = 0
    # Samples are deterministic in (seed, idx); cache them so only the
    # first epoch pays the host-side raycast (~0.3s/sample at 192x640 —
    # the bottleneck of flagship-shape synthetic training otherwise).
    cache: bool = True

    def __post_init__(self):
        self._cache = {}

    def __len__(self):
        return self.length

    def _scene(self, rng, thin_rng=None):
        boxes = []
        for _ in range(4):
            cx = rng.uniform(-4, 4)
            cz = rng.uniform(6, 18)
            s = rng.uniform(0.8, 2.5)
            h = rng.uniform(1.0, 3.0)
            color = rng.uniform(0.2, 1.0, 3)
            boxes.append((np.array([cx - s, -1.0, cz - s]),
                          np.array([cx + s, -1.0 + h, cz + s]), color))
        if self.thin_structures:
            # Independent stream (passed in, derived from (seed, idx)):
            # the base scene AND the camera-trajectory draws that follow
            # must stay bit-identical whether or not poles are added
            # (test_synthetic_scenes.py pins this).
            rt = thin_rng if thin_rng is not None \
                else np.random.default_rng(314159)
            for _ in range(self.thin_structures):
                cx = rt.uniform(-3, 3)
                cz = rt.uniform(4, 12)
                s = rt.uniform(0.25, 0.5) / 2
                h = rt.uniform(2.0, 3.5)
                color = rt.uniform(0.5, 1.0, 3)
                boxes.append((np.array([cx - s, -1.0, cz - s]),
                              np.array([cx + s, -1.0 + h, cz + s]), color))
        return boxes, dict(ground_y=-1.0)

    def _scene_indoor(self, rng):
        """A closed room: floor (checker), ceiling, four walls, furniture
        boxes, and thin wall 'pictures'. Every surface gets the raycaster's
        world-space sine texture — big flat-colored walls otherwise starve
        the photometric loss (any depth reprojects flat color to flat
        color; same finding as the KITTI-360 generator's TEXTURE_AMP)."""
        hw = rng.uniform(2.2, 3.5)            # half width
        zb = rng.uniform(10.0, 16.0)          # back wall
        ceil = rng.uniform(1.2, 1.8)
        boxes = []

        def wall(lo, hi):
            boxes.append((np.asarray(lo, np.float64),
                          np.asarray(hi, np.float64),
                          rng.uniform(0.45, 0.85, 3)))

        wall([-hw - 0.3, -1.5, -3.0], [-hw, ceil + 0.3, zb + 0.3])   # left
        wall([hw, -1.5, -3.0], [hw + 0.3, ceil + 0.3, zb + 0.3])     # right
        wall([-hw - 0.3, -1.5, zb], [hw + 0.3, ceil + 0.3, zb + 0.3])  # back
        wall([-hw - 0.3, -1.5, -3.3], [hw + 0.3, ceil + 0.3, -3.0])  # front
        wall([-hw - 0.3, ceil, -3.0], [hw + 0.3, ceil + 0.3, zb + 0.3])  # up
        for _ in range(4):                    # furniture on the floor
            cx = rng.uniform(-hw + 0.6, hw - 0.6)
            cz = rng.uniform(2.0, zb - 1.0)
            sx, sz = rng.uniform(0.3, 0.9, 2)
            h = rng.uniform(0.4, 1.6)
            boxes.append((np.array([cx - sx, -1.5, cz - sz]),
                          np.array([cx + sx, -1.5 + h, cz + sz]),
                          rng.uniform(0.2, 1.0, 3)))
        for side in (-1.0, 1.0):              # wall pictures (thin boxes)
            cz = rng.uniform(3.0, zb - 2.0)
            w2, h2 = rng.uniform(0.4, 0.9, 2)
            x = side * hw - side * 0.05
            boxes.append((np.array([min(x, side * hw), -0.2 - h2, cz - w2]),
                          np.array([max(x, side * hw), -0.2 + h2, cz + w2]),
                          rng.uniform(0.2, 1.0, 3)))
        return boxes, dict(ground_y=-1.5, checker_period=0.8,
                           ground_colors=(0.55, 0.4), texture_amp=0.45)

    def _raycast(self, origin, dirs, boxes, **kwargs):
        """dirs: (h, w, 3) unit. Returns rgb (h,w,3) in [0,1], depth (h,w)."""
        rgb, t_hit, _ = raycast_boxes(origin, dirs, boxes, **kwargs)
        depth_z = np.where(np.isinf(t_hit), 0.0, t_hit * dirs[..., 2])
        return rgb.astype(np.float32), depth_z.astype(np.float32)

    def __getitem__(self, idx):
        if self.cache and idx in self._cache:
            return self._cache[idx]
        out = self._generate(idx)
        if self.cache:
            self._cache[idx] = out
        return out

    def _generate(self, idx):
        rng = np.random.default_rng(self.seed * 100003 + idx)
        indoor = self.scene_type == "indoor"
        thin_rng = np.random.default_rng(self.seed * 100003 + idx + 314159)
        boxes, rc_kwargs = (self._scene_indoor(rng) if indoor
                            else self._scene(rng, thin_rng))
        h, w = self.height, self.width
        fx, fy = 1.2, 1.2 * w / h   # NDC focal lengths
        k = np.array([[fx, 0, 0], [0, fy, 0], [0, 0, 1]], dtype=np.float32)

        xs = np.linspace(-1, 1, w)
        ys = np.linspace(-1, 1, h)
        gx, gy = np.meshgrid(xs, ys)
        dirs_cam = np.stack([gx / fx, gy / fy, np.ones_like(gx)], axis=-1)
        dirs_cam /= np.linalg.norm(dirs_cam, axis=-1, keepdims=True)

        imgs, poses, projs, depths = [], [], [], []
        for v in range(self.frame_count):
            pose = np.eye(4, dtype=np.float32)
            if indoor:
                # RE10K-like forward dolly with a little lateral drift/yaw.
                pose[0, 3] = rng.normal(0, 0.04)
                pose[1, 3] = rng.normal(0, 0.02)
                pose[2, 3] = 0.35 * v + rng.normal(0, 0.02)
                theta = rng.normal(0, 0.02)
            else:
                pose[0, 3] = 0.4 * v + rng.normal(0, 0.02)
                pose[1, 3] = rng.normal(0, 0.01)
                theta = rng.normal(0, 0.01)
            pose[:3, :3] = np.array([
                [np.cos(theta), 0, np.sin(theta)],
                [0, 1, 0],
                [-np.sin(theta), 0, np.cos(theta)]], dtype=np.float32)
            dirs_world = dirs_cam @ pose[:3, :3].T
            rgb, depth_z = self._raycast(pose[:3, 3], dirs_world, boxes,
                                         **rc_kwargs)
            imgs.append(rgb * 2.0 - 1.0)
            poses.append(pose)
            projs.append(k)
            if v == 0:
                depths.append(depth_z[None])

        out = {
            "imgs": np.stack(imgs).astype(np.float32),
            "poses": np.stack(poses),
            "projs": np.stack(projs),
        }
        if self.return_depth:
            out["depths"] = np.stack(depths)
        return out


def collate(samples):
    """Stack a list of sample dicts into a batch dict (leading n dim).

    Ragged metadata fields (e.g. KITTI-360's `3d_bboxes`, a per-sample
    LIST of box dicts) pass through as plain lists — np.stack would turn
    them into object arrays that downstream `b["semanticId"]` indexing
    chokes on."""
    keys = samples[0].keys()
    out = {}
    for k in keys:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], (list, tuple, dict)):
            out[k] = vals
        else:
            out[k] = np.stack(vals)
    return out


def make_test_dataset(image_size=(48, 64), length: int = 64,
                      scene: str = "street", thin_structures: int = 0):
    """The `Synthetic` test split of the JAX package's dataset factory
    (datasets/factory.py:14-29): depth-carrying scenes from seed 2."""
    h, w = image_size
    return SyntheticBoxDataset(length=max(4, length // 8), frame_count=2,
                               height=h, width=w, return_depth=True, seed=2,
                               scene_type=scene,
                               thin_structures=thin_structures)
