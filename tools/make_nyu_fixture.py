"""Write media/fixtures/nyu_depth_v2_labeled.mat: a small stand-in for
NYU Depth v2's labeled set in its MATLAB v7.3 layout, which the port's
HDF5 reader (behindthescenes_tpu_torch/datasets/hdf5.py) and the JAX
package's h5py both read.

    python3 tools/make_nyu_fixture.py [--out media/fixtures]

Four indoor items at NYU's 480x640, rendered by the port's box-world
raycaster in rooms of its indoor scene family (the RealEstate10K tree's),
through NYU's Kinect intrinsics (fx 518.86, fy 519.47 at 640x480). As
MATLAB v7.3 writes them: HDF5 behind a 512-byte user block, the arrays
transposed (images (N, 3, W, H) uint8, depths (N, W, H) float32 z-depth
in metres rounded to 0.1 mm, as the Kinect's are quantised), chunked
with deflate (edge chunks at W and H), a MATLAB_class attribute on each,
and MATLAB's `#refs#` group with a reference dataset beside them, which
the loaders never read. Needs h5py (the test environment), not the GPU
machine.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SIZE = (480, 640)
N_ITEMS = 4
SEED = 20
FX, FY = 518.86, 519.47        # NYU's Kinect, pixels at 640x480
CHUNKS_IMG = (1, 3, 256, 256)
CHUNKS_DEPTH = (1, 256, 256)


def render(seed: int):
    """One indoor view: (rgb uint8 (h, w, 3), z-depth float32 (h, w))."""
    from behindthescenes_tpu_torch.datasets.raycast import raycast_boxes
    from behindthescenes_tpu_torch.datasets.synthetic import \
        SyntheticBoxDataset
    rng = np.random.default_rng(seed)
    boxes, kwargs = SyntheticBoxDataset()._scene_indoor(rng)
    h, w = SIZE
    gx, gy = np.meshgrid(np.linspace(-1, 1, w), np.linspace(-1, 1, h))
    dirs = np.stack([gx * w / (2 * FX), gy * h / (2 * FY),
                     np.ones_like(gx)], -1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origin = np.array([rng.uniform(-0.5, 0.5), rng.uniform(-0.4, 0.2), -1.5])
    rgb, t_hit, _ = raycast_boxes(origin, dirs, boxes, **kwargs)
    depth = np.where(np.isinf(t_hit), 0.0, t_hit * dirs[..., 2])
    return (np.clip(rgb * 255.0, 0, 255).astype(np.uint8),
            np.round(depth, 4).astype(np.float32))


def main():
    import h5py
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "media", "fixtures"))
    args = ap.parse_args()
    views = [render(SEED + i) for i in range(N_ITEMS)]
    images = np.stack([rgb.transpose(2, 1, 0) for rgb, _ in views])
    depths = np.stack([d.T for _, d in views])
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "nyu_depth_v2_labeled.mat")
    with h5py.File(path, "w", userblock_size=512, libver="earliest") as f:
        for name, data, chunks, cls in (
                ("images", images, CHUNKS_IMG, b"uint8"),
                ("depths", depths, CHUNKS_DEPTH, b"single")):
            ds = f.create_dataset(name, data=data, chunks=chunks,
                                  compression="gzip", compression_opts=3)
            ds.attrs["MATLAB_class"] = np.bytes_(cls)
        refs = f.create_group("#refs#")
        refs.create_dataset("a", data=np.frombuffer(
            "bed".encode("utf-16-le"), np.uint16))
        f.create_dataset("names", data=[refs["a"].ref],
                         dtype=h5py.ref_dtype)
    # MATLAB's user block starts with its text header.
    with open(path, "r+b") as f:
        f.write(b"MATLAB 7.3 MAT-file, written by tools/make_nyu_fixture.py"
                .ljust(116, b" "))
    print(f"{path}: {os.path.getsize(path)} bytes, images "
          f"{images.shape} {images.dtype}, depths {depths.shape} "
          f"{depths.dtype} ({depths[depths > 0].min():.3f}-"
          f"{depths.max():.3f} m)")


if __name__ == "__main__":
    main()
