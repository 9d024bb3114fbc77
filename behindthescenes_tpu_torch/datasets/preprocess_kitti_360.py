"""Offline KITTI-360 preprocessing: the port's own copy of
scripts/datasets/preprocess_kitti_360.py (reference
datasets/kitti_360/preprocess_kitti_360.py:17-81). Resizes the rectified
perspective frames of both cameras to the target resolution into
data_<h>x<w>/, and resamples the fisheye frames of both cameras to
pinhole at that resolution and rotation into data_<h>x<w>_<r0>x<r1>/, as
the JAX script does (`((x * 0.5 + 0.5) * 255).astype(uint8)`, which
truncates), so that loading skips both (the dataset's
`is_preprocessed=True` path).

Usage:
  python -m behindthescenes_tpu_torch.datasets.preprocess_kitti_360 \
      -d <tree> [-r 192 640] [-f 0 -15] [--only-fisheye]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from behindthescenes_tpu_torch.datasets.kitti_360 import Kitti360Dataset
from behindthescenes_tpu_torch.datasets.png import write_png

CAMERAS = ("image_00", "image_01", "image_02", "image_03")


def preprocess(data_path, resolution=(192, 640), fisheye_rotation=None,
               only_fisheye=False) -> None:
    """Write the preprocessed frames of every frame of the tree that has
    none of them yet: data_<h>x<w>/ of image_00 and image_01 (unless
    only_fisheye), and, when `fisheye_rotation` (r0, r1) is given,
    data_<h>x<w>_<r0>x<r1>/ of image_02 and image_03."""
    data_path = Path(data_path)
    res = tuple(resolution)
    fisheye = fisheye_rotation is not None
    rot = tuple(fisheye_rotation) if fisheye else (0, 0)
    dataset = Kitti360Dataset(
        data_path=str(data_path), pose_path=str(data_path / "data_poses"),
        split_path=None, target_image_size=res, return_stereo=True,
        return_fisheye=fisheye, frame_count=1, fisheye_rotation=rot)
    folders = {"image_00": f"data_{res[0]}x{res[1]}",
               "image_01": f"data_{res[0]}x{res[1]}",
               "image_02": f"data_{res[0]}x{res[1]}_{rot[0]}x{rot[1]}",
               "image_03": f"data_{res[0]}x{res[1]}_{rot[0]}x{rot[1]}"}
    # Order of an item's images: perspective left, perspective right,
    # fisheye left, fisheye right (frame_count=1, return_stereo).
    cams = [(i, cam) for i, cam in enumerate(CAMERAS[:4 if fisheye else 2])
            if not (only_fisheye and i < 2)]
    for i in range(len(dataset)):
        seq, frame, is_right = dataset._datapoints[i]
        if is_right:
            continue
        img_id = dataset._img_ids[seq][frame]
        files = {cam: data_path / "data_2d_raw" / seq / cam / folders[cam]
                 / f"{img_id:010d}.png" for _, cam in cams}
        if all(f.exists() for f in files.values()):
            continue
        data = dataset[i]
        for cam_i, cam in cams:
            files[cam].parent.mkdir(exist_ok=True, parents=True)
            img = (data["imgs"][cam_i] * 0.5 + 0.5) * 255.0
            write_png(files[cam], img.astype(np.uint8))
        if i % 100 == 0:
            print(f"{i}/{len(dataset)}")


def main():
    parser = argparse.ArgumentParser("KITTI-360 preprocessing")
    parser.add_argument("--data-path", "-d", required=True)
    parser.add_argument("--resolution", "-r", type=int, nargs=2,
                        default=(192, 640))
    parser.add_argument("--fisheye-rotation", "-f", type=int, nargs=2,
                        default=(0, -15))
    parser.add_argument("--only-fisheye", "-o", action="store_true")
    args = parser.parse_args()
    preprocess(args.data_path, args.resolution, args.fisheye_rotation,
               args.only_fisheye)


if __name__ == "__main__":
    main()
