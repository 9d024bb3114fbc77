"""Offline KITTI-360 preprocessing, perspective frames only: the port's own
copy of scripts/datasets/preprocess_kitti_360.py (reference
datasets/kitti_360/preprocess_kitti_360.py:17-81). Resizes the rectified
perspective frames of both cameras to the target resolution once, as the
JAX script does, into data_<h>x<w>/, so that loading skips the resize
(the dataset's `is_preprocessed=True` path). The fisheye frames need the
fisheye resample, which is not ported (ROADMAP Queue A item 7).

Usage:
  python -m behindthescenes_tpu_torch.datasets.preprocess_kitti_360 \
      -d <tree> [-r 192 640]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from behindthescenes_tpu_torch.datasets.kitti_360 import Kitti360Dataset
from behindthescenes_tpu_torch.datasets.png import write_png


def preprocess(data_path, resolution=(192, 640)) -> None:
    """Write data_<h>x<w>/ of image_00 and image_01 for every frame of the
    tree that has no such image yet."""
    data_path = Path(data_path)
    res = tuple(resolution)
    dataset = Kitti360Dataset(
        data_path=str(data_path), pose_path=str(data_path / "data_poses"),
        split_path=None, target_image_size=res, return_stereo=True,
        return_fisheye=False, frame_count=1)
    persp = f"data_{res[0]}x{res[1]}"
    for i in range(len(dataset)):
        seq, frame, is_right = dataset._datapoints[i]
        if is_right:
            continue
        img_id = dataset._img_ids[seq][frame]
        dirs = {cam: data_path / "data_2d_raw" / seq / cam / persp
                for cam in ("image_00", "image_01")}
        if (dirs["image_00"] / f"{img_id:010d}.png").exists():
            continue
        data = dataset[i]
        # Order: perspective left, perspective right (frame_count=1,
        # return_stereo).
        for cam_i, (cam, d) in enumerate(dirs.items()):
            d.mkdir(exist_ok=True, parents=True)
            img = (data["imgs"][cam_i] * 0.5 + 0.5) * 255.0
            write_png(d / f"{img_id:010d}.png", img.astype(np.uint8))
        if i % 100 == 0:
            print(f"{i}/{len(dataset)}")


def main():
    parser = argparse.ArgumentParser("KITTI-360 preprocessing")
    parser.add_argument("--data-path", "-d", required=True)
    parser.add_argument("--resolution", "-r", type=int, nargs=2,
                        default=(192, 640))
    args = parser.parse_args()
    preprocess(args.data_path, args.resolution)


if __name__ == "__main__":
    main()
