"""Generate a synthetic Waymo tree with the real layout, without OpenCV
(no JAX counterpart; like `gen_synthetic_kitti_raw.py`, it lets the GPU
machine build its own tree).

The street is the box world of `gen_synthetic_kitti_360.py` and the
drive that of `gen_synthetic_kitti_raw.py`. The vehicle frame is the
front camera's (x right, y down, z forward, with that tree's
inclination); the four side cameras sit beside it, turned 45 and 90
degrees to the left and right, as Waymo's rig is. Every camera has the
NDC intrinsics of the KITTI-360 tree's rectified camera, so that at
192x640 a model trained on that tree (`media/weights/k360_synth_conv.npz`)
sees the same geometry. The LiDAR is an HDL-64-style scan (64 rings x
1024 azimuths) from the velodyne of that tree, its points in the vehicle
frame.

Frames are 640x960, a cut from Waymo's 1280x1920: the port decodes JPEG
in Python (PERF.md section 5), and the loader resizes to the config's
size either way. Floats that the loader reads (poses, calibrations,
LiDAR points) are rounded before they are written and used, so that the
tree's bytes do not depend on the last bit of the machine's
transcendental functions.

Layout (reference datasets/waymo/waymo_dataset.py):
  <out>/training/<seq>/calibration.pkl   {"extrinsics": {cam: 4x4 camera
                                         to vehicle}, "proj_mats": {cam:
                                         3x3 NDC}}, cameras 1-5
  <out>/training/<seq>/exposures.pkl     {cam: (n,) exposure}
  <out>/training/<seq>/poses.npy         (n, 4, 4) vehicle to world
  <out>/training/<seq>/frames/cam_0C/%010d.jpg
  <out>/training/<seq>/lidar/%010d.npy   (m, 3) float32, vehicle frame
  <out>/validation                       -> training (a symbolic link:
                                         the one drive serves both splits)
  <out>/val_split.txt                    `seq keyframe` lines
Frames are written by `jpeg.write_jpeg` (baseline 4:2:0, quality 95).

Usage:
  python -m behindthescenes_tpu_torch.datasets.gen_synthetic_waymo \
      --out <dir> [--frames 24] [--seed 0] [--workers N]
then, for example,
  python -m behindthescenes_tpu_torch.eval -cn eval_depth \
      checkpoint=media/weights/k360_synth_conv.npz data.type=Waymo \
      data.data_path=<dir> data.split_path=<dir>/val_split.txt
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import time
from pathlib import Path

import numpy as np

from behindthescenes_tpu_torch.datasets import gen_synthetic_kitti_360 as k360
from behindthescenes_tpu_torch.datasets.gen_synthetic_kitti_raw import (
    body_poses, pool_map)
from behindthescenes_tpu_torch.datasets.jpeg import write_jpeg

SEQ = "segment-0000000000000000000_000_000"
FRAME_SIZE = (640, 960)
FRAMES = 24
# Validation keyframes (the front camera's frame of each item).
KEYFRAMES = (2, 6, 10, 14)
# Camera -> yaw in degrees (positive turns the camera to the right) and
# its offset from the front camera in metres (x right, z forward).
CAMERAS = {1: (0.0, (0.0, 0.0)), 2: (-45.0, (-0.3, -0.1)),
           3: (45.0, (0.3, -0.1)), 4: (-90.0, (-0.5, -0.6)),
           5: (90.0, (0.5, -0.6))}
DECIMALS = 9          # of poses and calibrations
LIDAR_DECIMALS = 4    # of LiDAR points (0.1 mm)


def k_ndc() -> np.ndarray:
    """The NDC intrinsics of the KITTI-360 tree's rectified camera."""
    return np.round(np.array([
        [2 * k360.F_REF / k360.WP_REF, 0, 2 * k360.CX_REF / k360.WP_REF - 1],
        [0, 2 * k360.F_REF / k360.HP_REF, 2 * k360.CY_REF / k360.HP_REF - 1],
        [0, 0, 1]], np.float64), DECIMALS)


def extrinsic(yaw_deg: float, offset) -> np.ndarray:
    """Camera to vehicle: a turn about the vehicle's y axis (down) and an
    offset in its x-z plane."""
    a = np.deg2rad(yaw_deg)
    m = np.eye(4)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = np.cos(a), np.sin(a), \
        -np.sin(a), np.cos(a)
    m[0, 3], m[2, 3] = offset
    return np.round(m, DECIMALS)


def _write_view(task) -> dict:
    """Render and write one camera frame (JPEG) or one LiDAR scan (the
    points in the vehicle frame); returns the seconds it took and the
    bytes it wrote."""
    (kind, c2w, path), boxes, (h, w), velo_to_vehicle = task
    t0 = time.perf_counter()
    if kind == "lidar":
        pts = k360.velodyne_scan(c2w, boxes)[:, :3].astype(np.float64)
        pts = pts @ velo_to_vehicle[:3, :3].T + velo_to_vehicle[:3, 3]
        np.save(path, np.round(pts, LIDAR_DECIMALS).astype(np.float32))
        return {"lidar": time.perf_counter() - t0}
    dirs = k360.pinhole_dirs_ndc(k_ndc(), h, w)
    rgb, _, _ = k360.render_image(c2w, dirs, boxes)
    t1 = time.perf_counter()
    write_jpeg(path, np.clip(rgb * 255.0, 0, 255).astype(np.uint8))
    return {"render": t1 - t0, "jpeg": time.perf_counter() - t1,
            "frame_bytes": Path(path).stat().st_size}


def generate_tree(out, n_frames=FRAMES, seed=0, keyframes=KEYFRAMES,
                  size=FRAME_SIZE, workers=1) -> dict:
    """Write the tree under `out`, rendering in `workers` processes;
    returns the seconds of its parts summed over the frames (render,
    jpeg, lidar) and the byte count of the frames."""
    out = Path(out)
    rng = np.random.default_rng(seed)
    boxes = k360.build_scene(rng, n_frames * 1.0)
    calibs = k360.make_calibs(k360.HP_REF, k360.WP_REF, k360.HF_REF,
                              k360.WF_REF)
    # The vehicle frame is the front camera's; the velodyne sits where
    # the KITTI-360 tree's does, level with the street.
    vehicle_c2w = np.round(body_poses(n_frames)
                           @ calibs["cam_to_pose"]["image_00"], DECIMALS)
    velo_to_vehicle = np.linalg.inv(calibs["cam_to_velo"])
    seq_dir = out / "training" / SEQ
    for cam in CAMERAS:
        (seq_dir / "frames" / f"cam_{cam:02d}").mkdir(parents=True,
                                                     exist_ok=True)
    (seq_dir / "lidar").mkdir(parents=True, exist_ok=True)
    extrinsics = {cam: extrinsic(*spec) for cam, spec in CAMERAS.items()}
    with open(seq_dir / "calibration.pkl", "wb") as f:
        pickle.dump({"extrinsics": extrinsics,
                     "proj_mats": {cam: k_ndc() for cam in CAMERAS}}, f)
    with open(seq_dir / "exposures.pkl", "wb") as f:
        pickle.dump({cam: np.ones(n_frames) for cam in CAMERAS}, f)
    np.save(seq_dir / "poses.npy", vehicle_c2w.astype(np.float32))
    os.symlink("training", out / "validation")
    with open(out / "val_split.txt", "w") as f:
        f.writelines(f"{SEQ} {i}\n" for i in keyframes)

    tasks = []
    for i in range(n_frames):
        tasks += [("image", vehicle_c2w[i] @ extrinsics[cam],
                   seq_dir / "frames" / f"cam_{cam:02d}" / f"{i:010d}.jpg")
                  for cam in CAMERAS]
        tasks.append(("lidar", vehicle_c2w[i] @ velo_to_vehicle,
                      seq_dir / "lidar" / f"{i:010d}.npy"))
    secs = {"render": 0.0, "jpeg": 0.0, "lidar": 0.0, "frame_bytes": 0}
    for part in pool_map(_write_view, [(t, boxes, size, velo_to_vehicle)
                                       for t in tasks], workers):
        for key, value in part.items():
            secs[key] += value
    return secs


def overrides(tree) -> list:
    """The command-line overrides that point a config at a tree (the
    dataset type included)."""
    tree = str(tree)
    return ["data.type=Waymo", f"data.data_path={tree}",
            f"data.split_path={tree}/val_split.txt"]


def main():
    ap = argparse.ArgumentParser("synthetic Waymo tree generator")
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=os.cpu_count())
    ap.add_argument("--size", type=int, nargs=2, default=FRAME_SIZE,
                    help="frame size (a cut for tests)")
    ap.add_argument("--keyframes", type=int, nargs="+", default=KEYFRAMES)
    args = ap.parse_args()
    t0 = time.perf_counter()
    secs = generate_tree(args.out, args.frames, args.seed,
                         tuple(args.keyframes), tuple(args.size),
                         workers=args.workers)
    print(json.dumps({"out": args.out, **secs,
                      "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
