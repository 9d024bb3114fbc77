"""Generate a synthetic KITTI raw drive with the real layout, without
OpenCV (no JAX counterpart; like `gen_synthetic_kitti_360.py`, it lets the
GPU machine build its own tree).

The street is the box world of `gen_synthetic_kitti_360.py` (its
`build_scene`, `pinhole_dirs`, `render_image` and `velodyne_scan`): a
rectified stereo pair and an HDL-64 scan (64 rings x 1024 azimuths) a
frame, at the base size of day 2011_09_26 (375x1242). The cameras carry
that tree's inclination and its velodyne sits level with the street, and
P_rect is chosen so that the NDC focal lengths and principal point equal
the KITTI-360 tree's: at 192x640 a model trained on that tree
(`media/weights/k360_synth_conv.npz`) sees the same geometry here.

Layout (reference datasets/kitti_raw/kitti_raw_dataset.py):
  <out>/2011_09_26/calib_cam_to_cam.txt      P_rect_02, P_rect_03, R_rect_00,
                                             S_rect_02, S_rect_03 (W0 H0)
  <out>/2011_09_26/calib_velo_to_cam.txt     R, T
  <out>/2011_09_26/<seq>/image_02|image_03/data/%010d.jpg
  <out>/2011_09_26/<seq>/velodyne_points/data/%010d.bin
  <out>/poses/2011_09_26/<seq>.txt           ORB-SLAM: 3x4 c2w a line
  <out>/splits/train_files.txt, test_files.txt   `day/seq id l|r`
Frames are written by `jpeg.write_jpeg` (baseline 4:2:0, quality 95).

Usage:
  python -m behindthescenes_tpu_torch.datasets.gen_synthetic_kitti_raw \
      --out <dir> [--frames 20] [--seed 0] [--workers N]
then, for example,
  python -m behindthescenes_tpu_torch.eval -cn eval_depth \
      checkpoint=media/weights/k360_synth_conv.npz data.data_path=<dir> \
      data.pose_path=<dir>/poses data.split_path=<dir>/splits
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

from behindthescenes_tpu_torch.datasets import gen_synthetic_kitti_360 as k360
from behindthescenes_tpu_torch.datasets.jpeg import write_jpeg

DAY = "2011_09_26"
SEQ = f"{DAY}_drive_0001_sync"
H0, W0 = 375, 1242            # the day's base size (kitti_raw.BASE_SIZES)
STEREO_BASELINE = 0.54        # KITTI's, in metres
FRAMES = 20
# Test keyframes (eight, the left view); every other frame with a
# neighbour on each side trains, both views.
TEST_KEYFRAMES = (3, 5, 7, 9, 11, 13, 15, 17)


def k_pixels(h=H0, w=W0) -> np.ndarray:
    """Pixel intrinsics 3x3 at (h, w) whose NDC values (2 f / size,
    2 c / size - 1) are those of the KITTI-360 tree's rectified camera."""
    fx = k360.F_REF / k360.WP_REF * w
    fy = k360.F_REF / k360.HP_REF * h
    cx = k360.CX_REF / k360.WP_REF * w
    cy = k360.CY_REF / k360.HP_REF * h
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)


def body_poses(n_frames, dz=1.0) -> np.ndarray:
    """The KITTI-360 tree's drive: straight along the street with a gentle
    lateral sway."""
    poses = np.tile(np.eye(4), (n_frames, 1, 1))
    i = np.arange(n_frames)
    poses[:, 0, 3] = 0.3 * np.sin(i * 0.15)
    poses[:, 2, 3] = i * dz
    return poses


def _line(key, mat) -> str:
    return f"{key}: " + " ".join(map(repr, np.asarray(mat, np.float64)
                                     .ravel().tolist())) + "\n"


def pool_map(fn, tasks, workers: int) -> list:
    """fn over tasks, in `workers` forked processes where it is more than
    one (run the generator in a process of its own then: a fork copies
    the caller's threads' locks)."""
    if workers <= 1:
        return [fn(t) for t in tasks]
    ctx = multiprocessing.get_context("fork")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
        return list(ex.map(fn, tasks))


def _write_view(task) -> dict:
    """Render and write one camera frame (JPEG) or one velodyne scan;
    returns the seconds it took and the bytes it wrote."""
    (kind, c2w, path), boxes, k, (h, w) = task
    t0 = time.perf_counter()
    if kind == "velodyne":
        k360.velodyne_scan(c2w, boxes).tofile(str(path))
        return {"velodyne": time.perf_counter() - t0}
    dirs = k360.pinhole_dirs(np.hstack([k, np.zeros((3, 1))]), h, w)
    rgb, _, _ = k360.render_image(c2w, dirs, boxes)
    t1 = time.perf_counter()
    write_jpeg(path, np.clip(rgb * 255.0, 0, 255).astype(np.uint8))
    return {"render": t1 - t0, "jpeg": time.perf_counter() - t1,
            "frame_bytes": Path(path).stat().st_size}


def generate_tree(out, n_frames=FRAMES, seed=0,
                  test_keyframes=TEST_KEYFRAMES, size=(H0, W0),
                  workers=1) -> dict:
    """Write the tree under `out`, rendering in `workers` processes, the
    frames at `size` (the base size unless a test cuts it; the velodyne
    ground truth is always projected at the base size); returns the
    seconds of its parts summed over the frames (render, jpeg, velodyne)
    and the byte count of the frames."""
    out = Path(out)
    h, w = size
    rng = np.random.default_rng(seed)
    boxes = k360.build_scene(rng, n_frames * 1.0)
    calibs = k360.make_calibs(k360.HP_REF, k360.WP_REF, k360.HF_REF,
                              k360.WF_REF)
    cam_to_body = calibs["cam_to_pose"]["image_00"]
    # velodyne -> camera 0 (KITTI's calib_velo_to_cam), R_rect = I.
    velo_to_cam = np.linalg.inv(calibs["cam_to_velo"])

    # P_rect at the base size, which the loader's NDC conversion assumes;
    # the frames are rendered at `size` with the same NDC intrinsics.
    k = k_pixels()
    p_l = np.hstack([k, np.zeros((3, 1))])
    p_r = p_l.copy()
    p_r[0, 3] = -k[0, 0] * STEREO_BASELINE
    day_dir = out / DAY
    seq_dir = day_dir / SEQ
    day_dir.mkdir(parents=True, exist_ok=True)
    with open(day_dir / "calib_cam_to_cam.txt", "w") as f:
        f.write("calib_time: 09-Jan-2012 13:57:47\n")
        f.write(_line("P_rect_02", p_l) + _line("P_rect_03", p_r)
                + _line("R_rect_00", np.eye(3))
                + _line("S_rect_02", np.array([W0, H0]))
                + _line("S_rect_03", np.array([W0, H0])))
    with open(day_dir / "calib_velo_to_cam.txt", "w") as f:
        f.write("calib_time: 15-Mar-2012 11:37:16\n")
        f.write(_line("R", velo_to_cam[:3, :3])
                + _line("T", velo_to_cam[:3, 3]))

    cams = body_poses(n_frames) @ cam_to_body        # left camera c2w
    pose_dir = out / "poses" / DAY
    pose_dir.mkdir(parents=True, exist_ok=True)
    with open(pose_dir / f"{SEQ}.txt", "w") as f:
        for c2w in cams:
            f.write(" ".join(map(repr, c2w[:3].ravel().tolist())) + "\n")

    right = np.eye(4)
    right[0, 3] = STEREO_BASELINE
    for cam in ("image_02", "image_03"):
        (seq_dir / cam / "data").mkdir(parents=True, exist_ok=True)
    velo_dir = seq_dir / "velodyne_points" / "data"
    velo_dir.mkdir(parents=True, exist_ok=True)
    tasks = []
    for i in range(n_frames):
        tasks += [("image", cams[i], seq_dir / "image_02" / "data"
                   / f"{i:010d}.jpg"),
                  ("image", cams[i] @ right, seq_dir / "image_03" / "data"
                   / f"{i:010d}.jpg"),
                  ("velodyne", cams[i] @ velo_to_cam,
                   velo_dir / f"{i:010d}.bin")]
    secs = {"render": 0.0, "jpeg": 0.0, "velodyne": 0.0, "frame_bytes": 0}
    for part in pool_map(_write_view, [(t, boxes, k_pixels(h, w), size)
                                       for t in tasks], workers):
        for key, value in part.items():
            secs[key] += value

    split = out / "splits"
    split.mkdir(exist_ok=True)
    with open(split / "test_files.txt", "w") as f:
        f.writelines(f"{DAY}/{SEQ} {i} l\n" for i in test_keyframes)
    with open(split / "train_files.txt", "w") as f:
        for i in range(1, n_frames - 1):
            if i not in test_keyframes:
                f.write(f"{DAY}/{SEQ} {i} l\n{DAY}/{SEQ} {i} r\n")
    return secs


def overrides(tree) -> list:
    """The command-line overrides that point a KITTI_Raw config at a
    tree."""
    tree = str(tree)
    return [f"data.data_path={tree}", f"data.pose_path={tree}/poses",
            f"data.split_path={tree}/splits"]


def main():
    ap = argparse.ArgumentParser("synthetic KITTI raw drive generator")
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=os.cpu_count())
    ap.add_argument("--size", type=int, nargs=2, default=(H0, W0),
                    help="frame size (a cut for tests)")
    ap.add_argument("--keyframes", type=int, nargs="+",
                    default=TEST_KEYFRAMES)
    args = ap.parse_args()
    t0 = time.perf_counter()
    secs = generate_tree(args.out, args.frames, args.seed,
                         tuple(args.keyframes), tuple(args.size),
                         workers=args.workers)
    print(json.dumps({"out": args.out, **secs,
                      "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
