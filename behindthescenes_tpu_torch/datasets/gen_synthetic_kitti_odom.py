"""Generate a synthetic KITTI odometry sequence with the real layout,
without OpenCV (no JAX counterpart; like `gen_synthetic_kitti_raw.py`, it
lets the GPU machine build its own tree).

The street and the drive are those of `gen_synthetic_kitti_raw.py`: a
rectified stereo pair a frame, at sequence 00's size (376x1241), with
intrinsics whose NDC values are the KITTI-360 tree's (so that a model
trained on that tree, `media/weights/k360_synth_conv.npz`, sees about the
same geometry after the loader's crop to 192x640). Poses and
calibrations are rounded before they are written and used, so that the
tree's bytes do not depend on the last bit of the machine's
transcendental functions.

Layout (reference datasets/kitti_odom/kitti_odometry_dataset.py):
  <out>/sequences/00/calib.txt           P0-P3 (3x4 a line), Tr
  <out>/sequences/00/image_2|image_3/%06d.png
  <out>/poses/00.txt                     3x4 camera-to-world a line
Frames are written by `png.write_png` (8-bit RGB).

Usage:
  python -m behindthescenes_tpu_torch.datasets.gen_synthetic_kitti_odom \
      --out <dir> [--frames 12] [--seed 0] [--workers N]
then, for example,
  python -m behindthescenes_tpu_torch.train -cn exp_kitti_raw \
      data.type=KITTI_Odometry data.data_path=<dir> \
      data.pose_path=<dir>/poses "data.train_sequences=['00']"
"""
from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np

from behindthescenes_tpu_torch.datasets import gen_synthetic_kitti_360 as k360
from behindthescenes_tpu_torch.datasets.gen_synthetic_kitti_raw import (
    STEREO_BASELINE, body_poses, k_pixels, pool_map)
from behindthescenes_tpu_torch.datasets.png import write_png

SEQ = "00"
H0, W0 = 376, 1241            # sequence 00's size (kitti_odom.BASE_SIZES)
FRAMES = 12
DECIMALS = 9


def _line(key, mat) -> str:
    return f"{key}: " + " ".join(map(repr, np.asarray(mat, np.float64)
                                     .ravel().tolist())) + "\n"


def _write_view(task) -> dict:
    """Render and write one camera frame (PNG); returns the seconds it
    took and the bytes it wrote."""
    (c2w, path), boxes, k, (h, w) = task
    t0 = time.perf_counter()
    dirs = k360.pinhole_dirs(np.hstack([k, np.zeros((3, 1))]), h, w)
    rgb, _, _ = k360.render_image(c2w, dirs, boxes)
    t1 = time.perf_counter()
    write_png(path, np.clip(rgb * 255.0, 0, 255).astype(np.uint8))
    return {"render": t1 - t0, "png": time.perf_counter() - t1,
            "frame_bytes": Path(path).stat().st_size}


def generate_tree(out, n_frames=FRAMES, seed=0, size=(H0, W0),
                  workers=1) -> dict:
    """Write the sequence under `out`, rendering in `workers` processes;
    returns the seconds of its parts summed over the frames (render, png)
    and the byte count of the frames."""
    out = Path(out)
    h, w = size
    rng = np.random.default_rng(seed)
    boxes = k360.build_scene(rng, n_frames * 1.0)
    calibs = k360.make_calibs(k360.HP_REF, k360.WP_REF, k360.HF_REF,
                              k360.WF_REF)
    k = np.round(k_pixels(h, w), DECIMALS)
    p_l = np.hstack([k, np.zeros((3, 1))])
    p_r = p_l.copy()
    p_r[0, 3] = np.round(-k[0, 0] * STEREO_BASELINE, DECIMALS)
    seq_dir = out / "sequences" / SEQ
    for cam in ("image_2", "image_3"):
        (seq_dir / cam).mkdir(parents=True, exist_ok=True)
    with open(seq_dir / "calib.txt", "w") as f:
        f.write(_line("P0", p_l) + _line("P1", p_r) + _line("P2", p_l)
                + _line("P3", p_r) + _line("Tr", np.eye(4)[:3]))
    cams = np.round(body_poses(n_frames)
                    @ calibs["cam_to_pose"]["image_00"], DECIMALS)
    (out / "poses").mkdir(parents=True, exist_ok=True)
    with open(out / "poses" / f"{SEQ}.txt", "w") as f:
        for c2w in cams:
            f.write(" ".join(map(repr, c2w[:3].ravel().tolist())) + "\n")

    right = np.eye(4)
    right[0, 3] = STEREO_BASELINE
    tasks = []
    for i in range(n_frames):
        tasks += [(cams[i], seq_dir / "image_2" / f"{i:06d}.png"),
                  (cams[i] @ right, seq_dir / "image_3" / f"{i:06d}.png")]
    secs = {"render": 0.0, "png": 0.0, "frame_bytes": 0}
    for part in pool_map(_write_view, [(t, boxes, k, size) for t in tasks],
                         workers):
        for key, value in part.items():
            secs[key] += value
    return secs


def overrides(tree) -> list:
    """The command-line overrides that point a config at the sequence
    (the dataset type included; it trains and tests on sequence 00)."""
    tree = str(tree)
    return ["data.type=KITTI_Odometry", f"data.data_path={tree}",
            f"data.pose_path={tree}/poses", f"data.train_sequences=['{SEQ}']",
            f"data.test_sequences=['{SEQ}']"]


def main():
    ap = argparse.ArgumentParser("synthetic KITTI odometry generator")
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=os.cpu_count())
    ap.add_argument("--size", type=int, nargs=2, default=(H0, W0),
                    help="frame size (a cut for tests)")
    args = ap.parse_args()
    t0 = time.perf_counter()
    secs = generate_tree(args.out, args.frames, args.seed, tuple(args.size),
                         workers=args.workers)
    print(json.dumps({"out": args.out, **secs,
                      "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
