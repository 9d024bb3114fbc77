"""Generate a synthetic RealEstate10K tree with the real layout, without
OpenCV (no JAX counterpart; it lets the GPU machine build its own tree).

Each sequence is a slow forward dolly through one room of the port's
indoor scene family (`synthetic.SyntheticBoxDataset._scene_indoor`, the
scene `media/weights/re10k_synth_conv.npz` was trained on) with that
family's NDC intrinsics (fx = 1.2, fy = 1.2 w / h at the training size
256x384). The camera moves 0.035 m a frame, so frames `test_dilation`
(10) apart are 0.35 m apart, as the synthetic set's frame pairs are.
Frames are rendered at 360x640, RealEstate10K's own frame size, so that
the loader's resize to 256x384 runs, and written by `jpeg.write_jpeg`.

Layout (reference datasets/realestate10k/realestate10k_dataset.py):
  <out>/train.pickle, test.pickle   {key: {timestamps, intrinsics
                                     (n, 4) normalised, poses (n, 3, 4)
                                     world-to-camera}}
  <out>/frames/<split>/<key>/<timestamp>.jpg
  <out>/test_index.txt              `key keyframe` lines

Usage:
  python -m behindthescenes_tpu_torch.datasets.gen_synthetic_re10k \
      --out <dir> [--frames 60] [--seed 0] [--workers N]
then, for example,
  python -m behindthescenes_tpu_torch.eval -cn eval_nvs \
      checkpoint=media/weights/re10k_synth_conv.npz data.data_path=<dir> \
      data.split_path=<dir>/test_index.txt
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import time
from pathlib import Path

import numpy as np

from behindthescenes_tpu_torch.datasets.gen_synthetic_kitti_raw import \
    pool_map
from behindthescenes_tpu_torch.datasets.jpeg import write_jpeg
from behindthescenes_tpu_torch.datasets.raycast import raycast_boxes
from behindthescenes_tpu_torch.datasets.synthetic import SyntheticBoxDataset

FRAME_SIZE = (360, 640)
TRAIN_SIZE = (256, 384)       # the size the NDC intrinsics are set for
STEP = 0.035                  # metres of dolly a frame
FRAMES = 60                   # >= 2 x 29 + 1: every random dilation fits
N_TRAIN, N_TEST = 1, 1
# Test keyframes a sequence; each has its frame `test_dilation` = 10 on.
TEST_KEYFRAMES = tuple(range(0, 48, 4))


def intrinsics() -> np.ndarray:
    """Normalised [fx fy cx cy] whose NDC values are the indoor family's
    (fx 1.2, fy 1.2 w / h at 256x384, centred)."""
    h, w = TRAIN_SIZE
    return np.array([0.6, 0.6 * w / h, 0.5, 0.5], np.float32)


def camera_path(n_frames, rng) -> np.ndarray:
    """c2w (n, 4, 4): a forward dolly with a smooth small sway and yaw."""
    phase = rng.uniform(0, 2 * np.pi, 3)
    i = np.arange(n_frames)
    poses = np.tile(np.eye(4), (n_frames, 1, 1))
    theta = 0.03 * np.sin(0.05 * i + phase[0])
    poses[:, 0, 3] = 0.1 * np.sin(0.04 * i + phase[1])
    poses[:, 1, 3] = 0.02 * np.sin(0.07 * i + phase[2])
    poses[:, 2, 3] = STEP * i
    c, s = np.cos(theta), np.sin(theta)
    poses[:, 0, 0], poses[:, 0, 2] = c, s
    poses[:, 2, 0], poses[:, 2, 2] = -s, c
    return poses


def _write_frame(task) -> dict:
    """Render one frame of a room and write it as a JPEG; returns the
    seconds it took and the bytes it wrote."""
    c2w, room_seed, path, (h, w) = task
    boxes, kwargs = SyntheticBoxDataset()._scene_indoor(
        np.random.default_rng(room_seed))
    k = intrinsics()
    gx, gy = np.meshgrid(np.linspace(-1, 1, w), np.linspace(-1, 1, h))
    dirs = np.stack([gx / (2 * k[0]), gy / (2 * k[1]), np.ones_like(gx)],
                    axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    t0 = time.perf_counter()
    rgb, _, _ = raycast_boxes(c2w[:3, 3], dirs @ c2w[:3, :3].T, boxes,
                              **kwargs)
    t1 = time.perf_counter()
    write_jpeg(path, np.clip(rgb * 255.0, 0, 255).astype(np.uint8))
    return {"render": t1 - t0, "jpeg": time.perf_counter() - t1,
            "frame_bytes": Path(path).stat().st_size}


def generate_tree(out, n_frames=FRAMES, n_train=N_TRAIN, n_test=N_TEST,
                  seed=0, test_keyframes=TEST_KEYFRAMES,
                  size=FRAME_SIZE, workers=1) -> dict:
    """Write the tree under `out`, rendering in `workers` processes;
    returns the seconds of its parts summed over the frames (render,
    jpeg) and the byte count of the frames. A room is drawn from its own
    seed, then its camera path from the same generator."""
    out = Path(out)
    tasks, index = [], []
    for split, count, offset in (("train", n_train, 0),
                                 ("test", n_test, 1000)):
        seqs = {}
        for j in range(count):
            key = f"{split}{j:02d}{seed:04d}"
            room_seed = seed * 7919 + offset + j
            rng = np.random.default_rng(room_seed)
            SyntheticBoxDataset()._scene_indoor(rng)
            c2w = camera_path(n_frames, rng)
            timestamps = [33366 * (i + 1) for i in range(n_frames)]
            d = out / "frames" / split / key
            d.mkdir(parents=True, exist_ok=True)
            tasks += [(pose, room_seed, d / f"{ts}.jpg", size)
                      for pose, ts in zip(c2w, timestamps)]
            seqs[key] = {
                "timestamps": timestamps,
                "intrinsics": np.tile(intrinsics(), (n_frames, 1)),
                "poses": np.linalg.inv(c2w)[:, :3].astype(np.float32),
            }
            if split == "test":
                index += [f"{key} {i}\n" for i in test_keyframes]
        with open(out / f"{split}.pickle", "wb") as f:
            pickle.dump(seqs, f)
    with open(out / "test_index.txt", "w") as f:
        f.writelines(index)
    secs = {"render": 0.0, "jpeg": 0.0, "frame_bytes": 0}
    for part in pool_map(_write_frame, tasks, workers):
        for key, value in part.items():
            secs[key] += value
    return secs


def overrides(tree) -> list:
    """The command-line overrides that point a RealEstate10k config at a
    tree."""
    return [f"data.data_path={tree}",
            f"data.split_path={tree}/test_index.txt"]


def main():
    ap = argparse.ArgumentParser("synthetic RealEstate10K tree generator")
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=os.cpu_count())
    ap.add_argument("--size", type=int, nargs=2, default=FRAME_SIZE,
                    help="frame size (a cut for tests)")
    ap.add_argument("--keyframes", type=int, nargs="+",
                    default=TEST_KEYFRAMES)
    args = ap.parse_args()
    t0 = time.perf_counter()
    secs = generate_tree(args.out, args.frames, seed=args.seed,
                         test_keyframes=tuple(args.keyframes),
                         size=tuple(args.size), workers=args.workers)
    print(json.dumps({"out": args.out, **secs,
                      "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
