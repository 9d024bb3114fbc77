"""Novel-view flythrough along a camera trajectory (counterpart of the
repository's scripts/videos/gen_vid_nvs.py; reference
scripts/videos/gen_vid_nvs.py:80-135): encode one test item's keyframe,
render the scene from each trajectory pose (an .npy of (n, 4, 4)
camera-to-world matrices relative to the keyframe, such as
scripts/videos/trajectories/simple_movement.npy) through the general
path, and write the RGB and its depth side by side as a video.

    python -m behindthescenes_tpu_torch.scripts.gen_vid_nvs \\
        -cn exp_synthetic \\
        --checkpoint media/weights/synthetic_conv_step8400.npz --index 0 \\
        [--trajectory FILE.npy] [--out out/videos/nvs.avi] [key=value ...]

Runs on the card unless `--device cpu`. The video is Motion-JPEG in an
AVI container (utils/video.py), where the JAX script writes mp4v.
`key=value` arguments override the config (a tree's data paths).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from behindthescenes_tpu_torch import geometry, inference
from behindthescenes_tpu_torch.scripts import inference_setup as iset


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-cn", "--config-name", default="exp_synthetic")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--index", type=int, default=0)
    parser.add_argument("--trajectory", default=None)
    parser.add_argument("--fps", type=int, default=15)
    parser.add_argument("--out", default="out/videos/nvs.avi")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    parser.add_argument("overrides", nargs="*",
                        help="key=value overrides of the config")
    return parser.parse_intermixed_args(argv)


def default_trajectory(n=60, radius=0.5, forward=4.0) -> np.ndarray:
    """A gentle S-curve forward sweep of n poses."""
    ts = np.linspace(0, 1, n)
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, 0, 3] = radius * np.sin(2 * np.pi * ts)
    poses[:, 2, 3] = forward * ts
    return poses


@torch.no_grad()
def render_frames(args, draws=None) -> list:
    """The video's frames before encoding: for each trajectory pose, the
    rendered RGB beside its depth through the magma colormap, (h, 2w, 3)
    float in [0, 1]. `draws(i)` replays pose i's jitter and fine draws
    (inference_setup.pose_draws)."""
    net, rcfg, ds, z_near, z_far, dev = iset.setup_video(args)
    _, (images, poses, projs) = iset.load_item(ds, args.index, dev)
    h, w = images.shape[2:4]
    # The keyframe is the origin; trajectory poses are relative to it.
    grid = net.encode(images, projs, geometry.rebase_poses_to_keyframe(poses),
                      ids_encoder=[0], ids_render=[0])
    traj = np.load(args.trajectory).astype(np.float32) if args.trajectory \
        else default_trajectory()
    frames = []
    for i in range(len(traj)):
        out = inference.render_poses(
            net, grid, torch.as_tensor(traj[i:i + 1], device=dev),
            projs[0, :1], h, w, rcfg, z_near, z_far,
            **iset.pose_draws(draws, i, dev))
        rgb = np.clip(out["rgb"][0].float().cpu().numpy(), 0, 1)
        depth_img = iset.depth_to_colormap(
            out["depth"][0].float().cpu().numpy(), z_near, z_far)
        frames.append(np.concatenate([rgb, depth_img], axis=1))
        print(f"pose {i + 1}/{len(traj)}")
    return frames


def main(argv=None) -> list:
    """Renders and writes the video; returns its frames."""
    args = parse_args(argv)
    frames = render_frames(args)
    iset.save(args, frames)
    return frames


if __name__ == "__main__":
    main()
