"""Camera sweep from the input view to a top-down view (counterpart of
the repository's scripts/videos/gen_vid_transition.py; reference
scripts/videos/gen_vid_transition.py:22-186): the poses between the
keyframe's camera and a bird's-eye pose (rotations on the shortest arc,
translations linear), each rendered through the general path with its
invalid rays greyed out, written as a video.

    python -m behindthescenes_tpu_torch.scripts.gen_vid_transition \\
        -cn exp_synthetic \\
        --checkpoint media/weights/synthetic_conv_step8400.npz --index 0 \\
        [--n-frames 40] [--out out/videos/transition.avi]

Runs on the card unless `--device cpu`; writes Motion-JPEG in an AVI
(utils/video.py) where the JAX script writes mp4v; `key=value`
arguments override the config.
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
    parser.add_argument("--n-frames", type=int, default=40)
    parser.add_argument("--height", type=float, default=8.0)
    parser.add_argument("--forward", type=float, default=10.0)
    parser.add_argument("--fps", type=int, default=15)
    parser.add_argument("--out", default="out/videos/transition.avi")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    parser.add_argument("overrides", nargs="*",
                        help="key=value overrides of the config")
    return parser.parse_intermixed_args(argv)


def interpolate_poses(pose_a, pose_b, n: int) -> np.ndarray:
    """n float32 camera-to-world poses from pose_a to pose_b: the rotation
    by slerp (geometry.slerp_rotations, scipy's Slerp), the translation
    linear."""
    ts = np.linspace(0, 1, n)
    out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    out[:, :3, :3] = geometry.slerp_rotations(pose_a[:3, :3],
                                              pose_b[:3, :3], ts)
    out[:, :3, 3] = (1 - ts)[:, None] * pose_a[:3, 3] \
        + ts[:, None] * pose_b[:3, 3]
    return out


def topdown_pose(height: float, forward: float) -> np.ndarray:
    """The bird's-eye pose looking at the scene's centre from above."""
    return geometry.look_at(origin=[0.0, -height, forward * 0.3],
                            target=[0.0, 0.0, forward * 0.6],
                            world_up=[0, 0, 1])


@torch.no_grad()
def render_frames(args, draws=None) -> list:
    """The video's frames before encoding, (h, w, 3) float in [0, 1]: the
    rendered RGB with each pixel's invalid share blended to grey.
    `draws(i)` replays pose i's draws (inference_setup.pose_draws)."""
    net, rcfg, ds, z_near, z_far, dev = iset.setup_video(args)
    _, (images, poses, projs) = iset.load_item(ds, args.index, dev)
    h, w = images.shape[2:4]
    grid = net.encode(images, projs, geometry.rebase_poses_to_keyframe(poses),
                      ids_encoder=[0], ids_render=[0])
    traj = interpolate_poses(np.eye(4, dtype=np.float32),
                             topdown_pose(args.height, args.forward),
                             args.n_frames)
    frames = []
    for i, pose in enumerate(traj):
        out = inference.render_poses(
            net, grid, torch.as_tensor(pose[None], device=dev), projs[0, :1],
            h, w, rcfg, z_near, z_far, **iset.pose_draws(draws, i, dev))
        rgb = np.clip(out["rgb"][0].float().cpu().numpy(), 0, 1)
        invalid = out["invalid"][0].float().cpu().numpy()[..., None]
        frames.append(rgb * (1 - invalid) + 0.5 * invalid)
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
