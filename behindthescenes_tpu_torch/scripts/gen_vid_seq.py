"""Depth and profile video over a range of test items (counterpart of the
repository's scripts/videos/gen_vid_seq.py; reference
scripts/videos/gen_vid_seq.py:21-150): for each item its input, its
depth (the jittered self-view at bf16, through the jitter_density
kernel on the card) and its top-down density profile resized to the
frame, side by side.

    python -m behindthescenes_tpu_torch.scripts.gen_vid_seq \\
        -cn exp_synthetic \\
        --checkpoint media/weights/synthetic_conv_step8400.npz \\
        --from-idx 0 --to-idx 16 [--out out/videos/seq.avi]

Runs on the card unless `--device cpu`; writes Motion-JPEG in an AVI
(utils/video.py) where the JAX script writes mp4v; `key=value`
arguments override the config.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from behindthescenes_tpu_torch.datasets.png import resize_linear
from behindthescenes_tpu_torch.scripts import inference_setup as iset
from behindthescenes_tpu_torch.utils.plotting import color_tensor


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-cn", "--config-name", default="exp_synthetic")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--from-idx", type=int, default=0)
    parser.add_argument("--to-idx", type=int, default=16)
    parser.add_argument("--fps", type=int, default=10)
    parser.add_argument("--out", default="out/videos/seq.avi")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    parser.add_argument("overrides", nargs="*",
                        help="key=value overrides of the config")
    return parser.parse_intermixed_args(argv)


@torch.no_grad()
def render_frames(args, z_samp=None) -> list:
    """The video's frames before encoding, (h, 3w, 3) float in [0, 1]:
    input, depth through the magma colormap, and the BEV profile through
    it resized to (h, w) as cv2.resize does (png.resize_linear, float64).
    Item idx's depth draws its jitter from a generator seeded with idx
    (the JAX script's PRNGKey(idx)), or takes `z_samp(idx)` (h*w, K)."""
    net, rcfg, ds, z_near, z_far, dev = iset.setup_video(args)
    frames = []
    for idx in range(args.from_idx, min(args.to_idx, len(ds))):
        item, (images, poses, projs) = iset.load_item(ds, idx, dev)
        h, w = images.shape[2:4]
        grid = net.encode(images, projs, poses, ids_encoder=[0],
                          ids_render=[0])
        depth = iset.render_depth(
            net, grid, rcfg, h, w, z_near, z_far, seed=idx,
            z_samp=None if z_samp is None else z_samp(idx))
        profile, _ = iset.render_profile(net, grid)
        # Released before the next item's encode, which can then replay
        # the encoder's graph over these features (BTSNet.encode).
        del grid
        rgb = np.asarray(item["imgs"][0]) * 0.5 + 0.5
        depth_img = iset.depth_to_colormap(depth, z_near, z_far)
        prof_img = resize_linear(color_tensor(profile, "magma"), (h, w))
        frames.append(np.concatenate([rgb, depth_img, prof_img], axis=1))
        print(f"frame {idx}")
    return frames


def main(argv=None) -> list:
    """Renders and writes the video; returns its frames."""
    args = parse_args(argv)
    frames = render_frames(args)
    iset.save(args, frames)
    return frames


if __name__ == "__main__":
    main()
