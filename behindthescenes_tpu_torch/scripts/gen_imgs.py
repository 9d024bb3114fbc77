"""Depth and profile images of dataset items (counterpart of the
repository's scripts/images/gen_imgs.py; reference
scripts/images/gen_imgs.py:17-108).

    python -m behindthescenes_tpu_torch.scripts.gen_imgs -cn exp_synthetic \\
        --checkpoint media/weights/synthetic_conv_step8400.npz \\
        --indices 0 1 2 [--out out/gen_imgs]

Runs on the card unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from behindthescenes_tpu_torch.datasets.factory import make_test_dataset
from behindthescenes_tpu_torch.scripts import inference_setup as iset
from behindthescenes_tpu_torch.utils.io import write_image
from behindthescenes_tpu_torch.utils.plotting import color_tensor


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-cn", "--config-name", default="exp_synthetic")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--indices", type=int, nargs="+", default=[0])
    parser.add_argument("--out", default="out/gen_imgs")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the depth's stratified jitter")
    return parser.parse_args(argv)


def main(argv=None) -> list:
    """Writes <index>_{in,depth,profile}.png under --out for each index;
    returns [(depth (h, w), profile)] as numpy arrays."""
    args = parse_args(argv)
    net, rcfg, config = iset.setup_model(
        args.config_name.replace("exp_", ""), args.checkpoint,
        config_name=args.config_name, device=args.device)
    z_near = config["model_conf"]["z_near"]
    z_far = config["model_conf"]["z_far"]
    dev = next(net.parameters()).device
    ds = make_test_dataset(config["data"])
    os.makedirs(args.out, exist_ok=True)
    out = []
    for idx in args.indices:
        item = ds[idx]
        images, poses, projs = (torch.as_tensor(item[k][None], device=dev)
                                for k in ("imgs", "poses", "projs"))
        h, w = images.shape[2:4]
        grid = net.encode(images, projs, poses, ids_encoder=[0],
                          ids_render=[0])
        depth = iset.render_depth(net, grid, rcfg, h, w, z_near, z_far,
                                  seed=args.seed)
        profile, _ = iset.render_profile(net, grid)
        write_image(os.path.join(args.out, f"{idx:06d}_in.png"),
                    np.asarray(item["imgs"][0]) * 0.5 + 0.5)
        write_image(os.path.join(args.out, f"{idx:06d}_depth.png"),
                    iset.depth_to_colormap(depth, z_near, z_far))
        write_image(os.path.join(args.out, f"{idx:06d}_profile.png"),
                    color_tensor(profile, "magma"))
        print(f"[{idx}] depth {depth.min():.2f}..{depth.max():.2f} m")
        out.append((depth, profile))
    return out


if __name__ == "__main__":
    main()
