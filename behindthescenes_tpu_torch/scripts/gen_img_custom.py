"""The headline demo (counterpart of the repository's
scripts/images/gen_img_custom.py; reference
scripts/images/gen_img_custom.py:19-162): one image in, its expected
depth map and top-down (BEV) density profile out.

    python -m behindthescenes_tpu_torch.scripts.gen_img_custom \\
        --img media/example/0000.png --model kitti_raw \\
        --checkpoint media/weights/k360_synth_conv.npz [--out out/gen_img]

Runs on the card unless `--device cpu`. The image is resized to the
family's resolution with OpenCV's INTER_LINEAR (datasets/png.py).
"""
from __future__ import annotations

import argparse
import os

from behindthescenes_tpu_torch.datasets.png import resize_linear
from behindthescenes_tpu_torch.scripts import inference_setup as iset
from behindthescenes_tpu_torch.utils.io import read_image, write_image
from behindthescenes_tpu_torch.utils.plotting import color_tensor


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--img", required=True)
    parser.add_argument("--model", default="kitti_raw",
                        choices=list(iset.DEFAULT_RESOLUTION))
    parser.add_argument("--checkpoint", default=None,
                        help="a committed .npz, a run or step directory, "
                        "or a reference .pt (default: random init)")
    parser.add_argument("--out", default="out/gen_img")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the depth's stratified jitter")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """Writes <name>_{in,depth,profile}.png under --out; returns the
    input, depth (h, w), profile and sigma grids as numpy arrays."""
    args = parse_args(argv)
    net, rcfg, config = iset.setup_model(args.model, args.checkpoint,
                                         device=args.device)
    z_near = config["model_conf"]["z_near"]
    z_far = config["model_conf"]["z_far"]
    h, w = iset.DEFAULT_RESOLUTION[args.model]
    fx, fy = iset.DEFAULT_INTRINSICS[args.model]

    img = resize_linear(read_image(args.img), (h, w))
    grid = iset.encode_image(net, img, fx, fy)
    depth = iset.render_depth(net, grid, rcfg, h, w, z_near, z_far,
                              seed=args.seed)
    profile, sigma = iset.render_profile(net, grid)

    name = os.path.splitext(os.path.basename(args.img))[0]
    os.makedirs(args.out, exist_ok=True)
    write_image(os.path.join(args.out, f"{name}_in.png"), img)
    write_image(os.path.join(args.out, f"{name}_depth.png"),
                iset.depth_to_colormap(depth, z_near, z_far))
    write_image(os.path.join(args.out, f"{name}_profile.png"),
                color_tensor(profile, "magma"))
    print(f"depth range: {depth.min():.2f}..{depth.max():.2f} m")
    print(f"wrote {args.out}/{name}_{{in,depth,profile}}.png")
    return {"img": img, "depth": depth, "profile": profile, "sigma": sigma}


if __name__ == "__main__":
    main()
