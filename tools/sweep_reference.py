"""The JAX package's values that `chip_smoke.py` phases 21 and 23 hold the
port to, measured on the CPU.

    JAX_PLATFORMS=cpu python3 tools/sweep_reference.py [--part nvs|demo]

`nvs` (phase 21): the means of sweep-mode NVS serving through the JAX
package's `evaluation.tasks.evaluate_nvs` for
`-cn eval_synthetic_flagship_nvs renderer.n_fine=0 renderer.n_coarse=64`
with media/weights/flagship_fast_conv.npz and `-cn
eval_synthetic_re10k_nvs renderer.n_fine=0` with re10k_synth_conv.npz,
each with sweep mode on (bf16, as the tasks run). The JAX evaluator reads
`model_conf.nvs_sweep=true` as an empty dict and then renders through
its general path (behindthescenes_tpu/evaluation/nvs.py:39-42), so the
sweep's defaults are named here: `model_conf.nvs_sweep.warp_scale=0.5`,
the default itself. Prints one JSON line per config.

`demo` (phase 23): the JAX demo's functions (scripts/inference_setup.py,
as scripts/images/gen_img_custom.py calls them) for `--img
media/example/0000.png --model kitti_raw --checkpoint
media/weights/k360_synth_conv.npz`: the BEV profile and sigma grids (180
x 180) and the depth map (192 x 640, PRNGKey(0)'s jitter), written to
media/reference/gen_img_custom_kitti_raw.npz (depth in float16) and
summarised in one JSON line. Needs JAX and OpenCV beside the port (the
test environment).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

WEIGHTS = os.path.join(ROOT, "media", "weights")
SWEEP_RUNS = (
    ("eval_synthetic_flagship_nvs", "flagship_fast_conv.npz",
     ("renderer.n_fine=0", "renderer.n_coarse=64")),
    ("eval_synthetic_re10k_nvs", "re10k_synth_conv.npz",
     ("renderer.n_fine=0",)),
)
DEMO_OUT = os.path.join(ROOT, "media", "reference",
                        "gen_img_custom_kitti_raw.npz")
DEMO_IMAGE = os.path.join(ROOT, "media", "example", "0000.png")


def nvs_means() -> None:
    from behindthescenes_tpu.config import (find_config, load_config,
                                            parse_cli_overrides)
    from behindthescenes_tpu.evaluation import tasks
    for name, ckpt, extra in SWEEP_RUNS:
        t0 = time.perf_counter()
        conf = load_config(find_config(name), parse_cli_overrides([
            f"checkpoint={os.path.join(WEIGHTS, ckpt)}",
            "model_conf.nvs_sweep.warp_scale=0.5", *extra]))
        means = {k: float(v) for k, v in tasks.evaluate_nvs(conf).items()}
        print(json.dumps({"config": name, "overrides": list(extra),
                          "means": means,
                          "seconds": time.perf_counter() - t0}), flush=True)


def demo_grids() -> None:
    import cv2
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import inference_setup as jiset
    from behindthescenes_tpu.utils.io import load_params_npz, read_image
    t0 = time.perf_counter()
    # For an .npz the JAX harness returns the file's variables; its
    # template (an eager net.init at 192x640) is not needed.
    jiset.load_eval_variables = \
        lambda config, net, batch: load_params_npz(config["checkpoint"])
    net, variables, rcfg, config = jiset.setup_model(
        "kitti_raw", os.path.join(WEIGHTS, "k360_synth_conv.npz"))
    h, w = jiset.DEFAULT_RESOLUTION["kitti_raw"]
    fx, fy = jiset.DEFAULT_INTRINSICS["kitti_raw"]
    img = cv2.resize(read_image(DEMO_IMAGE), (w, h),
                     interpolation=cv2.INTER_LINEAR)
    grid, _, _ = jiset.encode_image(net, variables, img, fx, fy)
    mc = config["model_conf"]
    depth = jiset.render_depth(net, variables, grid, rcfg, h, w,
                               mc["z_near"], mc["z_far"])
    profile, sigma = jiset.render_profile(net, variables, grid)
    os.makedirs(os.path.dirname(DEMO_OUT), exist_ok=True)
    np.savez_compressed(DEMO_OUT, profile=profile.astype(np.float32),
                        sigma=sigma.astype(np.float32),
                        depth=depth.astype(np.float16))
    print(json.dumps({"out": os.path.relpath(DEMO_OUT, ROOT),
                      "depth_median": float(np.median(depth)),
                      "visible_cells": int((profile > 0).sum()),
                      "sigma_max": float(sigma.max()),
                      "seconds": time.perf_counter() - t0}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=("nvs", "demo", "all"), default="all")
    args = ap.parse_args()
    if args.part in ("demo", "all"):
        demo_grids()
    if args.part in ("nvs", "all"):
        nvs_means()


if __name__ == "__main__":
    main()
