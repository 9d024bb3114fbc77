"""The JAX package's means of the KITTI raw depth benchmark on the port's
synthetic KITTI raw drive, measured on the CPU: the reference that
`chip_smoke.py` phase 18 holds the port's `-cn eval_depth` to.

    JAX_PLATFORMS=cpu python3 tools/kitti_raw_reference.py [--tree DIR]

Builds the drive with the port's generator
(`datasets/gen_synthetic_kitti_raw.generate_tree`: 20 frames at
375x1242, eight test keyframes, frames written by the port's JPEG
writer) unless --tree names one, then runs the JAX package's
`evaluation.tasks.evaluate_depth` on configs/eval_depth.yaml with
media/weights/k360_synth_conv.npz and the tree's paths, as `python
eval.py -cn eval_depth checkpoint=<npz> data.data_path=<tree> ...` does
(192x640, 64 samples, bf16, the velodyne ground truth of the C++
projector). OpenCV decodes the JPEG frames there. Prints one JSON line
with the means and the seconds. Needs JAX beside the port (the test
environment).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

WEIGHTS = os.path.join(ROOT, "media", "weights", "k360_synth_conv.npz")


def jax_means(tree: str) -> dict:
    from behindthescenes_tpu.config import (find_config, load_config,
                                            parse_cli_overrides)
    from behindthescenes_tpu.evaluation import tasks
    from behindthescenes_tpu_torch.datasets.gen_synthetic_kitti_raw import \
        overrides
    conf = load_config(find_config("eval_depth"), parse_cli_overrides(
        [f"checkpoint={WEIGHTS}", "num_workers=0", *overrides(tree)]))
    return {k: float(v) for k, v in tasks.evaluate_depth(conf).items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None)
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="kitti_raw_ref_") as tmp:
        tree = args.tree
        if tree is None:
            from behindthescenes_tpu_torch.datasets.gen_synthetic_kitti_raw \
                import generate_tree
            tree = os.path.join(tmp, "tree")
            generate_tree(tree, workers=args.workers)
        t1 = time.perf_counter()
        means = jax_means(tree)
    print(json.dumps({"means": means, "tree_seconds": t1 - t0,
                      "eval_seconds": time.perf_counter() - t1}), flush=True)


if __name__ == "__main__":
    main()
