"""The JAX package's side of `chip_smoke.py` phase 25, measured on the
CPU: the hashes of the trees and of the loaders' first items, and the
depth means that the port's runs on the card are held to.

    JAX_PLATFORMS=cpu python3 tools/extra_data_reference.py [--trees DIR]

Builds the KITTI odometry sequence and the Waymo drive with the port's
generators (`datasets/gen_synthetic_kitti_odom.py`,
`gen_synthetic_waymo.py`) unless --trees names a directory that holds
them (as kitti_odom/ and waymo/), hashes each tree's files
(`chip_smoke.tree_digest`) and the first two items of each loader of
`chip_smoke.EXTRA_LOADERS` made by the JAX package's datasets (OpenCV
and h5py read the frames and the NYU fixture there), then runs the JAX
package's `evaluation.tasks.evaluate_depth` on configs/eval_depth.yaml
with media/weights/k360_synth_conv.npz for each run of
`chip_smoke.EXTRA_EVALS` (192x640, 64 samples, bf16). Prints one JSON
line: the value of `chip_smoke.EXTRA_REFERENCE`, and the seconds. Needs
JAX beside the port (the test environment).
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

import chip_smoke as cs  # noqa: E402

WEIGHTS = os.path.join(ROOT, cs.K360_WEIGHTS)


def jax_loader_digests(tree_over: dict, extra=()) -> dict:
    from behindthescenes_tpu.config import (find_config, load_config,
                                            parse_cli_overrides)
    from behindthescenes_tpu.datasets.factory import make_datasets
    from behindthescenes_tpu_torch.datasets.loader import item_digest
    out = {}
    for name, tree, config, over, split in cs.EXTRA_LOADERS:
        over = [*(tree_over[tree] if tree else ()), *over, *extra]
        conf = load_config(find_config(config), parse_cli_overrides(over))
        ds = make_datasets(conf["data"])[split]
        out[name] = [item_digest(ds[i]) for i in range(2)]
    return out


def jax_means(tree_over: dict) -> dict:
    from behindthescenes_tpu.config import (find_config, load_config,
                                            parse_cli_overrides)
    from behindthescenes_tpu.evaluation import tasks
    out = {}
    for run, tree, extra in cs.EXTRA_EVALS:
        conf = load_config(find_config("eval_depth"), parse_cli_overrides(
            [f"checkpoint={WEIGHTS}", "num_workers=0",
             *(tree_over[tree] if tree else ()), *extra]))
        out[run] = {k: float(v) for k, v in tasks.evaluate_depth(conf)
                    .items() if k in ("abs_rel", "a1")}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", default=None)
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args()
    os.chdir(ROOT)          # the NYU fixture's path is relative
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="extra_ref_") as tmp:
        base = args.trees or tmp
        tree_over, trees = {}, {}
        for key, module in cs.EXTRA_TREES.items():
            gen = cs._generator(module)
            tree = os.path.join(base, key)
            if args.trees is None:
                gen.generate_tree(tree, workers=args.workers)
            trees[key] = cs.tree_digest(tree)
            tree_over[key] = gen.overrides(tree)
        t1 = time.perf_counter()
        loaders = jax_loader_digests(tree_over)
        t2 = time.perf_counter()
        means = jax_means(tree_over)
    print(json.dumps({"reference": {"trees": trees, "loaders": loaders,
                                    "means": means},
                      "tree_seconds": t1 - t0, "loader_seconds": t2 - t1,
                      "eval_seconds": time.perf_counter() - t2}), flush=True)


if __name__ == "__main__":
    main()
