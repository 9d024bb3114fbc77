"""The JAX package's means of `-cn eval_kitti_360_depth` and `-cn
eval_kitti_360_nvs` on the synthetic KITTI-360 gate drive, measured on
the CPU: the references that `chip_smoke.py` phase 27 holds the port's
task runner to (`K360_EVAL_RUNS`).

    JAX_PLATFORMS=cpu python3 tools/k360_eval_reference.py [--tree DIR]

Builds the drive of phases 14-16 with the port's generator and
preprocessor (`make_gate_tree`: 34 frames, 4 test keyframes, the
perspective and fisheye frames at 192x640, fisheye rotation [0, -15])
unless --tree names one, then runs the JAX package's
`evaluation.tasks.evaluate_depth` and `evaluate_nvs` on the two configs
with media/weights/k360_synth_conv.npz and the tree's paths, as `python
eval.py -cn <config> checkpoint=<npz> data.data_path=<tree> ...` does
(192x640, 64 samples, bf16), on the configs named (default both).
Prints one JSON line with each config's means, its metrics keyframe by
keyframe and its seconds. Needs JAX beside the port (the test
environment).

    JAX_PLATFORMS=cpu python3 tools/k360_eval_reference.py \
        eval_kitti_360_depth
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
FISHEYE_ROTATION = (0, -15)
CONFIGS = {"eval_kitti_360_depth": "evaluate_depth",
           "eval_kitti_360_nvs": "evaluate_nvs"}


def tree_overrides(tree: str, split: str = "splits") -> list:
    """The data paths of the command on a gate drive."""
    return [f"data.data_path={tree}",
            f"data.pose_path={os.path.join(tree, 'data_poses')}",
            f"data.split_path={os.path.join(tree, split)}"]


def jax_means(name: str, overrides) -> tuple:
    """The JAX task runner's means of config `name` with the overrides
    (and the checkpoint, one loader thread), and each keyframe's
    metrics: (means, [metrics])."""
    from behindthescenes_tpu.config import (find_config, load_config,
                                            parse_cli_overrides)
    from behindthescenes_tpu.evaluation import tasks
    from behindthescenes_tpu.evaluation.depth import DepthEvaluator
    from behindthescenes_tpu.evaluation.nvs import NVSEvaluator
    conf = load_config(find_config(name), parse_cli_overrides(
        [f"checkpoint={WEIGHTS}", "num_workers=0", *overrides]))
    cls = {"evaluate_depth": DepthEvaluator,
           "evaluate_nvs": NVSEvaluator}[CONFIGS[name]]
    evaluate, per_keyframe = cls.evaluate, []

    def recorder(self, *args, **kwargs):
        out = evaluate(self, *args, **kwargs)
        per_keyframe.append({k: float(v) for k, v in out.items()})
        return out
    cls.evaluate = recorder
    try:
        means = getattr(tasks, CONFIGS[name])(conf)
    finally:
        cls.evaluate = evaluate
    return {k: float(v) for k, v in means.items()}, per_keyframe


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None)
    ap.add_argument("configs", nargs="*", default=list(CONFIGS),
                    help=f"of {', '.join(CONFIGS)} (default both)")
    args = ap.parse_args()
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="k360_eval_") as tmp:
        tree = args.tree
        if tree is None:
            from behindthescenes_tpu_torch.datasets.gen_synthetic_kitti_360 \
                import make_gate_tree
            tree = make_gate_tree(os.path.join(tmp, "tree"),
                                  fisheye_rotation=FISHEYE_ROTATION)
        out["tree_seconds"] = time.perf_counter() - t0
        for name in args.configs:
            t = time.perf_counter()
            means, per_keyframe = jax_means(name, tree_overrides(str(tree)))
            out[name] = {"means": means, "per_keyframe": per_keyframe,
                         "seconds": time.perf_counter() - t}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
