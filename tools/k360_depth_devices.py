"""The port's `-cn eval_kitti_360_depth` on the gate drive of
`chip_smoke.py` phase 27, on the card and on the host's CPU, keyframe by
keyframe: each keyframe's metrics on both devices and how far the two
depth maps lie apart. It tells what the card's arithmetic moves from
what separates the port from the JAX package, whose CPU metrics
`tools/k360_eval_reference.py` prints keyframe by keyframe.

    python3 tools/k360_depth_devices.py [--tree DIR]

Builds the drive (`make_gate_tree`, the fisheye frames at rotation
[0, -15], as phase 27's) unless --tree names one, then runs the config
through the port's task runner (chip_smoke.config_eval) with
media/weights/k360_synth_conv.npz on the card and then on the CPU, at
full size (192x640, 64 samples, bf16). Prints one JSON line: each
device's means, per-keyframe metrics and seconds, and for each keyframe
the two depth maps apart (the largest and the mean relative difference,
and the share of pixels more than 1e-3 apart).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CONFIG = "eval_kitti_360_depth"
DEVICES = ("cuda", "cpu")
FISHEYE_ROTATION = (0, -15)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(cs, dev: str, overrides) -> dict:
    """The config on `dev`: means, per-keyframe metrics, the keyframes'
    depth maps (float32 numpy) and the seconds."""
    from behindthescenes_tpu_torch.evaluation.depth import DepthEvaluator
    render, depths = DepthEvaluator.render, []

    def recorder(self, *args, **kwargs):
        depth = render(self, *args, **kwargs)
        depths.append(depth.float().cpu().numpy())
        return depth
    DepthEvaluator.render = recorder
    t = time.perf_counter()
    try:
        _, means, calls = cs.config_eval(CONFIG, cs.K360_WEIGHTS, dev,
                                         overrides)
    finally:
        DepthEvaluator.render = render
    return {"means": {k: float(v) for k, v in means.items()},
            "per_keyframe": [out for _, _, out in calls],
            "depths": depths, "seconds": time.perf_counter() - t}


def apart(a: np.ndarray, b: np.ndarray) -> dict:
    """Two depth maps' relative difference against b."""
    rel = np.abs(a.astype(np.float64) - b) / np.maximum(np.abs(b), 1e-6)
    return {"max_rel": float(rel.max()), "mean_rel": float(rel.mean()),
            "share_over_1e-3": float(np.mean(rel > 1e-3))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None)
    args = ap.parse_args()
    cs = _chip_smoke()
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="k360_depth_") as tmp:
        tree = args.tree
        if tree is None:
            from behindthescenes_tpu_torch.datasets.gen_synthetic_kitti_360 \
                import make_gate_tree
            tree = make_gate_tree(os.path.join(tmp, "tree"),
                                  fisheye_rotation=FISHEYE_ROTATION)
        out["tree_seconds"] = time.perf_counter() - t0
        overrides = cs.gate_tree_overrides(str(tree))
        runs = {dev: run(cs, dev, overrides) for dev in DEVICES}
    out["depth_cuda_vs_cpu"] = [
        apart(x, y) for x, y in zip(*(runs[d]["depths"] for d in DEVICES))]
    for dev, res in runs.items():
        res.pop("depths")
        out[dev] = res
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
