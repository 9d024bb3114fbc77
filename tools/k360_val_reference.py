"""The JAX package's validation means of the exp_kitti_360 training run on
the synthetic KITTI-360 gate drive, measured on the CPU: the reference that
`chip_smoke.py` phase 16 holds the port's `run_validation` to.

    JAX_PLATFORMS=cpu python3 tools/k360_val_reference.py [--tree DIR]

Builds the gate drive with the port's generator and preprocessor
(`make_gate_tree`, perspective and fisheye frames at 192x640, fisheye
rotation [0, -15]; the same files as the JAX scripts write) unless --tree
names one, then runs the JAX package's `training.harness.run_validation`
over the test loader of `training.tasks.bts_get_dataflow` for
configs/exp_kitti_360.yaml with the tree's paths, its trainer's defaults
(bf16) and the parameters of media/weights/k360_synth_conv.npz. Prints
one JSON line with the means and the seconds it took. Needs JAX beside
the port (the test environment).
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


def overrides(tree: str) -> dict:
    """The data paths of the command, as nested overrides."""
    return {"data": {"data_path": tree,
                     "pose_path": os.path.join(tree, "data_poses"),
                     "split_path": os.path.join(tree, "splits")}}


def jax_means(tree: str) -> dict:
    import jax.numpy as jnp

    from behindthescenes_tpu.config import find_config, load_config
    from behindthescenes_tpu.training.harness import run_validation
    from behindthescenes_tpu.training.tasks import bts_get_dataflow
    from behindthescenes_tpu.training.trainer import BTSTrainer, TrainState
    from behindthescenes_tpu.utils.io import load_params_npz

    config = load_config(find_config("exp_kitti_360"), overrides(tree))
    config["num_workers"] = 0
    trainer = BTSTrainer(config)
    variables = load_params_npz(WEIGHTS)
    state = TrainState(params=variables["params"],
                       batch_stats=variables.get("batch_stats", {}),
                       opt_state={}, step=jnp.asarray(0))
    _, val_loader, _ = bts_get_dataflow(config)
    return run_validation(trainer, state, val_loader)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None)
    args = ap.parse_args()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="k360_val_") as tmp:
        tree = args.tree
        if tree is None:
            from behindthescenes_tpu_torch.datasets.gen_synthetic_kitti_360 \
                import make_gate_tree
            tree = make_gate_tree(os.path.join(tmp, "tree"),
                                  fisheye_rotation=FISHEYE_ROTATION)
        t1 = time.perf_counter()
        means = jax_means(str(tree))
    print(json.dumps({"means": means, "tree_seconds": t1 - t0,
                      "validation_seconds": time.perf_counter() - t1}),
          flush=True)


if __name__ == "__main__":
    main()
