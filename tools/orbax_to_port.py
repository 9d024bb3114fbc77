"""Convert a checkpoint of the JAX package's training run (an orbax step
directory, `<run>/checkpoints/<step>/default/`) into a step directory of
the port's, so that the port resumes the run where JAX left it.

    JAX_PLATFORMS=cpu python3 tools/orbax_to_port.py \\
        --checkpoints RUN/checkpoints -cn exp_kitti_360 [--step N] \\
        --out PORT_RUN/checkpoints [key=value ...]

Restores the step (default: the latest) with the JAX `CheckpointManager`'s
`restore_replicated` (params, batch_stats, opt_state, step), builds the
port's trainer of the same config (`-cn`, with the overrides the JAX run
had, such as accumulate_steps) on the CPU, maps the tree with
`training/harness.py::state_from_jax`, and writes `<out>/<step>/state.pt`
and, where the run has one, `<out>/extra_<step>.json` (the render
scheduler) as it is. `python -m behindthescenes_tpu_torch.train -cn ...
output_path=PORT_RUN` (or `resume_from=<out>`) then resumes at the next
micro-step. Needs jax and orbax beside the port (the test environment);
the port itself imports neither.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def restore(checkpoints: str, step=None):
    """(step, the JAX tree as numpy arrays, extra dict or None)."""
    import jax
    import numpy as np

    from behindthescenes_tpu.training.harness import CheckpointManager

    manager = CheckpointManager(checkpoints)
    step = manager.latest_step() if step is None else step
    if step is None:
        raise FileNotFoundError(f"no orbax checkpoint in {checkpoints}")
    tree = jax.tree_util.tree_map(np.asarray,
                                  manager.restore_replicated(step))
    extra_path = os.path.join(manager.directory, f"extra_{step}.json")
    extra = None
    if os.path.exists(extra_path):
        with open(extra_path) as f:
            extra = json.load(f)
    return int(step), tree, extra


def read_config(config_name: str, overrides=()) -> dict:
    """configs/<config_name>.yaml with the overrides, as the port reads
    it."""
    from behindthescenes_tpu_torch.config import (find_config, load_config,
                                                  parse_cli_overrides)
    return load_config(find_config(config_name),
                       parse_cli_overrides(list(overrides)))


def port_trainer(config: dict):
    """The port's trainer of the config on the CPU, its parameters drawn
    (the checkpoint replaces them; no pretrained encoder is read)."""
    import copy

    import torch

    from behindthescenes_tpu_torch.training.trainer import BTSTrainer
    config = copy.deepcopy(config)
    config["model_conf"].setdefault("encoder", {})["pretrained"] = False
    trainer = BTSTrainer(config, compute_dtype=torch.float32, device="cpu")
    trainer.init_state()
    return trainer


def convert(checkpoints: str, config: dict, out: str, step=None) -> str:
    """Write the port's step directory of the JAX checkpoint of a run of
    `config`; returns it."""
    import torch

    from behindthescenes_tpu_torch.training.harness import (STATE_FILE,
                                                            state_from_jax)
    step, tree, extra = restore(checkpoints, step)
    state = state_from_jax(tree, port_trainer(config), extra)
    step_dir = os.path.join(out, str(step))
    os.makedirs(step_dir, exist_ok=True)
    torch.save(state, os.path.join(step_dir, STATE_FILE))
    if extra is not None:
        shutil.copyfile(os.path.join(os.path.abspath(checkpoints),
                                     f"extra_{step}.json"),
                        os.path.join(out, f"extra_{step}.json"))
    return step_dir


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoints", required=True,
                    help="the JAX run's checkpoints directory")
    ap.add_argument("-cn", "--config-name", required=True)
    ap.add_argument("--out", required=True,
                    help="the port's checkpoints directory to write")
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_intermixed_args(argv)
    step_dir = convert(args.checkpoints,
                       read_config(args.config_name, args.overrides),
                       args.out, args.step)
    print(json.dumps({"wrote": step_dir}), flush=True)


if __name__ == "__main__":
    main()
