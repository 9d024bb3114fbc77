"""Config-driven evaluation through the port (counterpart of eval.py).

    python -m behindthescenes_tpu_torch.eval -cn <config> [key=value ...] \
        [--device cpu]

Reads configs/<config>.yaml with its `defaults` and the overrides, and
dispatches on `model`: bts (depth; `mode: nvs` adds the NVS metrics),
bts_nvs (novel-view synthesis), bts_lidar and bts_3dbb (KITTI-360 LiDAR
and 3D-box occupancy). Prints the mean metrics as one JSON line. Runs on
the card unless --device says otherwise.

    torchrun --nproc_per_node=N -m behindthescenes_tpu_torch.eval -cn ...

evaluates on N ranks, one card each (NCCL; gloo with --device cpu):
every rank reads every item and renders its share of each frame's rays
(or occupancy points), so every rank holds the same metrics; rank 0
prints them. BTS_EVAL_SHARD=0 renders whole frames on
every rank.
"""
from __future__ import annotations

import argparse
import json

from behindthescenes_tpu_torch.config import (find_config, load_config,
                                              parse_cli_overrides)
from behindthescenes_tpu_torch.evaluation.tasks import TASKS
from behindthescenes_tpu_torch.parallel.mesh import (backend_for,
                                                     init_distributed)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-cn", "--config-name", required=True)
    parser.add_argument("overrides", nargs="*")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    args = parser.parse_intermixed_args(argv)
    config = load_config(find_config(args.config_name),
                         parse_cli_overrides(args.overrides))
    model = config.get("model", "bts")
    if model not in TASKS:
        raise ValueError(f"Unknown eval task: {model}")
    rank, _ = init_distributed(config, backend=backend_for(args.device))
    metrics = TASKS[model](config, device=args.device)
    if rank == 0:
        print(json.dumps({k: float(v) for k, v in metrics.items()}),
              flush=True)
    return metrics


if __name__ == "__main__":
    main()
