"""Config-driven evaluation through the port (counterpart of eval.py).

    python -m behindthescenes_tpu_torch.eval -cn <config> [key=value ...] \
        [--device cpu]

Reads configs/<config>.yaml with its `defaults` and the overrides, and
dispatches on `model`: bts (depth; `mode: nvs` adds the NVS metrics),
bts_nvs (novel-view synthesis), bts_lidar and bts_3dbb (KITTI-360 LiDAR
and 3D-box occupancy). Prints the mean metrics as one JSON line. Runs on
the card unless --device says otherwise.
"""
from __future__ import annotations

import argparse
import json

from behindthescenes_tpu_torch.config import (find_config, load_config,
                                              parse_cli_overrides)
from behindthescenes_tpu_torch.evaluation.tasks import TASKS


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
    metrics = TASKS[model](config, device=args.device)
    print(json.dumps({k: float(v) for k, v in metrics.items()}), flush=True)
    return metrics


if __name__ == "__main__":
    main()
