"""Self-supervised training through the port.

    python -m behindthescenes_tpu_torch.train -cn NAME [key=value ...] \
        [--f32] [--device cpu]

runs the training task of configs/NAME.yaml (`model: bts` through
`training/tasks.bts_training`, `model: bts_overfit` through
`bts_overfit_training`) with the run harness, as the repository's
train.py runs the JAX package's: checkpoints, validation, the best
checkpoints and auto-resume under `output_path` (checkpoints/<step>/,
best/<step>/, best/best_value.json).

    python -m behindthescenes_tpu_torch.train --steps N [-cn NAME] \
        [key=value ...] [--f32] [--weights npz] [--out dir] [--device cpu]

is the short drive: N steps from --weights or from the port's
initialiser on the config's training batches in the loader's order
(default NAME exp_synthetic_flagship: ResNet-50, 192x640, batch 4, 2048
rays x 64 samples; exp_synthetic: ResNet-18, 48x64, batch 2, 256 rays x 24
samples), one JSON line of loss terms per step, and the parameters and
BatchNorm statistics as a Flax-keyed f32 `.npz` (DIR/params.npz) that the
JAX package's `utils/io.load_params_npz` reads.

Both compute in bf16 unless --f32, and run on the card unless --device
says otherwise.

    torchrun --nproc_per_node=N -m behindthescenes_tpu_torch.train -cn NAME

trains data parallel over N ranks, one card each (NCCL; gloo with
--device cpu): `batch_size` counts each rank's items, each rank's loader
reads its `shard_for_host` of the training set, and the step computes
the 1-rank step of the global batch (training/trainer.py). Without
torchrun the JAX package's keys `coordinator_address`, `num_processes`
and `process_id` (or `dist_init_method`) start the ranks. The short
drive runs in one process.
"""
from __future__ import annotations

import argparse
import json
import os
import time


from behindthescenes_tpu_torch.config import (find_config, load_config,
                                              parse_cli_overrides)
from behindthescenes_tpu_torch.datasets.factory import make_datasets
from behindthescenes_tpu_torch.datasets.loader import DataLoader
from behindthescenes_tpu_torch.parallel.mesh import (backend_for,
                                                     init_distributed)
from behindthescenes_tpu_torch.training import tasks
from behindthescenes_tpu_torch.training.trainer import BTSTrainer
from behindthescenes_tpu_torch.weights import save_params_npz


def config(name: str = "exp_synthetic_flagship", f32: bool = False,
           overrides=()) -> dict:
    """configs/NAME.yaml composed with the `key=value` overrides, with
    bf16 compute unless f32."""
    conf = load_config(find_config(name), parse_cli_overrides(overrides))
    conf["bf16"] = not f32
    return conf


def batches(conf: dict):
    """The training batches of the run harness, epoch after epoch: the
    loader shuffled by the config's seed (the JAX loader's order), the
    last partial batch dropped."""
    train_ds, _ = make_datasets(conf["data"])
    loader = DataLoader(train_ds, batch_size=conf["batch_size"],
                        shuffle=True, drop_last=True,
                        num_workers=conf.get("num_workers", 2),
                        seed=conf.get("seed", 0))
    epoch = 0
    while True:
        loader.set_epoch(epoch)
        yield from loader
        epoch += 1


def run_task(conf: dict, device=None):
    """The config's training task (`model`) through the run harness.
    Returns the trainer."""
    model = conf.get("model", "bts")
    if model == "bts":
        return tasks.bts_training(conf, device=device)
    if model == "bts_overfit":
        return tasks.bts_overfit_training(conf, device=device)
    raise ValueError(f"Unknown model/task: {model}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=None,
                    help="the short drive of N steps (default: the config's "
                         "training run through the harness)")
    ap.add_argument("-cn", "--config", default=None,
                    help="a training config of configs/ (the short drive's "
                         "default: exp_synthetic_flagship)")
    ap.add_argument("overrides", nargs="*", help="key=value overrides")
    ap.add_argument("--f32", action="store_true",
                    help="f32 compute (default: bf16, as the JAX trainer)")
    ap.add_argument("--weights", default=None,
                    help="initial parameters (.npz); default: the port's "
                         "initialiser")
    ap.add_argument("--out", default="out/port_train",
                    help="directory for params.npz")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_intermixed_args(argv)
    if args.steps is None:
        if args.config is None:
            ap.error("-cn NAME is required for a training run")
        conf = load_config(find_config(args.config),
                           parse_cli_overrides(args.overrides))
        if args.f32:
            conf["bf16"] = False
        rank, world = init_distributed(conf,
                                       backend=backend_for(args.device))
        if world > 1:
            print(f"multi-host: process {rank}/{world}", flush=True)
            # Each rank reads its own shard; everything the step holds the
            # same on every rank (views, flip, draws, generator state)
            # comes from the same seed, not a rank-seeded one.
            conf["data"] = dict(conf.get("data", {}),
                                host_shard=(rank, world))
        return run_task(conf, device=args.device)
    conf = config(args.config or "exp_synthetic_flagship", args.f32,
                  args.overrides)
    trainer = BTSTrainer(conf, device=args.device)
    trainer.init_state(args.weights)
    data = batches(conf)
    losses = []
    for step in range(args.steps):
        t0 = time.perf_counter()
        terms = trainer.train_step(next(data))
        terms = {k: float(v) for k, v in terms.items()}
        losses.append(terms["loss"])
        print(json.dumps({"step": step, **terms,
                          "seconds": time.perf_counter() - t0}), flush=True)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "params.npz")
    save_params_npz(path, trainer.net.state_dict(),
                    dispconv_scales=trainer.net.encoder.scales)
    print(json.dumps({"params": path, "steps": args.steps}), flush=True)
    return losses


if __name__ == "__main__":
    main()
