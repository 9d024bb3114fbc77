"""Self-supervised training of the synthetic-scene models through the port.

    python -m behindthescenes_tpu_torch.train --steps N [-cn NAME] \
        [key=value ...] [--f32] [--weights npz] [--out dir] [--device cpu]

NAME is a training config of configs/ (default exp_synthetic_flagship:
ResNet-50, 192x640, batch 4, 2048 rays x 64 samples; exp_synthetic:
ResNet-18, 48x64, batch 2, 256 rays x 24 samples), read with its
`defaults` and the overrides by the port's config loader. Trains from
--weights or from the port's initialiser, in bf16 compute unless --f32,
prints one JSON line of loss terms per step, and writes the parameters
and BatchNorm statistics as a Flax-keyed f32 `.npz` (DIR/params.npz) that
the JAX package's `utils/io.load_params_npz` reads. Runs on the card
unless --device says otherwise.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from behindthescenes_tpu_torch.config import (find_config, load_config,
                                              parse_cli_overrides)
from behindthescenes_tpu_torch.datasets.factory import make_datasets
from behindthescenes_tpu_torch.datasets.synthetic import collate
from behindthescenes_tpu_torch.training.trainer import BTSTrainer
from behindthescenes_tpu_torch.weights import save_params_npz


def config(name: str = "exp_synthetic_flagship", f32: bool = False,
           overrides=()) -> dict:
    """configs/NAME.yaml composed with the `key=value` overrides, with
    bf16 compute unless f32."""
    conf = load_config(find_config(name), parse_cli_overrides(overrides))
    conf["bf16"] = not f32
    return conf


def batches(conf: dict, rng: np.random.Generator):
    """Shuffled training batches of `batch_size` items, epoch after epoch
    (the JAX loader's drop_last order is not reproduced)."""
    train_ds, _ = make_datasets(conf["data"])
    bs = conf["batch_size"]
    while True:
        order = rng.permutation(len(train_ds))
        for lo in range(0, len(order) - bs + 1, bs):
            yield collate([train_ds[int(i)] for i in order[lo:lo + bs]])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, required=True)
    ap.add_argument("-cn", "--config", default="exp_synthetic_flagship",
                    help="a training config of configs/")
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
    conf = config(args.config, args.f32, args.overrides)
    trainer = BTSTrainer(conf, device=args.device)
    trainer.init_state(args.weights)
    data = batches(conf, np.random.default_rng(conf["seed"]))
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
