"""Self-supervised training of the synthetic-scene models through the port.

    python -m behindthescenes_tpu_torch.train --steps N [--config NAME] \
        [--f32] [--weights npz] [--out dir] [--device cpu]

NAME is exp_synthetic_flagship (the default: ResNet-50, 192x640, batch 4,
2048 rays x 64 samples) or exp_synthetic (ResNet-18, 48x64, batch 2, 256
rays x 24 samples); each built-in config mirrors configs/NAME.yaml merged
over configs/default.yaml and configs/data/synthetic.yaml (reading the
YAML files themselves waits for the port's config loader). Trains from
--weights or from the port's initialiser, in bf16 compute unless --f32,
prints one JSON line of loss terms per step, and writes the parameters
and BatchNorm statistics as a Flax-keyed f32 `.npz` (DIR/params.npz) that
the JAX package's `utils/io.load_params_npz` reads. Runs on the card
unless --device says otherwise.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import time

import numpy as np

from behindthescenes_tpu_torch.datasets.factory import make_datasets
from behindthescenes_tpu_torch.datasets.synthetic import collate
from behindthescenes_tpu_torch.training.trainer import BTSTrainer
from behindthescenes_tpu_torch.weights import save_params_npz

_LOSS = {"criterion": "l1+ssim", "invalid_policy": "weight_guided",
         "lambda_edge_aware_smoothness": 0.001}
_COMMON_MODEL = {
    "arch": "BTSNet", "prediction_mode": "default",
    "code": {"num_freqs": 6, "freq_factor": 1.5, "include_input": True},
    "mlp_fine": {"type": "empty"}, "z_near": 1, "z_far": 40, "inv_z": True,
    "n_frames_render": 2, "frame_sample_mode": "default",
    "sample_mode": "patch", "flip_augmentation": False,
    "learn_empty": False, "code_mode": "z",
}
CONFIGS = {
    # configs/exp_synthetic_flagship.yaml
    "exp_synthetic_flagship": {
        "seed": 0, "batch_size": 4, "learning_rate": 1.0e-4,
        "data": {"type": "Synthetic", "image_size": (192, 640),
                 "data_fc": 2, "length": 64},
        "model_conf": dict(
            _COMMON_MODEL,
            encoder={"type": "monodepth2", "resnet_layers": 50,
                     "num_ch_dec": (32, 32, 64, 128, 256), "d_out": 64,
                     "scales": (0,)},
            mlp_coarse={"type": "resnet", "n_blocks": 0, "d_hidden": 64},
            patch_size=8, ray_batch_size=2048),
        "loss": _LOSS, "scheduler": {"type": "fix"},
        "renderer": {"n_coarse": 64, "n_fine": 0, "lindisp": True,
                     "hard_alpha_cap": True},
    },
    # configs/exp_synthetic.yaml
    "exp_synthetic": {
        "seed": 0, "batch_size": 2, "learning_rate": 1.0e-4,
        "data": {"type": "Synthetic", "image_size": (48, 64),
                 "data_fc": 2, "length": 64},
        "model_conf": dict(
            _COMMON_MODEL,
            encoder={"type": "monodepth2", "resnet_layers": 18,
                     "num_ch_dec": (16, 16, 32, 32, 64), "d_out": 16,
                     "scales": (0,)},
            mlp_coarse={"type": "resnet", "n_blocks": 0, "d_hidden": 32},
            patch_size=4, ray_batch_size=256),
        "loss": _LOSS, "scheduler": {"type": "fix"},
        "renderer": {"n_coarse": 24, "n_fine": 0, "lindisp": True,
                     "hard_alpha_cap": True},
    },
}


def config(name: str = "exp_synthetic_flagship", f32: bool = False) -> dict:
    conf = copy.deepcopy(CONFIGS[name])
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
    ap.add_argument("--config", default="exp_synthetic_flagship",
                    choices=sorted(CONFIGS))
    ap.add_argument("--f32", action="store_true",
                    help="f32 compute (default: bf16, as the JAX trainer)")
    ap.add_argument("--weights", default=None,
                    help="initial parameters (.npz); default: the port's "
                         "initialiser")
    ap.add_argument("--out", default="out/port_train",
                    help="directory for params.npz")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    conf = config(args.config, args.f32)
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
