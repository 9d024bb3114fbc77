"""Single-image depth evaluation of the flagship model through the port.

    python -m behindthescenes_tpu_torch.eval_depth \
        --weights media/weights/flagship_fast_conv.npz --scenes 4 \
        [--jitter] [--bf16] [--device cpu]

Loads a committed artifact, ray-casts the synthetic test scenes of the
JAX package's flagship depth gate (tests/test_train_fast_gate.py:36-75),
renders each keyframe's depth through the self-view path, and prints the
mean depth metrics as one JSON line. Runs on the card unless --device
says otherwise.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from behindthescenes_tpu_torch import renderer as renderer_lib
from behindthescenes_tpu_torch.datasets.synthetic import (collate,
                                                          make_test_dataset)
from behindthescenes_tpu_torch.evaluation.depth import DepthEvaluator
from behindthescenes_tpu_torch.models.bts import BTSNet
from behindthescenes_tpu_torch.platform import resolve_device
from behindthescenes_tpu_torch.weights import load_weights

# The flagship model (configs/exp_synthetic_flagship.yaml:33-77, as
# tests/test_train_fast_gate.py:40-52 writes it): ResNet-50 monodepth2,
# 64-channel latents at scale 0, a one-layer ResnetFC of width 64.
FLAGSHIP_MODEL_CONF = {
    "arch": "BTSNet", "z_near": 1.0, "z_far": 40.0, "inv_z": True,
    "learn_empty": False, "code_mode": "z",
    "code": {"num_freqs": 6, "freq_factor": 1.5, "include_input": True},
    "encoder": {"type": "monodepth2", "resnet_layers": 50,
                "num_ch_dec": (32, 32, 64, 128, 256), "d_out": 64,
                "scales": (0,)},
    "mlp_coarse": {"type": "resnet", "n_blocks": 0, "d_hidden": 64},
    "mlp_fine": {"type": "empty"},
}
# The gate's renderer: 64 coarse samples, lindisp, hard alpha cap.
FLAGSHIP_RENDERER = renderer_lib.RendererConfig(n_coarse=64, lindisp=True,
                                                hard_alpha_cap=True)
# The gate's image size and the seed of the jitter generator.
IMAGE_SIZE = (192, 640)
SEED = 0


def load_model(weights: str, model_conf: dict = FLAGSHIP_MODEL_CONF,
               bf16: bool = False, device=None) -> BTSNet:
    """BTSNet from a committed artifact, in eval mode on `device`."""
    dev = resolve_device(device)
    net = BTSNet.from_conf(model_conf, compute_dtype=torch.bfloat16
                           if bf16 else torch.float32)
    return load_weights(net, weights).to(dev).eval()


def scenes(n_scenes: int = 4) -> list:
    """The gate's first `n_scenes` synthetic test batches (numpy)."""
    ds = make_test_dataset(image_size=IMAGE_SIZE, length=64)
    return [collate([ds[i]]) for i in range(n_scenes)]


def evaluate(net: BTSNet, batches, model_conf: dict = FLAGSHIP_MODEL_CONF,
             rcfg: renderer_lib.RendererConfig = FLAGSHIP_RENDERER,
             jitter: bool = False):
    """Mean and per-scene depth metrics of `net` on `batches`."""
    dev = next(net.parameters()).device
    ev = DepthEvaluator(net, rcfg, model_conf, jitter=jitter)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    per_scene = [ev.evaluate(b, generator=gen) for b in batches]
    means = {k: float(np.mean([m[k] for m in per_scene]))
             for k in per_scene[0]}
    return means, per_scene


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--weights", default="media/weights/"
                    "flagship_fast_conv.npz")
    ap.add_argument("--scenes", type=int, default=4)
    ap.add_argument("--jitter", action="store_true",
                    help="stratified jitter per ray instead of the "
                         "deterministic shared ladder")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 compute (encoder convs and the MLP)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    net = load_model(args.weights, bf16=args.bf16, device=args.device)
    means, _ = evaluate(net, scenes(args.scenes), jitter=args.jitter)
    print(json.dumps(means))
    return means


if __name__ == "__main__":
    main()
