"""How far the f32 train step of the card and of the host CPU each sit from
the exact step.

    python3 tools/train_precision.py        # from the repo root, on the card

Runs one step of chip_smoke.py's training setup (the flagship config,
media/weights/flagship_fast_conv.npz, 4 synthetic items at 192x640,
numpy-seeded draws) three times: in f32 on the card, in f32 on the host
CPU, and in float64 on the card (parameters, inputs and compute), the
last standing for the exact step. Prints one JSON line per f32 run: the
loss's relative deviation from the float64 step's, and per parameter
tensor (norm above 1e-6 of the largest) the relative deviation of its
gradient norm, the count above 1e-4 and 1e-3, and the five largest.
Needs one CUDA device. A diagnostic for PERF.md: it says which side of
chip_smoke.py's phase 7 is the less exact.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def step(cs, conf, batch, draws, dev, dtype):
    trainer = cs.make_trainer(conf, os.path.join(ROOT, cs.WEIGHTS), dev,
                              dtype)
    tb, td = cs.on_device(batch, draws, dev, dtype)
    loss = float(trainer.train_step(tb, td)["loss"])
    return loss, {n: p.grad.double().norm().item()
                  for n, p in trainer.net.named_parameters()}


def main():
    import chip_smoke as cs
    from behindthescenes_tpu_torch import train as train_cli
    if not torch.cuda.is_available():
        raise SystemExit("train_precision: no CUDA device found")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    conf = train_cli.config(cs.TRAIN_CONFIG)
    batch = cs.train_batch(conf)
    draws = cs.numpy_draws(conf, batch, cs.TRAIN_SEED)
    exact_loss, exact = step(cs, conf, batch, draws, "cuda", torch.float64)
    floor = 1e-6 * max(exact.values())
    for dev in ("cuda", "cpu"):
        loss, norms = step(cs, conf, batch, draws, dev, torch.float32)
        devs = sorted(((abs(norms[k] - v) / v, k) for k, v in exact.items()
                       if v > floor), reverse=True)
        print(json.dumps({
            "card": card, "f32_on": dev,
            "loss_rel": abs(loss - exact_loss) / abs(exact_loss),
            "tensors": len(devs),
            "above_1e-4": sum(d > 1e-4 for d, _ in devs),
            "above_1e-3": sum(d > 1e-3 for d, _ in devs),
            "largest": devs[:5]}), flush=True)


if __name__ == "__main__":
    main()
