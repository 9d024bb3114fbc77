"""Weights from the seed, on the device, in a few large calls.

Every tensor of `reference.model.param_specs` is cut from one standard
normal draw of the total size (one call to a generator on the device,
seeded with the run's seed) and scaled by its kind; BatchNorm starts at
scale 1, shift 0, running mean 0 and variance 1. The same seed on the
same device gives the same weights, so the reference can make them again
after the window instead of keeping a copy.
"""
from __future__ import annotations

import math

import torch

from port_bench.reference.model import param_specs


def _std(shape, kind: str) -> float:
    if kind == "conv_he":       # normal, variance 2 / fan_out
        return math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
    if kind == "conv":          # variance 1 / fan_in
        return math.sqrt(1.0 / (shape[1] * shape[2] * shape[3]))
    if kind == "lin":           # variance 2 / fan_in
        return math.sqrt(2.0 / shape[1])
    if kind == "bias":
        return 0.01
    return 0.0


def make_weights(model_conf: dict, seed: int, device) -> dict:
    """{name: tensor} of the model, float32 (the BatchNorm counts int64),
    drawn from `seed` on `device`."""
    specs = param_specs(model_conf)
    drawn = [(n, s, k) for n, s, k in specs if _std(s, k) > 0]
    total = sum(math.prod(s) for _, s, _ in drawn)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, offset = {}, 0
    for name, shape, kind in specs:
        std = _std(shape, kind)
        if std > 0:
            size = math.prod(shape)
            out[name] = flat[offset:offset + size].view(shape) * std
            offset += size
        elif kind == "bn_count":
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
        elif kind in ("bn_w", "bn_var"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out

