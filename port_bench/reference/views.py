"""Which views a training step encodes, renders and takes its loss on, as
the published trainer picks them from one numpy generator per run (one
permutation a step): the "kitti360-mono" and "default" frame-sample
modes of the benchmark's configurations. The encoder view is always 0.
"""
from __future__ import annotations

import numpy as np


def select_views(rng: np.random.Generator, v: int, frames_render,
                 mode: str) -> dict:
    """{"render": [...], "loss": [...]} view indices of one step."""
    perm = rng.permutation(v)
    if mode == "kitti360-mono":
        steps = v // 4
        start = 0 if perm[0] < v // 2 else 1
        loss, render = [], []
        for cam in range(4):
            loss += [cam * steps + i for i in range(start, steps, 2)]
            render += [cam * steps + i for i in range(1 - start, steps, 2)]
            start = 1 - start
        return {"render": render, "loss": loss}
    if mode == "default":
        render = sorted(int(perm[i]) for i in frames_render if i < v)
        loss = [int(perm[i]) for i in range(v) if perm[i] not in render]
        return {"render": render, "loss": loss}
    raise NotImplementedError(mode)
