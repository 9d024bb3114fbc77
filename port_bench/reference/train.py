"""The reference's training steps: the first micro-steps of a run followed
in plain PyTorch from the same weights, batches, view choices and draws,
with gradient accumulation as the published trainer does it (the running
mean of the micro-steps' gradients; Adam on every `accumulate_steps`-th).
"""
from __future__ import annotations

import numpy as np
import torch

from port_bench.reference.model import adam_step, param_specs, train_loss
from port_bench.reference.precision import Precision
from port_bench.reference.views import select_views


def leaf_norms(tensors: dict, names) -> torch.Tensor:
    """(len(names),) float64 norms of the named tensors."""
    return torch.stack([tensors[n].detach().double().norm() for n in names])


def view_ids(conf: dict, seed: int, steps: int, v: int) -> list:
    """The views of the first `steps` micro-steps of a run seeded with
    `seed` (one permutation a step from numpy's generator)."""
    rng = np.random.default_rng(seed)
    mc = conf["model_conf"]
    return [select_views(rng, v, list(range(mc["n_frames_render"])),
                         mc["frame_sample_mode"]) for _ in range(steps)]


def follow(conf: dict, weights: dict, steps: list, seed: int,
           precision: str = "float32") -> dict:
    """Run the reference over `steps` [(batch, draws)] from `weights`
    (a dict it may modify). Returns host readings: "loss" per
    micro-step and "eas" its smoothness term, "grad" the per-leaf norms
    of the first micro-step's gradient, "change" those of the parameters'
    change over all the steps, and "names" the leaves in that order."""
    prec = Precision(precision)
    specs = param_specs(conf["model_conf"])
    names = [n for n, _, k in specs
             if k not in ("bn_mean", "bn_var", "bn_count")]
    dtype = torch.float64 if precision == "float64" else torch.float32
    p = {n: t.to(dtype) if t.is_floating_point() else t
         for n, t in weights.items()}
    start = {n: p[n].detach().clone() for n in names}
    for n in names:
        p[n].requires_grad_(True)
    ids = view_ids(conf, seed, len(steps), steps[0][0]["imgs"].shape[1])
    acc_steps = int(conf.get("accumulate_steps", 1))
    lr = float(conf.get("learning_rate", 1e-4))
    acc = {n: torch.zeros_like(p[n]) for n in names}
    state, losses, eas, first = {}, [], [], None
    for i, (batch, draws) in enumerate(steps):
        b = {k: v.to(dtype) for k, v in batch.items()}
        d = {k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
             else v for k, v in draws.items()}
        loss, terms = train_loss(p, b, ids[i], d, conf, prec)
        # A leaf the loss does not reach (the spatial encoder's later
        # stages) has a zero gradient.
        grads = torch.autograd.grad(loss, [p[n] for n in names],
                                    allow_unused=True)
        losses.append(float(loss.detach()))
        eas.append(float(terms["loss_eas"].detach()))
        g = {n: torch.zeros_like(p[n]) if gr is None else gr
             for n, gr in zip(names, grads)}
        if first is None:
            first = leaf_norms(g, names)
        k = i % acc_steps
        with torch.no_grad():
            for n in names:
                acc[n] += (g[n] - acc[n]) / (k + 1)
            if k == acc_steps - 1:
                adam_step(p, acc, state, lr)
                for n in names:
                    acc[n].zero_()
    change = torch.stack([(p[n].detach() - start[n]).double().norm()
                          for n in names])
    return {"loss": losses, "eas": eas, "grad": first.cpu().numpy(),
            "change": change.cpu().numpy(), "names": names}
