"""Evaluation harness (counterpart of
behindthescenes_tpu/evaluation/harness.py:20-97; reference
utils/base_evaluator.py:15-155): checkpoint loading, the metric loop with
one generator per item, and periodic logging."""
from __future__ import annotations

import logging
import os
from typing import Callable

import numpy as np
import torch

from behindthescenes_tpu_torch.models.bts import BTSNet
from behindthescenes_tpu_torch.weights import load_weights

log = logging.getLogger("bts_torch.eval")


class MeanMetric:
    """NaN-skipping running mean (reference utils/metrics.py:11-41)."""

    def __init__(self):
        self.total = 0.0
        self.count = 0

    def update(self, value: float):
        if np.isnan(value):
            return
        self.total += float(value)
        self.count += 1

    def compute(self) -> float:
        return self.total / self.count if self.count else float("nan")


def load_eval_variables(config: dict, net: BTSNet) -> BTSNet:
    """Load the config's `checkpoint` into `net`: a committed `.npz`
    artifact through the weight bridge; none keeps the random init (with
    a warning, as the JAX harness evaluates its random init)."""
    path = config.get("checkpoint")
    if not path:
        log.warning("no checkpoint configured — evaluating random init")
        return net
    if os.path.isdir(path):
        raise NotImplementedError(
            "orbax run and step directories are not ported: ROADMAP Queue "
            "A item 5")
    if path.endswith(".npz"):
        load_weights(net, path)
        log.info("loaded npz weights from %s", path)
        return net
    if path.endswith(".pt"):
        raise NotImplementedError(
            "reference torch checkpoints (.pt, import_torch) are not "
            "ported: ROADMAP Queue A item 2")
    raise ValueError(f"Unrecognized checkpoint: {path}")


def base_evaluation(config: dict, get_dataflow: Callable,
                    make_evaluator: Callable) -> dict:
    """Run the metric loop over get_dataflow(config) with the evaluator of
    make_evaluator(config); returns the final metric means."""
    if not log.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(message)s"))
        log.addHandler(h)
        log.setLevel(logging.INFO)
        log.propagate = False

    evaluator = make_evaluator(config)
    dev = next(evaluator.net.parameters()).device
    metrics: dict[str, MeanMetric] = {}
    for i, batch in enumerate(get_dataflow(config)):
        # Item i draws from a generator seeded with i, as the JAX harness
        # draws it from PRNGKey(i).
        gen = torch.Generator(device=dev)
        gen.manual_seed(i)
        out = evaluator.evaluate(batch, generator=gen)
        for k, val in out.items():
            metrics.setdefault(k, MeanMetric()).update(float(val))
        if (i + 1) % config.get("log_every_iters", 10) == 0:
            log.info("[%d] %s", i + 1,
                     {k: round(m.compute(), 5) for k, m in metrics.items()})
    final = {k: m.compute() for k, m in metrics.items()}
    log.info("final: %s", {k: round(v, 5) for k, v in final.items()})
    return final
