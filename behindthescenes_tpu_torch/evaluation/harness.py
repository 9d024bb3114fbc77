"""Evaluation harness (counterpart of
behindthescenes_tpu/evaluation/harness.py:19-97; reference
utils/base_evaluator.py:15-155): checkpoint loading (a committed `.npz`,
the port's run and step directories, the reference's `.pt` training
checkpoints), the metric loop with one generator per item, and periodic
logging."""
from __future__ import annotations

import logging
import os
from typing import Callable

import torch

from behindthescenes_tpu_torch.import_torch import load_bts_checkpoint
from behindthescenes_tpu_torch.models.bts import BTSNet
from behindthescenes_tpu_torch.training.harness import (CheckpointManager,
                                                        MeanMetric)
from behindthescenes_tpu_torch.weights import load_weights

__all__ = ["MeanMetric", "load_eval_variables", "base_evaluation"]

log = logging.getLogger("bts_torch.eval")


def load_eval_variables(config: dict, net: BTSNet) -> BTSNet:
    """Load the config's `checkpoint` into `net`: a committed `.npz`
    artifact through the weight bridge; a step directory of the port's
    training harness (`.../checkpoints/<step>`) or a run directory (its
    latest step in `checkpoints/`); a reference `training*.pt` through
    `import_torch` (checked against the net's keys and shapes). None
    keeps the random init (with a warning, as the JAX harness evaluates
    its random init). An orbax directory of the JAX package raises."""
    path = config.get("checkpoint")
    if not path:
        log.warning("no checkpoint configured — evaluating random init")
        return net
    if os.path.isdir(path):
        norm = os.path.normpath(path)
        base = os.path.basename(norm)
        if base.isdigit():
            mgr, step = CheckpointManager(os.path.dirname(norm)), int(base)
        else:
            run = os.path.join(norm, "checkpoints")
            mgr = CheckpointManager(run if os.path.isdir(run) else norm)
            step = mgr.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {mgr.directory}")
        net.load_state_dict(mgr.load(step)["net"])
        log.info("restored checkpoint step %s from %s", step, mgr.directory)
        return net
    if path.endswith(".npz"):
        load_weights(net, path)
        log.info("loaded npz weights from %s", path)
        return net
    if path.endswith(".pt"):
        load_bts_checkpoint(net, path, config.get("model_conf", {})
                            .get("encoder", {}))
        log.info("imported torch checkpoint %s", path)
        return net
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
