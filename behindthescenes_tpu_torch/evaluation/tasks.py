"""Evaluation task wiring (counterpart of
behindthescenes_tpu/evaluation/tasks.py; reference
models/bts/evaluator*.py evaluation() entry points). Each task runs on
`device` (default: the card)."""
from __future__ import annotations

import torch

from behindthescenes_tpu_torch import renderer as renderer_lib
from behindthescenes_tpu_torch.datasets.factory import make_test_dataset
from behindthescenes_tpu_torch.datasets.loader import DataLoader
from behindthescenes_tpu_torch.evaluation.harness import (base_evaluation,
                                                          load_eval_variables)
from behindthescenes_tpu_torch.models.bts import BTSNet
from behindthescenes_tpu_torch.platform import resolve_device

# Parameters of a model without a checkpoint come from this seed.
INIT_SEED = 0


def _get_dataflow(config):
    ds = make_test_dataset(config["data"])
    if hasattr(ds, "return_depth"):
        ds.return_depth = True
    return DataLoader(ds, batch_size=1,
                      num_workers=config.get("num_workers", 2))


def _net_and_cfg(config, device=None):
    """The config's model with its checkpoint, in bf16 compute unless the
    config says `bf16: false` (the JAX tasks' default), and its renderer
    config."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(INIT_SEED)
        net = BTSNet.from_conf(config["model_conf"],
                               compute_dtype=torch.bfloat16
                               if config.get("bf16", True) else torch.float32)
    net = load_eval_variables(config, net).to(dev).eval()
    rcfg = renderer_lib.RendererConfig.from_conf(config.get("renderer", {}))
    return net, rcfg


def evaluate_depth(config, device=None):
    from behindthescenes_tpu_torch.evaluation.depth import DepthEvaluator

    def make_evaluator(config):
        net, rcfg = _net_and_cfg(config, device)
        return DepthEvaluator(net, rcfg, config["model_conf"],
                              eval_nvs=config.get("mode") == "nvs")

    return base_evaluation(config, _get_dataflow, make_evaluator)


def evaluate_nvs(config, device=None):
    from behindthescenes_tpu_torch.evaluation.nvs import NVSEvaluator

    def make_evaluator(config):
        net, rcfg = _net_and_cfg(config, device)
        return NVSEvaluator(net, rcfg, config["model_conf"],
                            eval_resolution=config.get("eval_resolution"))

    return base_evaluation(config, _get_dataflow, make_evaluator)


def _evaluate_occupancy(config, device, evaluator_cls):
    """The occupancy tasks: the evaluator reads the dataset's sequences,
    calibration and sweeps, so the dataset is made first and kept for it
    (behindthescenes_tpu/evaluation/tasks.py:56-96)."""
    ds = make_test_dataset(config["data"])

    def get_dataflow(config):
        return DataLoader(ds, batch_size=1,
                          num_workers=config.get("num_workers", 2))

    def make_evaluator(config):
        net, rcfg = _net_and_cfg(config, device)
        return evaluator_cls(net, rcfg, config["model_conf"], ds)

    return base_evaluation(config, get_dataflow, make_evaluator)


def evaluate_lidar_occ(config, device=None):
    from behindthescenes_tpu_torch.evaluation.lidar_occ import \
        LidarOccEvaluator
    return _evaluate_occupancy(config, device, LidarOccEvaluator)


def evaluate_3dbb(config, device=None):
    from behindthescenes_tpu_torch.evaluation.bbox_occ import \
        BBoxOccEvaluator
    return _evaluate_occupancy(config, device, BBoxOccEvaluator)


TASKS = {"bts": evaluate_depth, "bts_nvs": evaluate_nvs,
         "bts_lidar": evaluate_lidar_occ, "bts_3dbb": evaluate_3dbb}
