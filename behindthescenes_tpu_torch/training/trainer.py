"""Trainer core: the optimiser, the train step and the eval step
(counterpart of behindthescenes_tpu/training/trainer.py:40-239; reference
models/bts/trainer.py:355-427 and utils/base_trainer.py:270-307).

The state lives in the net (parameters and BatchNorm statistics, f32 in
either precision) and in the Adam optimiser. A step selects views on the
host from the numpy generator (the JAX package's draw order), runs the
forward pass with BatchNorm in train mode, the loss in f32, the backward
pass and one Adam update.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from behindthescenes_tpu_torch import renderer as renderer_lib
from behindthescenes_tpu_torch.losses import ReconstructionLoss
from behindthescenes_tpu_torch.models.bts import BTSNet
from behindthescenes_tpu_torch.platform import resolve_device
from behindthescenes_tpu_torch.training.schedule import make_lr_schedule
from behindthescenes_tpu_torch.training.wrapper import (BTSWrapper, Draws,
                                                        compute_depth_metrics)
from behindthescenes_tpu_torch.weights import load_weights


def make_optimizer(config: dict, params):
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8 outside the
    square root), and the step -> learning-rate schedule."""
    if config.get("accumulate_steps", 1) > 1:
        raise NotImplementedError(
            "accumulate_steps > 1 is not ported: ROADMAP Queue A item 5")
    lr = config.get("learning_rate", 1e-4)
    schedule = make_lr_schedule(config.get("scheduler", {}), lr)
    return torch.optim.Adam(params, lr=schedule(0), betas=(0.9, 0.999),
                            eps=1e-8), schedule


def init_params(net: BTSNet, generator: torch.Generator) -> None:
    """The port's initialiser, with the distributions of the JAX package's
    Flax initialisers: the ResNet's convolutions normal with variance
    2 / fan_out; the decoder's convolutions Flax's default (LeCun
    truncated normal, zero bias); the field MLP's dense layers normal
    with variance 2 / fan_in and zero bias, each block's fc_1 zero;
    BatchNorm scale 1 and bias 0; learned maps standard normal."""
    def normal_(t, std):
        with torch.no_grad():
            t.copy_(torch.randn(t.shape, generator=generator) * std)

    for name, mod in net.named_modules():
        if isinstance(mod, nn.Conv2d):
            o, i, kh, kw = mod.weight.shape
            if name.startswith("encoder.encoder."):
                normal_(mod.weight, math.sqrt(2.0 / (o * kh * kw)))
            else:
                std = math.sqrt(1.0 / (i * kh * kw)) / .87962566103423978
                w = torch.empty(mod.weight.shape)
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                with torch.no_grad():
                    mod.weight.copy_(w * std)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.Linear):
            if name.endswith("fc_1"):
                nn.init.zeros_(mod.weight)
            else:
                normal_(mod.weight, math.sqrt(2.0 / mod.weight.shape[1]))
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
    for name, p in net.named_parameters(recurse=True):
        if name in ("empty_feature", "encoder.feats"):
            normal_(p, 1.0)


def _as_batch(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device)
            for k, v in batch.items() if v is not None}


class BTSTrainer:
    """Owns the net, the optimiser and the generators of one task config.
    Runs on the card unless `device` says otherwise. compute_dtype
    defaults to bf16, the JAX trainer's default (config key bf16)."""

    def __init__(self, config: dict, compute_dtype=None, device=None):
        self.config = config
        self.device = resolve_device(device)
        model_conf = config["model_conf"]
        if compute_dtype is None:
            compute_dtype = torch.bfloat16 if config.get("bf16", True) \
                else torch.float32
        self.net = BTSNet.from_conf(model_conf, compute_dtype=compute_dtype)
        self.renderer_cfg = renderer_lib.RendererConfig.from_conf(
            config.get("renderer", {}))
        self.scheduler = renderer_lib.SampleScheduler(self.renderer_cfg)
        self.wrapper = BTSWrapper(self.net, self.renderer_cfg, model_conf)
        self.criterion = ReconstructionLoss.from_conf(
            config.get("loss", {}), model_conf.get("use_automasking", False))
        seed = config.get("seed", 0)
        self.np_rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.optimizer = None
        self.lr_schedule = None
        self.step = 0

    def init_state(self, weights: Optional[str] = None) -> None:
        """Parameters from a Flax-keyed `.npz` (a committed artifact or a
        checkpoint of the port), else from the port's initialiser seeded
        with the config's seed; then a fresh optimiser."""
        if weights is not None:
            load_weights(self.net, weights)
        else:
            enc_conf = self.config["model_conf"].get("encoder", {})
            if enc_conf.get("pretrained") or enc_conf.get("cp_location"):
                raise NotImplementedError(
                    "ImageNet-pretrained encoders are not ported: ROADMAP "
                    "Queue A item 2")
            gen = torch.Generator()
            gen.manual_seed(self.config.get("seed", 0))
            init_params(self.net, gen)
        self.net.to(self.device)
        self.optimizer, self.lr_schedule = make_optimizer(
            self.config, self.net.parameters())
        self.step = 0

    def train_step(self, batch: dict, draws: Optional[Draws] = None,
                   mark: Optional[Callable[[str], None]] = None) -> dict:
        """One step on `batch` (numpy arrays or tensors): views from the
        numpy generator, the forward pass with `draws` (fields left None
        come from the trainer's generator), the loss, the backward pass
        and one Adam update. mark(stage) is called after "encode",
        "render", "loss", "backward" and "optimizer". Returns the loss
        terms as 0-d tensors (detached)."""
        if self.optimizer is None:
            raise RuntimeError("call init_state first")
        cfg = self.scheduler.step()
        batch = _as_batch(batch, self.device)
        if batch["imgs"].element_size() < 4:
            # Images may arrive narrowed for the transfer; the math is f32.
            batch["imgs"] = batch["imgs"].float()
        ids = self.wrapper.select_views(self.np_rng, batch["imgs"].shape[1],
                                        training=True)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_schedule(self.step)
        self.optimizer.zero_grad(set_to_none=True)
        data = self.wrapper.forward(batch, ids, train=True, renderer_cfg=cfg,
                                    draws=draws, generator=self.generator,
                                    mark=mark)
        loss, loss_dict = self.criterion(data)
        if mark:
            mark("loss")
        loss.backward()
        if mark:
            mark("backward")
        self.optimizer.step()
        if mark:
            mark("optimizer")
        self.step += 1
        return {k: v.detach() for k, v in loss_dict.items()}

    @torch.no_grad()
    def eval_step(self, batch: dict, draws: Optional[Draws] = None) -> dict:
        """Full-frame render of every view with BatchNorm's running
        statistics: depth (z, n, v, h, w), rgb, and the depth metrics
        where the batch has depths."""
        batch = _as_batch(batch, self.device)
        ids = self.wrapper.select_views(self.np_rng, batch["imgs"].shape[1],
                                        training=False)
        data = self.wrapper.forward(batch, ids, train=False, draws=draws,
                                    generator=self.generator)
        out = {"depth": data["fine"][0]["depth"],
               "rgb": data["fine"][0]["rgb"]}
        if batch.get("depths") is not None:
            out["metrics"] = compute_depth_metrics(data)
        return out
