"""Trainer core: the optimiser, the train step and the eval step
(counterpart of behindthescenes_tpu/training/trainer.py:40-239; reference
models/bts/trainer.py:355-427 and utils/base_trainer.py:270-307).

The state lives in the net (parameters and BatchNorm statistics, f32 in
either precision), in the Adam optimiser and, with `accumulate_steps` k
> 1, in the accumulated gradient and its micro-step counter. A step
(a micro-step when k > 1) selects views on the host from the numpy
generator (the JAX package's draw order), runs the forward pass with
BatchNorm in train mode (its statistics move on every micro-step), the
loss in f32 and the backward pass; then, as optax.MultiSteps does
(optax 0.2.6), the gradient joins the running mean acc + (g - acc) /
(n + 1), and Adam steps on that mean on every k-th micro-step only, with
the learning rate of the schedule at the count of applied updates.
`alternating_ratio` r freezes the encoder on every (r + 1)-th step and the
coarse MLP on the others (`_alternating_mask`): the frozen half's
gradients are zeroed before Adam, so its moments decay as optax's do, and
its update is dropped.

Data parallel over the launcher's process group of several ranks:
`batch_size` counts each rank's items and the global batch is their
concatenation in rank order. BatchNorm and the loss take the global
batch's statistics and means, the draws are the global
batch's (training/wrapper.py), and after the backward pass one
all-reduce sums the flattened gradient, each rank's loss scaled by 1 /
world so that the sum is the global loss's gradient. The reduction runs
once per micro-step, before the accumulation (the mean is linear). So
every rank holds the same gradient, Adam steps identically everywhere,
and the parameters stay the same on every rank without a broadcast. The
gradient is reduced by hand, not by DistributedDataParallel: DDP's
bucketed reductions run during the backward pass, beside the BatchNorm
and loss reductions, whose order they would not keep across ranks.
"""
from __future__ import annotations

import copy
import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from behindthescenes_tpu_torch import renderer as renderer_lib
from behindthescenes_tpu_torch import tracing
from behindthescenes_tpu_torch.import_torch import apply_pretrained_encoder
from behindthescenes_tpu_torch.losses import ReconstructionLoss
from behindthescenes_tpu_torch.models.bts import BTSNet
from behindthescenes_tpu_torch.models.encoder import BatchNorm2d
from behindthescenes_tpu_torch.parallel.mesh import default_group, rank_world
from behindthescenes_tpu_torch.platform import resolve_device
from behindthescenes_tpu_torch.training.schedule import make_lr_schedule
from behindthescenes_tpu_torch.training.wrapper import (BTSWrapper, Draws,
                                                        compute_depth_metrics)
from behindthescenes_tpu_torch.weights import load_weights

# A micro-step's stages in order: train_step's marks and stage spans.
TRAIN_STAGES = ("encode", "render", "loss", "backward", "optimizer")


def make_optimizer(config: dict, params):
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8 outside the
    square root), and the update -> learning-rate schedule."""
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


def alternating_half(name: str) -> Optional[str]:
    """"encoder" or "mlp" for a parameter that `alternating_ratio` freezes
    in turns (a name with an `encoder` or `mlp_coarse` part, as the JAX
    mask tests its Flax path), else None."""
    parts = name.split(".")
    if "encoder" in parts:
        return "encoder"
    if any("mlp_coarse" in p for p in parts):
        return "mlp"
    return None


def _as_batch(batch: dict, device) -> dict:
    return {k: tracing.to_device(v, device)
            for k, v in batch.items() if v is not None}


class BTSTrainer:
    """Owns the net, the optimiser and the generators of one task config.
    Runs on the card unless `device` says otherwise. compute_dtype
    defaults to bf16, the JAX trainer's default (config key bf16). Its
    data-parallel ranks are the launcher's default group where one of
    several ranks is joined (module docstring)."""

    def __init__(self, config: dict, compute_dtype=None, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.group = default_group()
        self.rank, self.world = rank_world(self.group)
        model_conf = config["model_conf"]
        if compute_dtype is None:
            compute_dtype = torch.bfloat16 if config.get("bf16", True) \
                else torch.float32
        self.net = BTSNet.from_conf(model_conf, compute_dtype=compute_dtype)
        for mod in self.net.modules():
            if isinstance(mod, BatchNorm2d):
                mod.group = self.group
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
        self.accumulate_steps = int(config.get("accumulate_steps", 1))
        self.alternating_ratio = model_conf.get("alternating_ratio", None)
        self.optimizer = None
        self.lr_schedule = None
        self.step = 0
        self.updates = 0
        self.mini_step = 0
        self.acc_grads = None

    def init_state(self, weights: Optional[str] = None) -> None:
        """Parameters from a Flax-keyed `.npz` (a committed artifact or a
        checkpoint of the port), else from the port's initialiser seeded
        with the config's seed, with the encoder then taken from its
        pretrained checkpoint where the config asks for one
        (`import_torch.apply_pretrained_encoder`); then a fresh optimiser
        and accumulator, and every counter at 0."""
        if weights is not None:
            load_weights(self.net, weights)
        else:
            gen = torch.Generator()
            gen.manual_seed(self.config.get("seed", 0))
            init_params(self.net, gen)
            apply_pretrained_encoder(
                self.net, self.config["model_conf"].get("encoder", {}))
        self.net.to(self.device)
        self.optimizer, self.lr_schedule = make_optimizer(
            self.config, self.net.parameters())
        self.step = self.updates = self.mini_step = 0
        self.acc_grads = None
        if self.accumulate_steps > 1:
            self.acc_grads = {n: torch.zeros_like(p)
                              for n, p in self.net.named_parameters()}

    def state_dict(self) -> dict:
        """Everything a resumed run needs: parameters and BatchNorm
        statistics, Adam's moments and count, the accumulated gradient and
        its micro-step counter, the counts of steps and of applied updates,
        and the render scheduler."""
        return {"net": self.net.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "acc_grads": self.acc_grads,
                "mini_step": self.mini_step, "updates": self.updates,
                "step": self.step,
                "render_sched": self.scheduler.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        """The inverse of state_dict, after init_state."""
        self.net.load_state_dict(state["net"])
        # Copies, as the net's own load_state_dict makes: a state taken
        # from another live trainer must not share its tensors.
        self.optimizer.load_state_dict(copy.deepcopy(state["optimizer"]))
        if state["acc_grads"] is not None:
            with torch.no_grad():
                for n, t in state["acc_grads"].items():
                    self.acc_grads[n].copy_(t)
        self.mini_step = int(state["mini_step"])
        self.updates = int(state["updates"])
        self.step = int(state["step"])
        self.scheduler.load_state_dict(state["render_sched"])

    def train_step(self, batch: dict, draws: Optional[Draws] = None,
                   mark: Optional[Callable[[str], None]] = None) -> dict:
        """One (micro-)step on `batch` (numpy arrays or tensors): views from
        the numpy generator, the forward pass with `draws` (fields left
        None come from the trainer's generator), the loss, the backward
        pass, and the update (module docstring). mark(stage) is called
        after "encode", "render", "loss", "backward" and "optimizer", at
        the ends of the stage spans inside the span "train_step"
        (`tracing`). Returns the loss terms as 0-d tensors (detached)."""
        if self.optimizer is None:
            raise RuntimeError("call init_state first")
        with tracing.stages("train_step", TRAIN_STAGES, mark) as mark:
            cfg = self.scheduler.step()
            batch = _as_batch(batch, self.device)
            if batch["imgs"].element_size() < 4:
                # Images may arrive narrowed for the transfer; the math is
                # f32.
                batch["imgs"] = batch["imgs"].float()
            ids = self.wrapper.select_views(
                self.np_rng, batch["imgs"].shape[1], training=True)
            self.optimizer.zero_grad(set_to_none=True)
            data = self.wrapper.forward(
                batch, ids, train=True, renderer_cfg=cfg, draws=draws,
                generator=self.generator, mark=mark, group=self.group)
            loss, loss_dict = self.criterion(data, self.group)
            out = {k: v.detach() for k, v in loss_dict.items()}
            if mark:
                mark("loss")
            if self.group is None:
                loss.backward()
            else:
                (loss / self.world).backward()
                self._reduce_grads()
            if mark:
                mark("backward")
            self._update()
            self.step += 1
            if mark:
                mark("optimizer")
        return out

    @torch.no_grad()
    def _reduce_grads(self) -> None:
        """Sum the gradients over the group in one flattened all-reduce
        (every rank has the same parameters without a gradient)."""
        grads = [p.grad for p in self.net.parameters() if p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.group)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    @torch.no_grad()
    def _update(self) -> None:
        params = dict(self.net.named_parameters())
        frozen = None
        if self.alternating_ratio is not None:
            phase = self.step % (self.alternating_ratio + 1)
            frozen = "mlp" if phase < self.alternating_ratio else "encoder"
            for name, p in params.items():
                if p.grad is not None and alternating_half(name) == frozen:
                    p.grad.zero_()
        if self.acc_grads is not None:
            n = self.mini_step
            accs = [self.acc_grads[name] for name in params]
            # acc + (g - acc) / (n + 1), a parameter without a gradient
            # counting as g = 0; three multi-tensor launches in all.
            steps = torch._foreach_sub(
                [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params.values()], accs)
            torch._foreach_div_(steps, n + 1)
            torch._foreach_add_(accs, steps)
            self.mini_step = (n + 1) % self.accumulate_steps
            if self.mini_step != 0:
                return
            for p, acc in zip(params.values(), accs):
                p.grad = acc.clone()
            torch._foreach_zero_(accs)
        keep = {name: p.clone() for name, p in params.items()
                if alternating_half(name) == frozen} if frozen else {}
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_schedule(self.updates)
        self.optimizer.step()
        self.updates += 1
        for name, value in keep.items():
            params[name].copy_(value)

    @torch.no_grad()
    def eval_step(self, batch: dict, draws: Optional[Draws] = None,
                  generator: Optional[torch.Generator] = None) -> dict:
        """Full-frame render of every view with BatchNorm's running
        statistics: depth (z, n, v, h, w), rgb, and the depth metrics
        where the batch has depths. Draws not given come from `generator`
        (default: the trainer's)."""
        batch = _as_batch(batch, self.device)
        ids = self.wrapper.select_views(self.np_rng, batch["imgs"].shape[1],
                                        training=False)
        data = self.wrapper.forward(batch, ids, train=False, draws=draws,
                                    generator=generator or self.generator)
        out = {"depth": data["fine"][0]["depth"],
               "rgb": data["fine"][0]["rgb"]}
        if batch.get("depths") is not None:
            out["metrics"] = compute_depth_metrics(data)
        return out
