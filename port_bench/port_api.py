"""Everything the benchmark takes from the program under test, the port
(`behindthescenes_tpu_torch`): its trainer, its depth evaluator, its
kernel library, its launcher of ranks and the collective that agrees a
flag over them (`parallel/`), and its tracing switch and counters
(`behindthescenes_tpu_torch.tracing`). No other file of the benchmark
imports the port, and the reference imports none of it.
"""
from __future__ import annotations

import torch


def import_program() -> None:
    """Import the modules of the program that a run drives."""
    import behindthescenes_tpu_torch.evaluation.depth  # noqa: F401
    import behindthescenes_tpu_torch.training.trainer  # noqa: F401


def exact_f32() -> None:
    from behindthescenes_tpu_torch.platform import exact_f32 as pin
    pin()


def kernel_library() -> None:
    """Build (first run in a checkout) or load the port's CUDA kernels."""
    from behindthescenes_tpu_torch.ops.kernels import _build
    _build.library()


def make_trainer(conf: dict, weights: dict, device):
    """The port's BTSTrainer for `conf` on `device`, its net loaded with
    `weights` (strict), a fresh Adam and accumulator, every counter at 0
    (what `BTSTrainer.init_state` leaves, with the weights given as
    tensors instead of its initialiser's)."""
    from behindthescenes_tpu_torch.training.trainer import (BTSTrainer,
                                                            make_optimizer)
    trainer = BTSTrainer(conf, device=device)
    trainer.net.to(device)
    trainer.net.load_state_dict(weights, strict=True)
    trainer.optimizer, trainer.lr_schedule = make_optimizer(
        conf, trainer.net.parameters())
    trainer.step = trainer.updates = trainer.mini_step = 0
    trainer.acc_grads = None
    if trainer.accumulate_steps > 1:
        trainer.acc_grads = {n: torch.zeros_like(p)
                             for n, p in trainer.net.named_parameters()}
    return trainer


def port_draws(draws: dict):
    """The benchmark's draws of one micro-step as the port's `Draws`, the
    fine pass's as its `FineDraws` where there are any."""
    from behindthescenes_tpu_torch.ray_sampler import PatchDraws
    from behindthescenes_tpu_torch.renderer import FineDraws
    from behindthescenes_tpu_torch.training.wrapper import Draws
    fine = None
    if "fine_u" in draws:
        fine = FineDraws(u=draws["fine_u"], jitter=draws["fine_jitter"],
                         normals=draws["fine_normals"])
    return Draws(flip=draws["flip"],
                 rays=PatchDraws(views=draws["views"], ys=draws["ys"],
                                 xs=draws["xs"]),
                 z_jitter=draws["z_jitter"], fine=fine)


def first_gradient(trainer) -> dict:
    """{name: gradient} as the optimizer holds it after the first
    micro-step: the accumulator's mean of one gradient, or, without
    accumulation, Adam's first moment over (1 - beta1)."""
    if trainer.acc_grads is not None:
        return dict(trainer.acc_grads)
    out = {}
    state = trainer.optimizer.state
    for name, p in trainer.net.named_parameters():
        m = state[p]["exp_avg"] if p in state else torch.zeros_like(p)
        out[name] = m / 0.1
    return out


def parameters(trainer) -> dict:
    return dict(trainer.net.named_parameters())


def make_depth_evaluator(conf: dict, weights: dict, device):
    """The port's DepthEvaluator on a BTSNet of `conf` in the compute
    dtype the evaluation config states, loaded with `weights`."""
    from behindthescenes_tpu_torch import renderer as renderer_lib
    from behindthescenes_tpu_torch.evaluation.depth import DepthEvaluator
    from behindthescenes_tpu_torch.models.bts import BTSNet
    dtype = torch.bfloat16 if conf.get("bf16", True) else torch.float32
    net = BTSNet.from_conf(conf["model_conf"], compute_dtype=dtype)
    net.to(device).eval()
    net.load_state_dict(weights, strict=True)
    cfg = renderer_lib.RendererConfig.from_conf(conf["renderer"])
    return DepthEvaluator(net, cfg, conf["model_conf"])


# ---------------------------------------------------------------- ranks
def run_ranks(fn, world: int, args: tuple, backend: str, timeout: float):
    """fn(rank, world, *args) on `world` new processes joined into one
    process group (a file rendezvous); their results in rank order. A
    rank that raises, or ranks that outlast `timeout` seconds, stop
    every rank and raise here."""
    from behindthescenes_tpu_torch.parallel.launch import run_ranks as run
    return run(fn, world, args, backend=backend, timeout=timeout)


def any_rank(flag: bool) -> bool:
    """Whether `flag` is set on any rank of the default group (every rank
    calls it; `flag` itself on one rank)."""
    from behindthescenes_tpu_torch.parallel.mesh import (any_rank as agree,
                                                         default_group)
    return agree(flag, default_group())


# ------------------------------------------------------------- tracing
def _tracing():
    """The port's tracing module, or None for a program without one (the
    port before it had spans): the span metrics then read nothing."""
    try:
        from behindthescenes_tpu_torch import tracing
    except ImportError:
        return None
    return tracing


def tracing_available() -> bool:
    return _tracing() is not None


def set_tracing(on: bool) -> None:
    """Turn the port's spans on or off."""
    _tracing().enable(on)


def counters() -> dict:
    """The port's counters: launches.<kernel>, h2d_copies, h2d_bytes."""
    return _tracing().counters()


def reset_counters() -> None:
    _tracing().reset()
