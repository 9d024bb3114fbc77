"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller passes `device="cpu"` (as the
tests do). A measurement path that finds no card fails instead of falling
back to the CPU. Under a launcher of several ranks (torchrun's
LOCAL_RANK) the card is the rank's own.
"""
from __future__ import annotations

import os

import torch


def exact_f32() -> None:
    """Pin float32 convolutions and matmuls to exact f32 (no TF32).

    cuDNN runs f32 convolutions in TF32 by default (about three decimal
    digits); the JAX reference computes them in exact f32, so every entry
    point of the port turns TF32 off for both cuDNN and cuBLAS."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """`None` means the card: `cuda:{LOCAL_RANK}` under a launcher of
    several ranks, each rank on a card of its own (ranks share a card only
    where the caller names it). A CUDA device that is not there raises."""
    exact_f32()
    if device is None:
        local = os.environ.get("LOCAL_RANK")
        device = f"cuda:{int(local)}" if local is not None else "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run "
                           "the port's plain versions on the CPU")
    if dev.type == "cuda" and dev.index is not None:
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"{dev} is not there: {torch.cuda.device_count()} CUDA "
                "device(s) found (one card a rank; pass the device to "
                "share one)")
        torch.cuda.set_device(dev)
    return dev


def multihost_barrier(tag: str = "") -> None:  # noqa: ARG001 (the JAX API)
    """Wait until every rank of the default group reaches this point (a
    no-op in a single process)."""
    from behindthescenes_tpu_torch.parallel.mesh import barrier, default_group
    barrier(default_group())
