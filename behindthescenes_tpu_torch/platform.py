"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller passes `device="cpu"` (as the
tests do). A measurement path that finds no card fails instead of falling
back to the CPU.
"""
from __future__ import annotations

import torch


def exact_f32() -> None:
    """Pin float32 convolutions and matmuls to exact f32 (no TF32).

    cuDNN runs f32 convolutions in TF32 by default (about three decimal
    digits); the JAX reference computes them in exact f32, so every entry
    point of the port turns TF32 off for both cuDNN and cuBLAS."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """`None` means the card; a CUDA device that is not there raises."""
    exact_f32()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run "
                           "the port's plain versions on the CPU")
    return dev
