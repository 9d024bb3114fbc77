"""Learning-rate schedules (counterpart of
behindthescenes_tpu/training/schedule.py:7-16; reference
models/common/model/scheduler.py:5-29)."""
from __future__ import annotations


def make_lr_schedule(conf: dict, base_lr: float):
    """step -> learning rate. type fix: constant; type step: StepLR,
    base_lr * gamma ** (step // step_size)."""
    stype = conf.get("type", "fix")
    if stype == "fix":
        return lambda step: base_lr
    if stype == "step":
        step_size = conf.get("step_size", 100000)
        gamma = conf.get("gamma", 0.1)
        return lambda step: base_lr * gamma ** (step // step_size)
    raise NotImplementedError(f"Unsupported scheduler type: {stype}")
