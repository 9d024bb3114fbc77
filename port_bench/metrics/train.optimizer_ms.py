"""Train step: device ms between the marks "backward" and "optimizer"
(accumulation and, every accumulate_steps-th micro-step, Adam)."""
from port_bench import readers


def read(run):
    return readers.stage_ms(run, "optimizer")
