"""Train step: device ms between the marks "loss" and "backward" (the
backward pass, with any gradient all-reduce)."""
from port_bench import readers


def read(run):
    return readers.stage_ms(run, "backward")
