"""Encoder: device ms from a frame's start to the evaluator's mark
"encode"."""
from port_bench import readers


def read(run):
    return readers.stage_ms(run, "encode")
