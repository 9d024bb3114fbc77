"""Encoder: device ms from a micro-step's start to the program's mark
"encode" (BTSNet.encode)."""
from port_bench import readers


def read(run):
    return readers.stage_ms(run, "encode")
