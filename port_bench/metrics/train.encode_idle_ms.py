"""Encoder: device idle ms inside the program's span "encode" (a
micro-step's start to the mark "encode"), the mean over the spans
stretch's micro-steps (`spans.py`)."""
from port_bench import spans


def read(run):
    return spans.idle_ms(run, "encode")
