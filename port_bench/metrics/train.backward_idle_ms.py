"""Train step: device idle ms inside the program's span "backward" (the
marks "loss" to "backward"), the mean over the spans stretch's
micro-steps (`spans.py`)."""
from port_bench import spans


def read(run):
    return spans.idle_ms(run, "backward")
