"""Device: stream, device and event synchronisations and blocking copies
that start inside the program's spans "train_step", per micro-step of
the spans stretch (`spans.py`)."""
from port_bench import spans


def read(run):
    return spans.per(run, "train_step", "syncs")
