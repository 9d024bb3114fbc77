"""Train step: kernels launched inside the program's span "backward" (on
any thread: the autograd engine's), per micro-step of the spans stretch
(`spans.py`)."""
from port_bench import spans


def read(run):
    return spans.per(run, "backward", "launches")
