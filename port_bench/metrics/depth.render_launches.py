"""Self-view query and composite: kernels launched inside the program's
span "render", per frame of the spans stretch (`spans.py`)."""
from port_bench import spans


def read(run):
    return spans.per(run, "render", "launches")
