"""Self-view query and composite: device idle ms inside the program's
span "render" of a depth frame (the marks "encode" to "render"), the
mean over the spans stretch's frames (`spans.py`)."""
from port_bench import spans


def read(run):
    return spans.idle_ms(run, "render")
