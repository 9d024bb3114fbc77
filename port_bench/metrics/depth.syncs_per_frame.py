"""Depth entry: stream, device and event synchronisations and blocking
copies that start inside the program's spans "depth_frame", per frame
of the spans stretch (`spans.py`)."""
from port_bench import spans


def read(run):
    return spans.per(run, "depth_frame", "syncs")
