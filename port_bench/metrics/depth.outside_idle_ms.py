"""Depth entry: idle ms per frame outside every span "depth_frame" of the
spans stretch: the client's copy of each depth map to the host and its
wait (`spans.py`)."""
from port_bench import spans


def read(run):
    return spans.outside_idle_ms(run)
