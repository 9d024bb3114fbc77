"""Depth entry: the 95th percentile of the window's frames' latency, from
a frame being sent to its depth map landing on the host, in the closed
loop of `max_in_flight` frames."""
from port_bench.harness import p95


def read(run):
    if len(run.latency_ms) < 20:
        return None
    return p95(run.latency_ms)
