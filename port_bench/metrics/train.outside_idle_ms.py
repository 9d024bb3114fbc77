"""Device: idle ms per micro-step outside every span "train_step" of the
spans stretch: the benchmark's own loop between micro-steps
(`spans.py`)."""
from port_bench import spans


def read(run):
    return spans.outside_idle_ms(run)
