"""Device: 1 - busy / wall over the traced stretch of frames, in %."""
from port_bench import readers


def read(run):
    return readers.idle_share(run)
