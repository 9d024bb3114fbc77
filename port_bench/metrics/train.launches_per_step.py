"""Device: kernel launches in the traced stretch per micro-step."""
from port_bench import readers


def read(run):
    return readers.launches_per(run)
