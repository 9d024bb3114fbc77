"""Device: kernel launches in the traced stretch per frame."""
from port_bench import readers


def read(run):
    return readers.launches_per(run)
