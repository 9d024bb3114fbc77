"""Model step: the micro-steps' model FLOPs over the window's seconds and
989 TFLOP/s (bf16), in %."""
from port_bench import readers


def read(run):
    return readers.mfu(run)
