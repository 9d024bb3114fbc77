"""Loss: device ms between the marks "render" and "loss" (l1 + SSIM, the
invalid mask, smoothness)."""
from port_bench import readers


def read(run):
    return readers.stage_ms(run, "loss")
