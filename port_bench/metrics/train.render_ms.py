"""Query and renderer: device ms between the marks "encode" and "render"
(ray sampling, the field query, the composite)."""
from port_bench import readers


def read(run):
    return readers.stage_ms(run, "render")
