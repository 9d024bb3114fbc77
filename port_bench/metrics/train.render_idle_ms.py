"""Query and renderer: device idle ms inside the program's span "render"
(the marks "encode" to "render"), the mean over the spans stretch's
micro-steps (`spans.py`)."""
from port_bench import spans


def read(run):
    return spans.idle_ms(run, "render")
