"""Self-view query and composite: device ms between the marks "encode" and
"render" (the lattice resample, the shared-z decode, the composite)."""
from port_bench import readers


def read(run):
    return readers.stage_ms(run, "render")
