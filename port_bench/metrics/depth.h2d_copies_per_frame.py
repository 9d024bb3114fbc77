"""Self-view query and composite: the program's counter "h2d_copies"
(host data made into tensors on the card, each a pageable copy the
stream waits for) over the spans stretch, per frame (`spans.py`)."""
from port_bench import spans


def read(run):
    return spans.counter_per(run, "h2d_copies")
