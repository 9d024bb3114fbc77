"""Train step: ms a micro-step in which a collective's kernel ran on rank
0 and no other device operation did: the exchange that no computation
hides (an all-reduce overlapped with the backward pass would take it
away)."""
from port_bench import readers


def read(run):
    _, n = readers.kernel_seconds(run, "nccl")
    if not n:
        return None
    return 1e3 * readers.alone_seconds(run, "nccl") / run.trace["count"]
