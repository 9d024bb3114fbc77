"""Train step: device ms a micro-step of the collectives' kernels (names
holding "nccl": the gradient's all-reduce and BatchNorm's and the loss's
sums over the ranks), in rank 0's traced stretch. NCCL's kernel time
includes its wait for the slowest rank."""
from port_bench import readers


def read(run):
    secs, n = readers.kernel_seconds(run, "nccl")
    if not n:
        return None
    return 1e3 * secs / run.trace["count"]
