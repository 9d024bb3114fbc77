"""The port's hand-written CUDA kernels, one module per Pallas kernel of
the JAX package. Each wrapper launches its kernel on a CUDA tensor, runs
its plain PyTorch version on a CPU tensor, and counts its launches in the
port's counter "launches.<kernel>" (`behindthescenes_tpu_torch.tracing`).
`launch_counts` and `reset_launch_counts` read and clear those
counters."""
from behindthescenes_tpu_torch import tracing
from behindthescenes_tpu_torch.ops.kernels.jitter_density import \
    jitter_density
from behindthescenes_tpu_torch.ops.kernels.selfview import selfview_density
from behindthescenes_tpu_torch.ops.kernels.shared_z import shared_z_tail

KERNELS = {"shared_z": shared_z_tail,
           "jitter_density": jitter_density,
           "selfview": selfview_density}


def reset_launch_counts() -> None:
    tracing.reset(["launches." + name for name in KERNELS])


def launch_counts() -> dict:
    counts = tracing.counters()
    return {name: counts.get("launches." + name, 0) for name in KERNELS}
