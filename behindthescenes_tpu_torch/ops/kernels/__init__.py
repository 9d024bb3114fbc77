"""The port's hand-written CUDA kernels, one module per Pallas kernel of
the JAX package. Each wrapper launches its kernel on a CUDA tensor, runs
its plain PyTorch version on a CPU tensor, and counts its launches in a
plain integer attribute `launches`."""
from behindthescenes_tpu_torch.ops.kernels.jitter_density import \
    jitter_density
from behindthescenes_tpu_torch.ops.kernels.selfview import selfview_density
from behindthescenes_tpu_torch.ops.kernels.shared_z import shared_z_tail

KERNELS = {"shared_z": shared_z_tail,
           "jitter_density": jitter_density,
           "selfview": selfview_density}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
