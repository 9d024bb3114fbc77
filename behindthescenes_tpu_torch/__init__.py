"""behindthescenes_tpu_torch: the PyTorch/CUDA port of the JAX package
behindthescenes_tpu (its reference).

A second package beside the JAX one, held against it module by module.
Module names follow the JAX package so each counterpart is easy to find;
inside, the idiom is PyTorch's: `nn.Module`s, plain functions on tensors,
an explicit `device` and explicit `torch.Generator`s. Every Pallas kernel
of the JAX package has a hand-written CUDA counterpart for Hopper under
`csrc/`, with a plain PyTorch version of the same function beside its
wrapper in `ops/kernels/`.

The port imports torch, numpy and the standard library only — never jax,
flax, yaml, cv2 or the JAX package (the GPU machine has none of them).
"""

__version__ = "0.1.0"
