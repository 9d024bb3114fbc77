"""Deterministic self-view decode tail: relu(hs[:, None] + hd[None]) @ w + b.

Counterpart of behindthescenes_tpu/ops/pallas/shared_z.py. On a CUDA
tensor `shared_z_tail` launches a hand-written kernel of csrc/shared_z.cu:
for H in `_build.DECODE_H` the register-tiled f32 kernel or the
tensor-core bf16 kernel, for any other H the runtime-H kernel
(`kernel_for` picks from the shapes before the launch). On a CPU tensor
it runs `shared_z_tail_plain`, `shared_z_tail_jnp` written as plain
tensors (it materializes the (B, K, H) sum).
"""
from __future__ import annotations

import torch

from behindthescenes_tpu_torch.ops.kernels import _build


def shared_z_tail_plain(hs, hd, w_out, b_out):
    """hs (B, H), hd (K, H) in one dtype, w_out (H, D), b_out (D,) ->
    (B, K, D), as shared_z_tail_jnp: the sum hs + hd and the relu run in
    the inputs' dtype (bf16 inputs round the sum to bf16), the projection
    and the bias in f32 (or in b_out's dtype where that is wider)."""
    dt = torch.promote_types(b_out.dtype, torch.float32)
    x = torch.relu(hs[:, None, :] + hd[None, :, :])
    return torch.einsum("bkh,hd->bkd", x.to(dt), w_out.to(dt)) \
        + b_out.to(dt)


def kernel_for(h: int) -> str:
    """Which kernel a CUDA call of width H launches: "built" (the f32
    register-tile or bf16 tensor-core kernel) or "any" (runtime H)."""
    return "built" if h in _build.DECODE_H else "any"


def shared_z_tail(hs, hd, w_out, b_out):
    """out[b, k, 0] = sum_j w_out[j, 0] * relu(hs[b, j] + hd[k, j])
    + b_out[0].

    hs (B, H), hd (K, H) and w_out (H, 1) all f32 or all bf16 (the model
    casts w_out to its compute dtype, as the JAX package does), b_out (1,)
    f32 -> (B, K, 1) f32. The kernels take D = 1 (the density column);
    the JAX package too runs its kernel for D = 1 only."""
    if hs.device.type == "cpu":
        return shared_z_tail_plain(hs, hd, w_out, b_out)
    b, h = hs.shape
    k = hd.shape[0]
    dev = hs.device
    if hs.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"hs: dtype {hs.dtype}, expected float32 or "
                        "bfloat16")
    built = kernel_for(h) == "built"
    # The built kernels load hs in 16-byte and bf16 pairs in 4-byte words.
    _build.require(hs, "hs", hs.dtype, (b, h), dev, align=16 if built else 1)
    _build.require(hd, "hd", hs.dtype, (k, h), dev, align=4 if built else 1)
    _build.require(w_out, "w_out", hs.dtype, (h, 1), dev,
                   align=4 if built else 1)
    _build.require(b_out, "b_out", torch.float32, (1,), dev)
    out = torch.empty((b, k, 1), dtype=torch.float32, device=dev)
    if b == 0 or k == 0:
        return out
    lib = _build.library()
    bf16 = hs.dtype == torch.bfloat16
    if built:
        launch = lib.bts_shared_z_tail_bf16 if bf16 else lib.bts_shared_z_tail
    else:
        launch = lib.bts_shared_z_tail_any_bf16 if bf16 \
            else lib.bts_shared_z_tail_any
    with torch.cuda.device(dev):
        err = launch(hs.data_ptr(), hd.data_ptr(), w_out.data_ptr(),
                     b_out.data_ptr(), out.data_ptr(), b, k, h,
                     torch.cuda.current_stream().cuda_stream)
        shared_z_tail.launches += 1
    _build.check(err, "shared_z_tail")
    return out


shared_z_tail.launches = 0
