"""Deterministic self-view decode tail: relu(hs[:, None] + hd[None]) @ w + b.

Counterpart of behindthescenes_tpu/ops/pallas/shared_z.py. On a CUDA
tensor `shared_z_tail` launches the hand-written kernel csrc/shared_z.cu;
on a CPU tensor it runs `shared_z_tail_plain`, the same function written
as plain tensors (which materializes the (B, K, H) sum).
"""
from __future__ import annotations

import torch

from behindthescenes_tpu_torch.ops.kernels import _build


def shared_z_tail_plain(hs, hd, w_out, b_out):
    """hs (B, H), hd (K, H) f32 or bf16, w_out (H,), b_out (1,) f32 ->
    (B, K) f32. As shared_z_tail_jnp: the sum hs + hd and the relu run in
    the inputs' dtype (bf16 inputs round the sum to bf16), the projection
    in w_out's."""
    x = torch.relu(hs[:, None, :] + hd[None, :, :])
    return torch.einsum("bkh,h->bk", x.to(w_out.dtype), w_out) + b_out


def shared_z_tail(hs, hd, w_out, b_out):
    """out[b, k] = sum_j w_out[j] * relu(hs[b, j] + hd[k, j]) + b_out.

    hs (B, H) and hd (K, H) both f32 or both bf16, w_out (H,) and b_out
    (1,) f32 -> (B, K) f32. (The JAX function returns (B, K, D); the
    decode uses D = 1 only.)"""
    if hs.device.type == "cpu":
        return shared_z_tail_plain(hs, hd, w_out, b_out)
    b, h = hs.shape
    k = hd.shape[0]
    dev = hs.device
    f32 = torch.float32
    if hs.dtype not in (f32, torch.bfloat16):
        raise TypeError(f"hs: dtype {hs.dtype}, expected float32 or "
                        "bfloat16")
    _build.require(hs, "hs", hs.dtype, (b, h), dev)
    _build.require(hd, "hd", hs.dtype, (k, h), dev)
    _build.require(w_out, "w_out", f32, (h,), dev)
    _build.require(b_out, "b_out", f32, (1,), dev)
    out = torch.empty((b, k), dtype=f32, device=dev)
    if b == 0 or k == 0:
        return out
    lib = _build.library()
    launch = lib.bts_shared_z_tail if hs.dtype == f32 \
        else lib.bts_shared_z_tail_bf16
    with torch.cuda.device(dev):
        err = launch(hs.data_ptr(), hd.data_ptr(), w_out.data_ptr(),
                     b_out.data_ptr(), out.data_ptr(), b, k, h,
                     torch.cuda.current_stream().cuda_stream)
        shared_z_tail.launches += 1
    _build.check(err, "shared_z_tail")
    return out


shared_z_tail.launches = 0
