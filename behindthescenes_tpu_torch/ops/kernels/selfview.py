"""Jittered self-view density decode in f32, softplus included.

Counterpart of behindthescenes_tpu/ops/pallas/selfview.py. On a CUDA
tensor `selfview_density` launches the hand-written kernel
csrc/selfview.cu; on a CPU tensor it runs `selfview_density_plain`, the
same function written as plain tensors.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from behindthescenes_tpu_torch import tracing
from behindthescenes_tpu_torch.ops.kernels import _build

# The kernel takes K in groups of this many consecutive samples per thread
# (one float4 of coord).
KERNEL_SAMPLES = 4


def interleave_to_grouped(n_freqs: int) -> np.ndarray:
    """Row permutation taking the PositionalEncoding layout
    [id, sin f1, cos f1, sin f2, cos f2, ...] to the grouped
    [id, sin f1..fF, cos f1..fF]."""
    return np.concatenate([[0], 1 + 2 * np.arange(n_freqs),
                           2 + 2 * np.arange(n_freqs)]).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _grouped_rows(n_freqs: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(interleave_to_grouped(n_freqs), device=device)


def grouped_code_weights(w_d, n_freqs: int):
    """W_d (13, H) in the interleaved code order -> W_z (13, H) in the
    grouped order [c, sin f1..fF, cos f1..fF], contiguous: the kernel
    reads W_z[i][j..j+3] as one float4."""
    return w_d[_grouped_rows(n_freqs, w_d.device)].contiguous()


def kernel_takes(k: int, h: int, n_freqs: int) -> bool:
    """Whether the CUDA kernel takes these shapes (`check_shapes` raises
    where it does not)."""
    return (h in _build.DECODE_H and n_freqs == _build.DECODE_N_FREQS
            and k % KERNEL_SAMPLES == 0)


def check_shapes(k: int, h: int, n_freqs: int) -> None:
    """Raise unless the CUDA kernel takes these shapes: H in
    `_build.DECODE_H`, 6 octaves, K a multiple of 4 (any number of rays)."""
    _build.check_decode_shapes(k, h, n_freqs, KERNEL_SAMPLES, "selfview")


def softplus(x):
    """jax.nn.softplus: max(x, 0) + log1p(exp(-|x|)), as the kernel has it."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def selfview_density_plain(h_static, coord, w_z, b_in, w_out, b_out, *,
                           n_freqs: int, freq_factor: float):
    """h_static (B, H), coord (B, K), w_z (13, H) in the GROUPED code order
    [c, sin f1..fF, cos f1..fF], b_in, w_out (H,), b_out (1,): f32
    -> sigma (B, K) f32."""
    freqs = torch.as_tensor(freq_factor * 2.0 ** np.arange(n_freqs),
                            dtype=coord.dtype, device=coord.device)
    sc = coord[..., None] * freqs
    code = torch.cat([coord[..., None], torch.sin(sc), torch.cos(sc)], -1)
    h = torch.relu(code @ w_z + h_static[:, None, :] + b_in)
    return softplus(torch.sum(h * w_out, -1) + b_out)


def selfview_density(h_static, coord, w_z, b_in, w_out, b_out, *,
                     n_freqs: int, freq_factor: float):
    """Fused f32 density (same arguments as `selfview_density_plain`)."""
    if coord.device.type == "cpu":
        return selfview_density_plain(h_static, coord, w_z, b_in, w_out,
                                      b_out, n_freqs=n_freqs,
                                      freq_factor=freq_factor)
    b, k = coord.shape
    h = h_static.shape[1]
    check_shapes(k, h, n_freqs)
    dev = coord.device
    f32 = torch.float32
    # float4 loads of h_static rows and coord groups
    _build.require(h_static, "h_static", f32, (b, h), dev, align=16)
    _build.require(coord, "coord", f32, (b, k), dev, align=16)
    _build.require(w_z, "w_z", f32, (1 + 2 * n_freqs, h), dev)
    _build.require(b_in, "b_in", f32, (h,), dev)
    _build.require(w_out, "w_out", f32, (h,), dev)
    _build.require(b_out, "b_out", f32, (1,), dev)
    sigma = torch.empty((b, k), dtype=f32, device=dev)
    if b == 0 or k == 0:
        return sigma
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.bts_selfview_density(
            h_static.data_ptr(), coord.data_ptr(), w_z.data_ptr(),
            b_in.data_ptr(), w_out.data_ptr(), b_out.data_ptr(),
            sigma.data_ptr(), b, k, h, n_freqs, float(freq_factor),
            torch.cuda.current_stream().cuda_stream)
        tracing.count("launches.selfview")
    _build.check(err, "selfview_density")
    return sigma

