"""Jittered self-view density decode in bf16 (logits before softplus).

Counterpart of behindthescenes_tpu/ops/pallas/jitter_density.py. On a
CUDA tensor `jitter_density` launches the hand-written kernel
csrc/jitter_density.cu; on a CPU tensor it runs `jitter_density_plain`,
the JAX package's `jitter_density_jnp` written as plain tensors (it
materializes the (B, K, 13) code and the (B, K, H) hidden).
"""
from __future__ import annotations

import numpy as np
import torch

from behindthescenes_tpu_torch.ops.kernels import _build


def interleave_to_grouped(n_freqs: int) -> np.ndarray:
    """Row permutation taking the PositionalEncoding layout
    [id, sin f1, cos f1, sin f2, cos f2, ...] to the grouped
    [id, sin f1..fF, cos f1..fF]."""
    return np.concatenate([[0], 1 + 2 * np.arange(n_freqs),
                           2 + 2 * np.arange(n_freqs)]).astype(np.int64)


def jitter_density_plain(coord, h_static, w_d, b_in, w_out, b_out, *,
                         n_freqs: int, freq_factor: float):
    """coord (B, K) f32; h_static (B, H); w_d (13, H) in the INTERLEAVED
    code order; b_in, w_out (H,); b_out (1,) f32 -> logits (B, K) f32,
    rounded to bf16 where jitter_density_jnp rounds."""
    freqs = torch.as_tensor(freq_factor * 2.0 ** np.arange(n_freqs),
                            dtype=coord.dtype, device=coord.device)
    scaled = coord[..., None] * freqs                           # (B, K, F)
    emb = torch.stack([torch.sin(scaled), torch.cos(scaled)], -1) \
        .reshape(coord.shape + (2 * n_freqs,))
    code = torch.cat([coord[..., None], emb], -1)               # (B, K, 13)
    bf = torch.bfloat16
    hd = code.to(bf) @ w_d.to(bf)                               # (B, K, H)
    x = h_static.to(bf)[:, None, :] + hd + b_in.to(bf)
    out = torch.relu(x) @ w_out.to(bf)[:, None]
    return out[..., 0].float() + b_out


def jitter_density(coord, h_static, w_d, b_in, w_out, b_out, *,
                   n_freqs: int, freq_factor: float):
    """Fused density logits for per-ray z codes (same arguments as
    `jitter_density_plain`; h_static in bf16 on the card, the small
    weights are rounded to bf16 here)."""
    if coord.device.type == "cpu":
        return jitter_density_plain(coord, h_static, w_d, b_in, w_out, b_out,
                                    n_freqs=n_freqs, freq_factor=freq_factor)
    if n_freqs != 6:
        raise ValueError(f"n_freqs={n_freqs}: the CUDA kernel is built for "
                         "6 octaves, as every shipped config uses")
    b, k = coord.shape
    h = h_static.shape[1]
    dev = coord.device
    bf = torch.bfloat16
    w_d, b_in, w_out = (t.to(bf).contiguous() for t in (w_d, b_in, w_out))
    _build.require(coord, "coord", torch.float32, (b, k), dev)
    _build.require(h_static, "h_static", bf, (b, h), dev)
    _build.require(w_d, "w_d", bf, (1 + 2 * n_freqs, h), dev)
    _build.require(b_in, "b_in", bf, (h,), dev)
    _build.require(w_out, "w_out", bf, (h,), dev)
    _build.require(b_out, "b_out", torch.float32, (1,), dev)
    out = torch.empty((b, k), dtype=torch.float32, device=dev)
    if b == 0 or k == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.bts_jitter_density(
            coord.data_ptr(), h_static.data_ptr(), w_d.data_ptr(),
            b_in.data_ptr(), w_out.data_ptr(), b_out.data_ptr(),
            out.data_ptr(), b, k, h, n_freqs, float(freq_factor),
            torch.cuda.current_stream().cuda_stream)
        jitter_density.launches += 1
    _build.check(err, "jitter_density")
    return out


jitter_density.launches = 0
