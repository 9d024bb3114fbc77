"""Jittered self-view density decode in bf16 (logits before softplus).

Counterpart of behindthescenes_tpu/ops/pallas/jitter_density.py. On a
CUDA tensor `jitter_density` launches a hand-written kernel of
csrc/jitter_density.cu: the tensor-core kernel for the shapes it is built
for, the runtime-shape kernel for any other hidden width or octave count
(`kernel_for` picks from the shapes before the launch). On a CPU tensor it
runs `jitter_density_plain`, the JAX package's `jitter_density_jnp`
written as plain tensors (it materializes the (B, K, 13) code and the
(B, K, H) hidden).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from behindthescenes_tpu_torch import tracing
from behindthescenes_tpu_torch.ops.kernels import _build

# The kernel's code columns: the k dimension of its m16n8k16 products.
CODE_COLUMNS = 16


def mma_code_columns() -> np.ndarray:
    """For each of the kernel's 16 code columns, the row of the interleaved
    code (6 octaves) it holds, or -1 for a zero pad column. Lane t of a
    quad holds columns 2t, 2t+1, 2t+8, 2t+9: lanes t = 0, 1, 2 sin and cos
    of octaves 2t and 2t+1, lane 3 the input c in column 6 and the three
    pad columns."""
    cols = np.full(CODE_COLUMNS, -1, np.int64)
    for t in range(3):
        for octave, col in ((2 * t, 2 * t), (2 * t + 1, 2 * t + 8)):
            cols[col] = 1 + 2 * octave          # sin
            cols[col + 1] = 2 + 2 * octave      # cos
    cols[6] = 0                                 # the input c itself
    return cols


@functools.lru_cache(maxsize=None)
def _packed_rows(device: torch.device) -> torch.Tensor:
    """`mma_code_columns` on `device`, pads pointing at the zero row 13."""
    cols = mma_code_columns()
    n_code = 1 + 2 * _build.DECODE_N_FREQS
    return torch.as_tensor(np.where(cols >= 0, cols, n_code), device=device)


def pack_code_weights(w_d):
    """W_d (13, H) in the interleaved code order -> (16, H) with its rows
    in the kernel's code column order and zero rows at the pad columns
    (two small launches on the card; the row index stays there)."""
    return F.pad(w_d, (0, 0, 0, 1))[_packed_rows(w_d.device)]


def check_shapes(k: int, h: int, n_freqs: int) -> None:
    """Raise unless the tensor-core kernel takes these shapes: H in
    `_build.DECODE_H`, 6 octaves (any K, any number of rays)."""
    _build.check_decode_shapes(k, h, n_freqs, 1, "jitter_density")


# The runtime-shape kernel's octave counts (csrc/jitter_density.cu kMaxNF).
ANY_MAX_FREQS = 16


def kernel_for(h: int, n_freqs: int) -> str:
    """Which kernel a CUDA call launches: "mma" (the tensor-core kernel,
    built for H in `_build.DECODE_H` and 6 octaves) or "any" (the
    runtime-shape kernel, any H and 1 to 16 octaves)."""
    if h in _build.DECODE_H and n_freqs == _build.DECODE_N_FREQS:
        return "mma"
    if not 1 <= n_freqs <= ANY_MAX_FREQS:
        raise ValueError(f"jitter_density: n_freqs={n_freqs}, the CUDA "
                         f"kernels take 1 to {ANY_MAX_FREQS} octaves")
    return "any"


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
    `jitter_density_plain`; on the card h_static, w_d, b_in and w_out come
    in bf16, as the plain version rounds them)."""
    if coord.device.type == "cpu":
        return jitter_density_plain(coord, h_static, w_d, b_in, w_out, b_out,
                                    n_freqs=n_freqs, freq_factor=freq_factor)
    b, k = coord.shape
    h = h_static.shape[1]
    mma = kernel_for(h, n_freqs) == "mma"
    dev = coord.device
    bf = torch.bfloat16
    _build.require(w_d, "w_d", bf, (1 + 2 * n_freqs, h), dev)
    w_pack = pack_code_weights(w_d) if mma else w_d
    _build.require(coord, "coord", torch.float32, (b, k), dev)
    # bf16x2 loads of h_static rows and b_in
    _build.require(h_static, "h_static", bf, (b, h), dev, align=4)
    _build.require(b_in, "b_in", bf, (h,), dev, align=4)
    _build.require(w_out, "w_out", bf, (h,), dev)
    _build.require(b_out, "b_out", torch.float32, (1,), dev)
    out = torch.empty((b, k), dtype=torch.float32, device=dev)
    if b == 0 or k == 0:
        return out
    lib = _build.library()
    launch = lib.bts_jitter_density if mma else lib.bts_jitter_density_any
    with torch.cuda.device(dev):
        err = launch(
            coord.data_ptr(), h_static.data_ptr(), w_pack.data_ptr(),
            b_in.data_ptr(), w_out.data_ptr(), b_out.data_ptr(),
            out.data_ptr(), b, k, h, n_freqs, float(freq_factor),
            torch.cuda.current_stream().cuda_stream)
        tracing.count("launches.jitter_density")
    _build.check(err, "jitter_density")
    return out

