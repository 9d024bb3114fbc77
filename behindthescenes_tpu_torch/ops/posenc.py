"""NeRF sinusoidal positional encoding (counterpart of
behindthescenes_tpu/ops/posenc.py:18-72).

Output layout, as the reference's code.py:30-42:
  [x (if include_input), sin(f1 x), cos(f1 x), sin(f2 x), cos(f2 x), ...]
with f_k = freq_factor * 2**k and each block d_in wide.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from behindthescenes_tpu_torch import tracing


@dataclasses.dataclass(frozen=True)
class PositionalEncoding:
    num_freqs: int = 6
    d_in: int = 3
    freq_factor: float = math.pi
    include_input: bool = True

    @property
    def d_out(self) -> int:
        d = self.num_freqs * 2 * self.d_in
        return d + self.d_in if self.include_input else d

    def freqs(self, dtype=torch.float32, device=None) -> torch.Tensor:
        return tracing.to_device(
            self.freq_factor * 2.0 ** np.arange(self.num_freqs), device,
            dtype)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., d_in) -> (..., d_out)."""
        freqs = self.freqs(x.dtype, x.device)
        scaled = x[..., None, :] * freqs[:, None]              # (..., F, d)
        emb = torch.stack([torch.sin(scaled), torch.cos(scaled)], dim=-2)
        emb = emb.reshape(x.shape[:-1] + (self.num_freqs * 2 * self.d_in,))
        if self.include_input:
            emb = torch.cat([x, emb], dim=-1)
        return emb

    def subset(self, dims) -> "PositionalEncoding":
        """Encoder for a subset of input dims (same freqs/layout rules)."""
        return PositionalEncoding(self.num_freqs, len(dims),
                                  self.freq_factor, self.include_input)

    def subset_rows(self, dims) -> np.ndarray:
        """Output rows of the full encoding that belong to input `dims`,
        ordered as `self.subset(dims)` emits them."""
        rows = list(dims) if self.include_input else []
        off = self.d_in if self.include_input else 0
        for k in range(self.num_freqs):
            base = off + 2 * self.d_in * k
            rows += [base + j for j in dims]               # sin block
            rows += [base + self.d_in + j for j in dims]   # cos block
        return np.asarray(rows, dtype=np.int64)

    @classmethod
    def from_conf(cls, conf: dict, d_in: int = 3) -> "PositionalEncoding":
        return cls(num_freqs=conf.get("num_freqs", 6), d_in=d_in,
                   freq_factor=conf.get("freq_factor", math.pi),
                   include_input=conf.get("include_input", True))
