"""The precision in which the reference computes its convolutions and
matrix products.

`Precision("float32")` is the reference proper: float32 products with
TF32 off (the caller sets `torch.backends.*.allow_tf32 = False`, see
`port_bench.reference.set_exact`). `Precision("fp8")` is the control, the
same reference computed in fp8, the step below the program's bfloat16,
as an fp8 training recipe computes: both operands of every convolution
and dense layer rounded to float8 e4m3, and the gradient that flows back
into each of them rounded to float8 e5m2, each under a per-tensor scale
(the tensor's largest magnitude mapped to the format's largest finite
value); the coordinates that enter the positional code are rounded to
e4m3 too, as the program rounds them to its compute dtype. Rounding an
operand passes its gradient straight through.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x: torch.Tensor, fmt, top) -> torch.Tensor:
    if top is None:                     # a format with an exponent per value
        return x.to(fmt).to(x.dtype)
    amax = x.abs().amax().clamp_min(1e-30)
    scale = top / amax
    return (x * scale).to(fmt).to(x.dtype) / scale


FORMATS = {"fp8": ((torch.float8_e4m3fn, E4M3_MAX),
                   (torch.float8_e5m2, E5M2_MAX)),
           "bfloat16": ((torch.bfloat16, None), (torch.bfloat16, None))}


def rounded(x: torch.Tensor, fmt, top: float) -> torch.Tensor:
    """x rounded to the format under a per-tensor scale, in x's dtype;
    the gradient passes through unchanged."""
    return x + (_round(x.detach(), fmt, top) - x.detach())


class _GradRound(torch.autograd.Function):
    """Identity forward; the incoming gradient rounded to a format."""

    @staticmethod
    def forward(ctx, x, fmt, top):
        ctx.fmt, ctx.top = fmt, top
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.fmt, ctx.top), None, None


class Precision:
    def __init__(self, name: str = "float32"):
        if name not in ("float32", "float64", *FORMATS):
            raise ValueError(f"unknown reference precision {name!r}")
        self.name = name
        self.fwd, self.bwd = FORMATS.get(name, (None, None))

    def _q(self, t):
        return rounded(t, *self.fwd) if self.fwd else t

    def _g(self, t):
        if self.bwd and t.requires_grad:
            return _GradRound.apply(t, *self.bwd)
        return t

    def conv2d(self, x, w, b=None, stride: int = 1, padding: int = 0):
        return self._g(F.conv2d(self._q(x), self._q(w), b, stride, padding))

    def linear(self, x, w, b=None):
        return self._g(F.linear(self._q(x), self._q(w), b))

    def code_input(self, x):
        """Coordinates entering the positional code."""
        return self._q(x)
