"""Field MLPs: ResnetFC and ImplicitNet (counterpart of
behindthescenes_tpu/models/mlp.py:100-274).

Parameter names follow the reference's torch modules (resnetfc.py:
lin_in, blocks.i.fc_0/fc_1/shortcut, lin_out; pixelNeRF's ImplicitNet:
lin0, lin1, ...). `dtype` is the compute dtype of the matmuls (parameters
stay f32), as in the JAX package.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from behindthescenes_tpu_torch import tracing
from behindthescenes_tpu_torch.ops.kernels.jitter_density import \
    jitter_density
from behindthescenes_tpu_torch.ops.kernels.selfview import (
    grouped_code_weights, selfview_density)
from behindthescenes_tpu_torch.ops.kernels.shared_z import (
    shared_z_tail, shared_z_tail_plain)


def _dense(lin: nn.Linear, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """`lin` computed in `dtype` (default: the promotion of the input's
    and the parameters' dtypes, as a Flax Dense with dtype=None). In bf16
    the product is rounded before the bias is added, as Flax adds it: a
    fused bias rounds once and lands one ulp off in about 15% of a query's
    densities."""
    dt = dtype or torch.promote_types(x.dtype, lin.weight.dtype)
    if dt not in (torch.bfloat16, torch.float16) or lin.bias is None:
        bias = None if lin.bias is None else lin.bias.to(dt)
        return F.linear(x.to(dt), lin.weight.to(dt), bias)
    return F.linear(x.to(dt), lin.weight.to(dt)) + lin.bias.to(dt)


def _act(v, beta: float):
    return F.softplus(beta * v) / beta if beta > 0 else torch.relu(v)


def combine_interleaved(t, inner_dims: Sequence[int] = (1,),
                        agg_type: str = "average"):
    """Multiview reduction of pixelNeRF-style combining (reference
    util.py:458-468)."""
    if len(inner_dims) == 1 and inner_dims[0] == 1:
        return t
    t = t.reshape((-1,) + tuple(inner_dims) + tuple(t.shape[1:]))
    if agg_type == "average":
        return t.mean(dim=1)
    if agg_type == "max":
        return t.amax(dim=1)
    raise NotImplementedError(f"Unsupported combine type {agg_type}")


class ResnetBlockFC(nn.Module):
    """Fully-connected ResNet block (reference resnetfc.py:10-62)."""

    def __init__(self, size_in: int, size_out: int | None = None,
                 size_h: int | None = None, beta: float = 0.0):
        super().__init__()
        size_out = size_out or size_in
        size_h = size_h or min(size_in, size_out)
        self.beta = beta
        self.fc_0 = nn.Linear(size_in, size_h)
        self.fc_1 = nn.Linear(size_h, size_out)
        nn.init.zeros_(self.fc_1.weight)
        self.shortcut = None if size_in == size_out else \
            nn.Linear(size_in, size_out, bias=False)

    def forward(self, x):
        net = _dense(self.fc_0, _act(x, self.beta))
        dx = _dense(self.fc_1, _act(net, self.beta))
        x_s = x if self.shortcut is None else _dense(self.shortcut, x)
        return x_s + dx


class ResnetFC(nn.Module):
    """Residual FC field network (reference resnetfc.py:65-198), with the
    split entry points of the self-view decode."""

    def __init__(self, d_in: int, d_out: int = 4, n_blocks: int = 5,
                 d_hidden: int = 128, beta: float = 0.0,
                 combine_layer: int = 1000, combine_type: str = "average",
                 dtype=None):
        super().__init__()
        self.d_out = d_out
        self.n_blocks = n_blocks
        self.beta = beta
        self.combine_layer = combine_layer
        self.combine_type = combine_type
        self.dtype = dtype
        self.lin_in = nn.Linear(d_in, d_hidden)
        self.lin_out = nn.Linear(d_hidden, d_out)
        self.blocks = nn.ModuleList(
            [ResnetBlockFC(d_hidden, beta=beta) for _ in range(n_blocks)])

    def _tail(self, x, combine_inner_dims=(1,)):
        for blkid in range(self.n_blocks):
            if blkid == self.combine_layer:
                x = combine_interleaved(x, combine_inner_dims,
                                        self.combine_type)
            x = self.blocks[blkid](x)
        return _dense(self.lin_out, _act(x, self.beta), self.dtype)

    def forward(self, x, combine_inner_dims: Sequence[int] = (1,)):
        return self._tail(_dense(self.lin_in, x, self.dtype),
                          combine_inner_dims)

    def split_lin_in(self, rows_static, rows_dynamic):
        """lin_in's rows for the static and the per-sample inputs, as
        (in, hidden) matrices, and its bias."""
        w = self.lin_in.weight.t()
        dev = w.device
        return (w[tracing.to_device(rows_static, dev)],
                w[tracing.to_device(rows_dynamic, dev)],
                self.lin_in.bias)

    def static_hidden(self, x_static, w_s):
        dt = self.dtype or x_static.dtype
        return x_static.to(dt) @ w_s.to(dt)

    def call_split(self, x_static, x_dynamic, rows_static, rows_dynamic):
        """lin_in over a split input with the static half hoisted:
        x_static (..., cs) per ray, x_dynamic (..., K, cd) per sample."""
        w_s, w_d, bias = self.split_lin_in(rows_static, rows_dynamic)
        dt = self.dtype or x_static.dtype
        h_static = self.static_hidden(x_static, w_s)
        h_dyn = x_dynamic.to(dt) @ w_d.to(dt)
        return self._tail(h_static[..., None, :] + h_dyn + bias.to(dt))

    def fusable(self) -> bool:
        return self.n_blocks == 0 and self.beta == 0

    def density_column(self):
        return (self.lin_out.weight[0].contiguous(),
                self.lin_out.bias[:1].float().contiguous())

    def call_split_jitter(self, x_static, coord, rows_static, rows_dynamic,
                          *, n_freqs: int, freq_factor: float):
        """Jittered decode in bf16 through the jitter_density kernel:
        x_static (B, cs), coord (B, K) -> (B, K) logits of the density
        column. Needs n_blocks == 0, beta == 0 and the interleaved code
        layout with the input included."""
        assert self.fusable()
        w_s, w_d, bias = self.split_lin_in(rows_static, rows_dynamic)
        h_static = self.static_hidden(x_static, w_s).contiguous()
        w_out, b_out = self.density_column()
        bf = torch.bfloat16
        return jitter_density(coord.float().contiguous(), h_static,
                              w_d.to(bf), bias.to(bf), w_out.to(bf), b_out,
                              n_freqs=n_freqs, freq_factor=freq_factor)

    def call_split_selfview(self, x_static, coord, rows_static, rows_dynamic,
                            *, n_freqs: int, freq_factor: float):
        """Jittered decode in f32 through the selfview kernel: x_static
        (B, cs), coord (B, K) -> softplus density (B, K)."""
        assert self.fusable()
        w_s, w_d, bias = self.split_lin_in(rows_static, rows_dynamic)
        h_static = self.static_hidden(x_static, w_s).float().contiguous()
        w_out, b_out = self.density_column()
        return selfview_density(h_static, coord.float().contiguous(),
                                grouped_code_weights(w_d, n_freqs), bias,
                                w_out, b_out, n_freqs=n_freqs,
                                freq_factor=freq_factor)

    def call_split_shared(self, x_static, x_dynamic_shared, rows_static,
                          rows_dynamic):
        """call_split with per-sample inputs SHARED across rays: x_static
        (B, cs), x_dynamic_shared (K, cd) -> (B, K, d_out). With no blocks
        the tail is `shared_z_tail_jnp`'s function, as in the JAX package
        (behindthescenes_tpu/models/mlp.py:206-213): relu(h_static + h_dyn)
        in the compute dtype, w_out cast to it, the projection and b_out in
        f32. One density column runs in the shared_z kernel; other d_out
        take the plain f32 contraction, where the JAX package too takes its
        jnp formulation."""
        w_s, w_d, bias = self.split_lin_in(rows_static, rows_dynamic)
        dt = self.dtype or x_static.dtype
        h_static = self.static_hidden(x_static, w_s)                # (B, H)
        h_dyn = x_dynamic_shared.to(dt) @ w_d.to(dt) + bias.to(dt)  # (K, H)
        if self.fusable():
            tail = shared_z_tail if self.d_out == 1 else shared_z_tail_plain
            return tail(h_static.contiguous(), h_dyn.contiguous(),
                        self.lin_out.weight.t().to(dt).contiguous(),
                        self.lin_out.bias.float())
        return self._tail(h_static[:, None, :] + h_dyn[None, :, :])


class ImplicitNet(nn.Module):
    """IGR-style MLP with skip connections (reference mlp.py:9-137)."""

    def __init__(self, d_in: int, d_out: int = 4,
                 dims: Sequence[int] = (128, 128, 128, 128),
                 skip_in: Sequence[int] = (), combine_layer: int = 1000,
                 combine_type: str = "average", beta: float = 0.0):
        super().__init__()
        self.dims = [d_in] + list(dims) + [d_out]
        self.skip_in = tuple(skip_in)
        self.combine_layer = combine_layer
        self.combine_type = combine_type
        self.beta = beta
        for layer in range(len(self.dims) - 1):
            d = self.dims[layer] + (d_in if layer in self.skip_in else 0)
            setattr(self, f"lin{layer}", nn.Linear(d, self.dims[layer + 1]))

    def forward(self, x, combine_inner_dims: Sequence[int] = (1,)):
        x_init = x
        for layer in range(len(self.dims) - 1):
            if layer == self.combine_layer:
                x = combine_interleaved(x, combine_inner_dims,
                                        self.combine_type)
                x_init = combine_interleaved(x_init, combine_inner_dims,
                                             self.combine_type)
            if layer in self.skip_in:
                x = torch.cat([x, x_init], dim=-1) / np.sqrt(2.0)
            x = _dense(getattr(self, f"lin{layer}"), x)
            if layer < len(self.dims) - 2:
                x = _act(x, self.beta)
        return x


def make_mlp(conf: dict, d_in: int, d_out: int = 4,
             allow_empty: bool = False, dtype=None):
    """MLP factory (reference mlp_util.py:5-15): type mlp | resnet | empty.
    Unlike Flax, torch needs the input width `d_in` up front."""
    mlp_type = conf.get("type", "mlp")
    if mlp_type == "mlp":
        return ImplicitNet(
            d_in, d_out=d_out, dims=tuple(conf.get("dims", [128] * 4)),
            skip_in=tuple(conf.get("skip_in", ())),
            combine_layer=conf.get("combine_layer", 1000),
            combine_type=conf.get("combine_type", "average"),
            beta=conf.get("beta", 0.0))
    if mlp_type == "resnet":
        return ResnetFC(
            d_in, d_out=d_out, n_blocks=conf.get("n_blocks", 5),
            d_hidden=conf.get("d_hidden", 128), beta=conf.get("beta", 0.0),
            combine_layer=conf.get("combine_layer", 1000),
            combine_type=conf.get("combine_type", "average"), dtype=dtype)
    if mlp_type == "empty" and allow_empty:
        return None
    raise NotImplementedError(f"Unsupported MLP type: {mlp_type}")
