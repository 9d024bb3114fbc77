"""Volume-rendering core of the self-view depth path (counterpart of
behindthescenes_tpu/renderer.py:20-92, 151-185): stratified coarse
sampling and alpha-compositing weights."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RendererConfig:
    """The fields of the JAX RendererConfig that the self-view depth
    render reads (reference nerf.py:65-101)."""
    n_coarse: int = 128
    lindisp: bool = False
    hard_alpha_cap: bool = False


def _z_from_steps(rays, z_steps, lindisp):
    near, far = rays[..., 6:7], rays[..., 7:8]
    if lindisp:
        return 1.0 / (1.0 / near * (1.0 - z_steps) + 1.0 / far * z_steps)
    return near * (1.0 - z_steps) + far * z_steps


def sample_coarse(rays, n_coarse: int, lindisp: bool,
                  generator: torch.Generator | None = None):
    """Stratified sampling (reference nerf.py:103-123): rays (..., 8)
    -> z (..., Kc), one uniform jitter per bin drawn from `generator`."""
    step = 1.0 / n_coarse
    z_steps = torch.linspace(0.0, 1.0 - step, n_coarse, dtype=rays.dtype,
                             device=rays.device)
    shape = rays.shape[:-1] + (n_coarse,)
    z_steps = z_steps + torch.rand(shape, generator=generator,
                                   dtype=rays.dtype,
                                   device=rays.device) * step
    return _z_from_steps(rays, z_steps, lindisp)


def weights_from_sigma(sigma, z_samp, cfg: RendererConfig):
    """Alpha-compositing weights from densities (nerf.py:283-294).

    sigma, z_samp: (..., K) -> (weights, alphas), each (..., K). The
    transmittance floor is the clamp log(max(1 - alpha, 1e-10)), not the
    reference's `+ 1e-10`, as in the JAX package."""
    deltas = z_samp[..., 1:] - z_samp[..., :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[..., :1], 1e10)], -1)
    alphas = 1.0 - torch.exp(-deltas.abs() * torch.relu(sigma))
    if cfg.hard_alpha_cap:
        alphas = torch.cat([alphas[..., :-1],
                            torch.ones_like(alphas[..., -1:])], -1)
    log_terms = torch.log(torch.clamp_min(1.0 - alphas, 1e-10))
    # Exclusive cumulative sum: T_k = prod_{j<k} (1 - alpha_j).
    log_t = torch.cat([torch.zeros_like(log_terms[..., :1]),
                       torch.cumsum(log_terms[..., :-1], dim=-1)], -1)
    return alphas * torch.exp(log_t), alphas
