"""Differentiable volume renderer (counterpart of
behindthescenes_tpu/renderer.py): stratified coarse sampling,
alpha-compositing weights, the coarse render pass over rays, chunked
full-frame rendering and the sample-count schedule.

Random draws come from an explicit `torch.Generator`, or are passed in as
data: `render_rays` takes the coarse jitter `z_jitter` (..., K), uniform
in [0, 1), the draw the JAX package makes with `jax.random.uniform`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint


@dataclasses.dataclass(frozen=True)
class RendererConfig:
    """Mirrors the JAX RendererConfig (reference nerf.py:65-101). The port
    renders the coarse pass; a config with n_fine > 0 is refused by
    `render_rays`."""
    n_coarse: int = 128
    n_fine: int = 0
    n_fine_depth: int = 0
    noise_std: float = 0.0
    depth_std: float = 0.01
    white_bkgd: bool = False
    lindisp: bool = False
    hard_alpha_cap: bool = False
    sched: Optional[Tuple] = None
    fine_reuse_coarse: bool = False

    @property
    def using_fine(self) -> bool:
        return self.n_fine > 0

    @classmethod
    def from_conf(cls, conf: dict,
                  white_bkgd: bool = False) -> "RendererConfig":
        """behindthescenes_tpu/renderer.py:47-63, defaults included
        (lindisp is on unless the config says otherwise)."""
        sched = conf.get("sched", None)
        if sched is not None and len(sched) == 0:
            sched = None
        return cls(
            n_coarse=conf.get("n_coarse", 128),
            n_fine=conf.get("n_fine", 0),
            n_fine_depth=conf.get("n_fine_depth", 0),
            noise_std=conf.get("noise_std", 0.0),
            depth_std=conf.get("depth_std", 0.01),
            white_bkgd=conf.get("white_bkgd", white_bkgd),
            lindisp=conf.get("lindisp", True),
            hard_alpha_cap=conf.get("hard_alpha_cap", False),
            sched=tuple(map(tuple, sched)) if sched is not None else None,
            fine_reuse_coarse=conf.get("fine_reuse_coarse", False))


def _z_from_steps(rays, z_steps, lindisp):
    near, far = rays[..., 6:7], rays[..., 7:8]
    if lindisp:
        return 1.0 / (1.0 / near * (1.0 - z_steps) + 1.0 / far * z_steps)
    return near * (1.0 - z_steps) + far * z_steps


def sample_coarse(rays, n_coarse: int, lindisp: bool,
                  generator: torch.Generator | None = None,
                  z_jitter: torch.Tensor | None = None):
    """Stratified sampling (reference nerf.py:103-123): rays (..., 8)
    -> z (..., Kc), one uniform jitter per bin: z_jitter (..., Kc) when
    given, else drawn from `generator`."""
    step = 1.0 / n_coarse
    z_steps = torch.linspace(0.0, 1.0 - step, n_coarse, dtype=rays.dtype,
                             device=rays.device)
    shape = rays.shape[:-1] + (n_coarse,)
    if z_jitter is None:
        z_jitter = torch.rand(shape, generator=generator, dtype=rays.dtype,
                              device=rays.device)
    elif tuple(z_jitter.shape) != shape:
        raise ValueError(f"z_jitter {tuple(z_jitter.shape)} for samples "
                         f"{shape}")
    z_steps = z_steps + z_jitter.to(rays.dtype) * step
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


def composite(query_fn: Callable, rays, z_samp, cfg: RendererConfig,
              coarse: bool = True,
              generator: torch.Generator | None = None) -> dict:
    """Alpha-composite the field along rays (reference nerf.py:210-313).

    query_fn: (xyz (n, P, 3), coarse) -> (rgb (n, P, v*3), invalid (n, P,
    v), sigma (n, P, 1)); rays (n, B, 8); z_samp (n, B, K). Returns
    weights (n, B, K), rgb (n, B, v*3), depth (n, B), alphas (n, B, K),
    invalid (n, B, K, v), z_samps, rgb_samps (n, B, K, v*3) and sigmas."""
    n, b, k = z_samp.shape
    points = rays[..., None, :3] + z_samp[..., None] * rays[..., None, 3:6]
    rgbs, invalid, sigmas = query_fn(points.reshape(n, b * k, 3), coarse)
    rgbs = rgbs.reshape(n, b, k, rgbs.shape[-1])
    invalid = invalid.reshape(n, b, k, invalid.shape[-1])
    sigmas = sigmas.reshape(n, b, k)
    if cfg.noise_std > 0.0:
        sigmas = sigmas + torch.randn(sigmas.shape, generator=generator,
                                      dtype=sigmas.dtype,
                                      device=sigmas.device) * cfg.noise_std
    weights, alphas = weights_from_sigma(sigmas, z_samp, cfg)
    rgb_final = torch.sum(weights[..., None] * rgbs, -2)
    depth_final = torch.sum(weights * z_samp, -1)
    if cfg.white_bkgd:
        rgb_final = rgb_final + (1.0 - weights.sum(-1)[..., None])
    return {"weights": weights, "rgb": rgb_final, "depth": depth_final,
            "alphas": alphas, "invalid": invalid, "z_samps": z_samp,
            "rgb_samps": rgbs, "sigmas": sigmas}


def _prune(out: dict, want_weights, want_alphas, want_z_samps,
           want_rgb_samps) -> dict:
    res = {"rgb": out["rgb"], "depth": out["depth"], "invalid": out["invalid"]}
    for key, want in (("weights", want_weights), ("alphas", want_alphas),
                      ("z_samps", want_z_samps),
                      ("rgb_samps", want_rgb_samps)):
        if want:
            res[key] = out[key]
    return res


def render_rays(query_fn: Callable, rays, cfg: RendererConfig,
                generator: torch.Generator | None = None,
                z_jitter: torch.Tensor | None = None,
                want_weights: bool = False, want_alphas: bool = False,
                want_z_samps: bool = False,
                want_rgb_samps: bool = False) -> dict:
    """The coarse render pass (reference nerf.py:315-375). rays (n, B, 8);
    z_jitter (n, B, n_coarse), else drawn from `generator`. Returns
    {"coarse": {...}}."""
    if cfg.using_fine:
        raise NotImplementedError(
            "the fine pass (n_fine > 0) is not ported: ROADMAP Queue A "
            "item 4")
    z_coarse = sample_coarse(rays, cfg.n_coarse, cfg.lindisp, generator,
                             z_jitter)
    out = composite(query_fn, rays, z_coarse, cfg, coarse=True,
                    generator=generator)
    return {"coarse": _prune(out, want_weights, want_alphas, want_z_samps,
                             want_rgb_samps)}


def render_rays_chunked(query_fn: Callable, rays, cfg: RendererConfig,
                        ray_chunk: int = 16384, remat_body: bool = False,
                        generator: torch.Generator | None = None,
                        z_jitter: torch.Tensor | None = None,
                        **want) -> dict:
    """Full-frame rendering as a loop over chunks of `ray_chunk` rays
    (the JAX package's `lax.map` over chunks, renderer.py:363-442), which
    bounds the memory of the per-sample tensors. remat_body re-runs each
    chunk's query in the backward pass instead of keeping its activations
    (torch.utils.checkpoint). z_jitter (n, B, n_coarse) is cut along with
    the rays. rays (n, B, 8); returns what render_rays returns."""
    b = rays.shape[1]

    def body(chunk_rays, chunk_jitter):
        return render_rays(query_fn, chunk_rays, cfg, generator,
                           chunk_jitter, **want)

    outs = []
    for lo in range(0, b, ray_chunk):
        args = (rays[:, lo:lo + ray_chunk],
                None if z_jitter is None else z_jitter[:, lo:lo + ray_chunk])
        if remat_body and torch.is_grad_enabled():
            outs.append(checkpoint(body, *args, use_reentrant=False))
        else:
            outs.append(body(*args))
    if len(outs) == 1:
        return outs[0]
    return {branch: {key: torch.cat([o[branch][key] for o in outs], 1)
                     for key in outs[0][branch]} for branch in outs[0]}


class SampleScheduler:
    """Sample-count schedule (reference nerf.py:403-423)."""

    def __init__(self, cfg: RendererConfig):
        self.cfg = cfg
        self.iter_idx = 0
        self.last_sched = 0

    def step(self, steps: int = 1) -> RendererConfig:
        sched = self.cfg.sched
        if sched is None:
            return self.cfg
        self.iter_idx += steps
        n_coarse, n_fine = self.cfg.n_coarse, self.cfg.n_fine
        while (self.last_sched < len(sched[0])
               and self.iter_idx >= sched[0][self.last_sched]):
            n_coarse = sched[1][self.last_sched]
            n_fine = sched[2][self.last_sched]
            self.last_sched += 1
        if (n_coarse, n_fine) != (self.cfg.n_coarse, self.cfg.n_fine):
            self.cfg = dataclasses.replace(self.cfg, n_coarse=n_coarse,
                                           n_fine=n_fine)
        return self.cfg

    def state_dict(self):
        return {"iter_idx": self.iter_idx, "last_sched": self.last_sched}

    def load_state_dict(self, d):
        self.iter_idx = int(d["iter_idx"])
        self.last_sched = int(d["last_sched"])
