"""Differentiable volume renderer (counterpart of
behindthescenes_tpu/renderer.py): stratified coarse sampling, importance
and depth-guided fine sampling, alpha-compositing weights, the coarse and
fine render passes over rays (the fine one optionally reusing the coarse
pass's field values), chunked full-frame rendering and the sample-count
schedule.

Random draws come from an explicit `torch.Generator`, or are passed in as
data: `render_rays` takes the coarse jitter `z_jitter` (..., K) and the
fine pass's `FineDraws`, the draws the JAX package makes with
`jax.random.uniform` and `jax.random.normal`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint


@dataclasses.dataclass(frozen=True)
class RendererConfig:
    """Mirrors the JAX RendererConfig (reference nerf.py:65-101).
    fine_reuse_coarse: the fine pass queries only its new samples and
    composites them with the coarse pass's field values (needs
    noise_std == 0; the field is deterministic in position, so the output
    equals the re-query of every sample)."""
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


def _draw(given, shape, like, generator, normal: bool = False):
    """`given` checked against `shape`, else a fresh draw from
    `generator`: uniform in [0, 1), or standard normal."""
    if given is None:
        fn = torch.randn if normal else torch.rand
        return fn(shape, generator=generator, dtype=like.dtype,
                  device=like.device)
    if tuple(given.shape) != tuple(shape):
        raise ValueError(f"draws {tuple(given.shape)} for samples "
                         f"{tuple(shape)}")
    return given.to(like.dtype)


def sample_coarse(rays, n_coarse: int, lindisp: bool,
                  generator: torch.Generator | None = None,
                  z_jitter: torch.Tensor | None = None):
    """Stratified sampling (reference nerf.py:103-123): rays (..., 8)
    -> z (..., Kc), one uniform jitter per bin: z_jitter (..., Kc) when
    given, else drawn from `generator`."""
    step = 1.0 / n_coarse
    z_steps = torch.linspace(0.0, 1.0 - step, n_coarse, dtype=rays.dtype,
                             device=rays.device)
    z_jitter = _draw(z_jitter, rays.shape[:-1] + (n_coarse,), rays,
                     generator)
    z_steps = z_steps + z_jitter * step
    return _z_from_steps(rays, z_steps, lindisp)


@dataclasses.dataclass
class FineDraws:
    """The fine pass's random draws, the JAX package's from `k_fine` and
    `k_fd` (renderer.py:317): u and jitter (..., n_fine - n_fine_depth),
    uniform in [0, 1), for `sample_fine`; normals (..., n_fine_depth),
    standard normal, for `sample_fine_depth`. A field left None is drawn
    from the generator."""
    u: Optional[torch.Tensor] = None
    jitter: Optional[torch.Tensor] = None
    normals: Optional[torch.Tensor] = None

    def cut(self, lo: int, hi: int) -> "FineDraws":
        """The draws of rays lo..hi-1 (axis 1)."""
        return FineDraws(*(None if t is None else t[:, lo:hi]
                           for t in (self.u, self.jitter, self.normals)))


def _searchsorted_right(cdf, u):
    """Batched searchsorted(right=True): the count of cdf entries <= u.

    cdf (..., K+1) ascending; u (..., Kf) -> int64 (..., Kf)."""
    return (cdf[..., None, :] <= u[..., :, None]).sum(-1)


def _cdf(weights):
    """(..., K+1) CDF of the normalised, detached weights + 1e-5, from 0."""
    weights = weights.detach() + 1e-5
    cdf = torch.cumsum(weights / weights.sum(-1, keepdim=True), -1)
    return torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)


def sample_coarse_from_dist(rays, weights, z_samp, n_coarse: int,
                            lindisp: bool,
                            generator: torch.Generator | None = None,
                            u: torch.Tensor | None = None,
                            jitter: torch.Tensor | None = None):
    """Resample n_coarse depths from a coarse weight histogram over z_samp
    (reference nerf.py:125-159): u picks the interval, jitter the place
    in it, both (..., n_coarse) uniform (else drawn from `generator`).
    Returns the sorted depths (..., n_coarse)."""
    cdf = _cdf(weights)
    shape = rays.shape[:-1] + (n_coarse,)
    u = _draw(u, shape, rays, generator)
    ids = torch.clamp(_searchsorted_right(cdf, u) - 1, 0, n_coarse - 1)
    jitter = _draw(jitter, shape, rays, generator)
    if lindisp:
        z_samp = 1.0 / z_samp
    centers = 0.5 * (z_samp[..., 1:] + z_samp[..., :-1])
    borders = torch.cat([z_samp[..., :1], centers, z_samp[..., -1:]], -1)
    left = torch.gather(borders, -1, ids)
    right = torch.gather(borders, -1, ids + 1)
    z_new = left * (1.0 - jitter) + right * jitter
    if lindisp:
        z_new = 1.0 / z_new
    return torch.sort(z_new, -1).values


def sample_fine(rays, weights, n_samples: int, n_coarse: int, lindisp: bool,
                generator: torch.Generator | None = None,
                u: torch.Tensor | None = None,
                jitter: torch.Tensor | None = None):
    """Importance samples from the coarse weights (reference
    nerf.py:161-192): u picks the coarse bin, jitter the place in it, both
    (..., n_samples) uniform (else drawn from `generator`)."""
    cdf = _cdf(weights)
    shape = rays.shape[:-1] + (n_samples,)
    u = _draw(u, shape, rays, generator)
    inds = torch.clamp_min(_searchsorted_right(cdf, u).to(rays.dtype) - 1.0,
                           0.0)
    jitter = _draw(jitter, shape, rays, generator)
    return _z_from_steps(rays, (inds + jitter) / n_coarse, lindisp)


def sample_fine_depth(rays, depth, n_samples: int, depth_std: float,
                      generator: torch.Generator | None = None,
                      normals: torch.Tensor | None = None):
    """Gaussian samples around the expected depth (reference
    nerf.py:194-208), clipped to each ray's [near, far]: normals (...,
    n_samples) standard normal (else drawn from `generator`)."""
    normals = _draw(normals, depth.shape + (n_samples,), rays, generator,
                    normal=True)
    z_samp = depth[..., None] + normals * depth_std
    return torch.minimum(torch.maximum(z_samp, rays[..., 6:7]),
                         rays[..., 7:8])


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


def composite_merged(query_fn: Callable, rays, z_cached, cached: dict,
                     z_new, cfg: RendererConfig, coarse: bool = False) -> dict:
    """The fine pass's composite that reuses the coarse pass's field values
    and queries only the new samples (`fine_reuse_coarse`;
    behindthescenes_tpu/renderer.py:228-300).

    The samples [z_cached, z_new] are composited in depth order, ties
    broken by their index in that concatenation (a stable sort, as
    jnp.sort orders them), so the result equals the re-query of every
    sample up to float reassociation. Per-sample outputs (weights, alphas,
    z_samps, rgb_samps, invalid, sigmas) come back in concatenation order,
    as the JAX package returns them.

    cached: "sigmas" (n, B, Kc), "rgb_samps" (n, B, Kc, v*3) and
    "invalid" (n, B, Kc, v) of the coarse composite."""
    if cfg.noise_std > 0.0:
        raise ValueError("fine_reuse_coarse requires noise_std == 0")
    n, b, kn = z_new.shape
    points = rays[..., None, :3] + z_new[..., None] * rays[..., None, 3:6]
    rgbs_new, invalid_new, sigmas_new = query_fn(
        points.reshape(n, b * kn, 3), coarse)
    z_all = torch.cat([z_cached, z_new], -1)
    sigmas = torch.cat([cached["sigmas"], sigmas_new.reshape(n, b, kn)], -1)
    rgbs = torch.cat([cached["rgb_samps"],
                      rgbs_new.reshape(n, b, kn, rgbs_new.shape[-1])], -2)
    invalid = torch.cat([cached["invalid"], invalid_new.reshape(
        n, b, kn, invalid_new.shape[-1])], -2)
    z_sorted, order = torch.sort(z_all, dim=-1, stable=True)
    w_sorted, a_sorted = weights_from_sigma(
        torch.gather(sigmas, -1, order), z_sorted, cfg)
    back = torch.argsort(order, -1)
    weights = torch.gather(w_sorted, -1, back)
    alphas = torch.gather(a_sorted, -1, back)
    rgb_final = torch.sum(weights[..., None] * rgbs, -2)
    depth_final = torch.sum(weights * z_all, -1)
    if cfg.white_bkgd:
        rgb_final = rgb_final + (1.0 - weights.sum(-1)[..., None])
    return {"weights": weights, "rgb": rgb_final, "depth": depth_final,
            "alphas": alphas, "invalid": invalid, "z_samps": z_all,
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
                fine_draws: FineDraws | None = None,
                want_weights: bool = False, want_alphas: bool = False,
                want_z_samps: bool = False,
                want_rgb_samps: bool = False) -> dict:
    """The coarse and, with n_fine > 0, the fine render pass (reference
    nerf.py:315-375; behindthescenes_tpu/renderer.py:303-360). rays (n, B,
    8); z_jitter (n, B, n_coarse) and fine_draws replace the generator's
    draws. Returns {"coarse": {...}[, "fine": {...}]}."""
    z_coarse = sample_coarse(rays, cfg.n_coarse, cfg.lindisp, generator,
                             z_jitter)
    coarse_out = composite(query_fn, rays, z_coarse, cfg, coarse=True,
                           generator=generator)
    want = (want_weights, want_alphas, want_z_samps, want_rgb_samps)
    outputs = {"coarse": _prune(coarse_out, *want)}
    if cfg.using_fine:
        fd = fine_draws or FineDraws()
        new_samps = []
        if cfg.n_fine - cfg.n_fine_depth > 0:
            new_samps.append(sample_fine(
                rays, coarse_out["weights"], cfg.n_fine - cfg.n_fine_depth,
                cfg.n_coarse, cfg.lindisp, generator, fd.u, fd.jitter))
        if cfg.n_fine_depth > 0:
            new_samps.append(sample_fine_depth(
                rays, coarse_out["depth"], cfg.n_fine_depth, cfg.depth_std,
                generator, fd.normals))
        if cfg.fine_reuse_coarse and cfg.noise_std == 0.0:
            fine_out = composite_merged(query_fn, rays, z_coarse, coarse_out,
                                        torch.cat(new_samps, -1), cfg)
        else:
            z_combine = torch.sort(torch.cat([z_coarse] + new_samps, -1),
                                   -1).values
            fine_out = composite(query_fn, rays, z_combine, cfg,
                                 coarse=False, generator=generator)
        outputs["fine"] = _prune(fine_out, *want)
    return outputs


def render_rays_chunked(query_fn: Callable, rays, cfg: RendererConfig,
                        ray_chunk: int = 16384, remat_body: bool = False,
                        generator: torch.Generator | None = None,
                        z_jitter: torch.Tensor | None = None,
                        fine_draws: FineDraws | None = None,
                        **want) -> dict:
    """Full-frame rendering as a loop over chunks of `ray_chunk` rays
    (the JAX package's `lax.map` over chunks, renderer.py:363-442), which
    bounds the memory of the per-sample tensors. remat_body re-runs each
    chunk's query in the backward pass instead of keeping its activations
    (torch.utils.checkpoint). z_jitter (n, B, n_coarse) and fine_draws are
    cut along with the rays. rays (n, B, 8); returns what render_rays
    returns."""
    b = rays.shape[1]

    def body(chunk_rays, chunk_jitter, chunk_fine):
        return render_rays(query_fn, chunk_rays, cfg, generator,
                           chunk_jitter, chunk_fine, **want)

    outs = []
    for lo in range(0, b, ray_chunk):
        hi = lo + ray_chunk
        args = (rays[:, lo:hi],
                None if z_jitter is None else z_jitter[:, lo:hi],
                None if fine_draws is None else fine_draws.cut(lo, hi))
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
