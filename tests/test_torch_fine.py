"""The port's fine pass against the JAX package's on the same inputs and
the same draws (the test replays JAX's key splits and hands the draws to
the port): importance and depth-guided sampling, resampling from a
histogram, the merged composite of `fine_reuse_coarse` with ties, and
the render pass over rays, whole and in chunks, with reuse on and off,
on a tiny random-init model, all in f32 to 1e-5. Reuse equals the
re-query of every sample to 2e-5 (tests/test_renderer.py:195).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behindthescenes_tpu import renderer as jr
from behindthescenes_tpu.models.bts import BTSNet as JBTSNet
from behindthescenes_tpu_torch import renderer as tr
from behindthescenes_tpu_torch.models.bts import BTSNet
from behindthescenes_tpu_torch.ray_sampler import ImageRaySampler
from behindthescenes_tpu_torch.weights import state_dict_from_flat

TOL = 1e-5


def _t(a):
    return torch.as_tensor(np.array(a))


def jax_render_draws(key, n, b, cfg, ray_chunk=None):
    """The draws of the JAX renderer for n x b rays under `key`: those of
    render_rays (the key split five ways: coarse jitter, the fine pass's
    two uniforms, the fine depth normals), or with ray_chunk those of
    render_rays_chunked (each chunk of ray_chunk rays, the last padded,
    under fold_in(key, chunk)), as (z_jitter, FineDraws) tensors."""
    if ray_chunk is not None and b > ray_chunk:
        chunks = [jax_render_draws(jax.random.fold_in(key, c), n, ray_chunk,
                                   cfg)
                  for c in range(-(-b // ray_chunk))]
        z = torch.cat([c[0] for c in chunks], 1)[:, :b]
        fine = [torch.cat([getattr(c[1], f) for c in chunks], 1)[:, :b]
                if getattr(chunks[0][1], f) is not None else None
                for f in ("u", "jitter", "normals")]
        return z, tr.FineDraws(*fine)
    k_coarse, k_fine, k_fd, _, _ = jax.random.split(key, 5)
    z = _t(jax.random.uniform(k_coarse, (n, b, cfg.n_coarse)))
    fine = tr.FineDraws()
    n_imp = cfg.n_fine - cfg.n_fine_depth
    if cfg.n_fine > 0 and n_imp > 0:
        k1, k2 = jax.random.split(k_fine)
        fine.u = _t(jax.random.uniform(k1, (n, b, n_imp)))
        fine.jitter = _t(jax.random.uniform(k2, (n, b, n_imp)))
    if cfg.n_fine > 0 and cfg.n_fine_depth > 0:
        fine.normals = _t(jax.random.normal(k_fd, (n, b, cfg.n_fine_depth)))
    return z, fine


def _rays(seed, n=1, b=64, near=3.0, far=8.0):
    rng = np.random.default_rng(seed)
    rays = np.zeros((n, b, 8), np.float32)
    dirs = rng.normal(size=(n, b, 3))
    rays[..., 3:6] = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    rays[..., :3] = rng.normal(size=(n, b, 3)) * 0.1
    rays[..., 6], rays[..., 7] = near, far
    return rays


def _weights(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape) \
        .astype(np.float32) ** 4


@pytest.mark.parametrize("lindisp", [True, False])
def test_sample_fine_matches_jax(lindisp):
    rays, w = _rays(0), _weights(1, (1, 64, 24))
    key = jax.random.PRNGKey(3)
    want = jr.sample_fine(key, jnp.asarray(rays), jnp.asarray(w), 16, 24,
                          lindisp)
    k1, k2 = jax.random.split(key)
    got = tr.sample_fine(_t(rays), _t(w), 16, 24, lindisp,
                         u=_t(jax.random.uniform(k1, (1, 64, 16))),
                         jitter=_t(jax.random.uniform(k2, (1, 64, 16))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_sample_fine_depth_matches_jax():
    """Wide normals: many samples clip to near or far."""
    rays = _rays(2)
    depth = np.random.default_rng(4).uniform(3, 8, (1, 64)) \
        .astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = jr.sample_fine_depth(key, jnp.asarray(rays), jnp.asarray(depth),
                                6, 5.0)
    got = tr.sample_fine_depth(_t(rays), _t(depth), 6, 5.0,
                               normals=_t(jax.random.normal(key, (1, 64, 6))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    assert (got.numpy() == 3.0).any() and (got.numpy() == 8.0).any()


@pytest.mark.parametrize("lindisp", [True, False])
def test_sample_coarse_from_dist_matches_jax(lindisp):
    rays, w = _rays(6), _weights(7, (1, 64, 24))
    z = np.sort(np.random.default_rng(8).uniform(3, 8, (1, 64, 24)), -1) \
        .astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = jr.sample_coarse_from_dist(key, jnp.asarray(rays), jnp.asarray(w),
                                      jnp.asarray(z), 16, lindisp)
    k1, k2 = jax.random.split(key)
    got = tr.sample_coarse_from_dist(
        _t(rays), _t(w), _t(z), 16, lindisp,
        u=_t(jax.random.uniform(k1, (1, 64, 16))),
        jitter=_t(jax.random.uniform(k2, (1, 64, 16))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_searchsorted_right_counts_ties_as_torch_right():
    """The count of cdf <= u equals torch.searchsorted(right=True), u
    equal to cdf entries included."""
    cdf = torch.tensor([[0.0, 0.25, 0.25, 0.5, 1.0]])
    u = torch.tensor([[0.0, 0.25, 0.3, 0.5, 0.99, 1.0]])
    got = tr._searchsorted_right(cdf, u)
    assert got.tolist() == [[1, 3, 3, 4, 4, 5]]
    assert torch.equal(got, torch.searchsorted(cdf, u, right=True))


def _smooth_query(xp, v=2):
    """A smooth field of position in numpy-like `xp` (jnp or torch): order
    faults in the merged composite show as depth and rgb drift."""
    def query_fn(xyz, coarse):
        n, p, _ = xyz.shape
        z = xyz[..., 2:3]
        sigma = 0.8 / (1.0 + xp.exp(-2.0 * (z - 4.0))) + 0.05 * xp.sin(z)
        rgb = xp.concatenate([xp.sin(0.7 * z + i) * 0.5 + 0.5
                              for i in range(v)] * 3, -1).reshape(n, p, 3 * v)
        invalid = (xp.sin(3.0 * z) > 0.9) * 1.0
        return rgb, xp.concatenate([invalid] * v, -1), sigma
    return query_fn


@pytest.mark.parametrize("hard_cap,white", [(False, False), (True, True)])
def test_composite_merged_matches_jax_with_ties(hard_cap, white):
    """The merged composite of cached and new samples, a third of the new
    ones exact copies of cached depths: every output, per-sample ones in
    concatenation order."""
    rays = _rays(10)
    rng = np.random.default_rng(11)
    z_c = np.sort(rng.uniform(3, 8, (1, 64, 12)), -1).astype(np.float32)
    z_n = rng.uniform(3, 8, (1, 64, 9)).astype(np.float32)
    z_n[..., :3] = z_c[..., 2:5]
    z_n[..., 3] = 3.0
    cfg = dict(n_coarse=12, n_fine=9, hard_alpha_cap=hard_cap,
               white_bkgd=white, fine_reuse_coarse=True)

    def run(xp, lib, t):
        qf = _smooth_query(xp)
        cached = lib.composite(qf, t(rays), t(z_c), lib.RendererConfig(**cfg))
        return lib.composite_merged(qf, t(rays), t(z_c), cached, t(z_n),
                                    lib.RendererConfig(**cfg))
    want = run(jnp, jr, jnp.asarray)
    got = run(torch, tr, _t)
    for k in ("weights", "rgb", "depth", "alphas", "invalid", "z_samps",
              "rgb_samps", "sigmas"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=TOL, rtol=TOL, err_msg=k)


# ------------------------------------------------------ the render passes
MODEL_CONF = {"z_near": 1.0, "z_far": 40.0, "inv_z": True,
              "learn_empty": True, "code_mode": "z",
              "code": {"num_freqs": 6, "freq_factor": 1.5,
                       "include_input": True},
              "encoder": {"type": "dummy", "size": (16, 24), "d_out": 16},
              "mlp_coarse": {"type": "resnet", "n_blocks": 0,
                             "d_hidden": 32},
              "mlp_fine": {"type": "empty"}}


def _flat(variables):
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]:
        out["/".join(str(getattr(p, "key", p)) for p in kp)] = \
            np.asarray(leaf, np.float32)
    return out


@pytest.fixture(scope="module")
def tiny():
    """A random-init model with a learned 16x24 map on both sides (the
    JAX initialisation carried across), frame 0 encoded and both frames'
    colours, and the rays of both frames (1, 768, 8)."""
    rng = np.random.default_rng(12)
    v, h, w = 2, 16, 24
    images = rng.uniform(-1, 1, (1, v, h, w, 3)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (1, v, 1, 1))
    poses[0, 1, 0, 3] = 0.5
    projs = np.tile(np.array([[1.2, 0, 0], [0, 1.8, 0], [0, 0, 1]],
                             np.float32), (1, v, 1, 1))
    jnet = JBTSNet.from_conf(MODEL_CONF)
    variables = jnet.init(jax.random.PRNGKey(0), jnp.asarray(images),
                          jnp.asarray(projs), jnp.asarray(poses),
                          jnp.zeros((1, 8, 3)))
    jgrid = jax.jit(lambda *a: jnet.apply(variables, *a, ids_encoder=[0],
                                          method=JBTSNet.encode))(
        jnp.asarray(images), jnp.asarray(projs), jnp.asarray(poses))
    net = BTSNet.from_conf(MODEL_CONF)
    net.load_state_dict(state_dict_from_flat(_flat(variables)))
    grid = net.encode(_t(images), _t(projs), _t(poses), ids_encoder=[0])
    rays, _ = ImageRaySampler(1.0, 40.0, h, w).sample(None, _t(poses),
                                                      _t(projs))
    # Directions turned by up to 1e-3: the edge pixels' rays run along
    # the frustum's border, where a 1-ulp difference in a sample's depth
    # flips its validity (and the learned empty feature) in either
    # framework.
    dirs = rays[..., 3:6] + _t(rng.uniform(-1e-3, 1e-3, (1, v * h * w, 3))
                               .astype(np.float32))
    rays[..., 3:6] = dirs / dirs.norm(dim=-1, keepdim=True)

    def jquery(xyz, coarse):
        return jnet.apply(variables, jgrid, xyz, coarse=coarse,
                          method=JBTSNet.query)

    def tquery(xyz, coarse):
        return net.query(grid, xyz, coarse=coarse)
    return jquery, tquery, rays


RENDER_CFGS = {
    "reuse": dict(n_coarse=8, n_fine=8, fine_reuse_coarse=True,
                  lindisp=True, hard_alpha_cap=True),
    "requery": dict(n_coarse=8, n_fine=8, lindisp=True, hard_alpha_cap=True),
    "depth_samples": dict(n_coarse=8, n_fine=6, n_fine_depth=2,
                          depth_std=1.0, fine_reuse_coarse=True,
                          lindisp=True, hard_alpha_cap=True),
}
WANT = dict(want_weights=True, want_alphas=True, want_z_samps=True)


def _compare(got, want):
    assert set(got) == set(want) == {"coarse", "fine"}
    for branch in want:
        for k in want[branch]:
            np.testing.assert_allclose(
                got[branch][k].detach().numpy(), np.asarray(want[branch][k]),
                atol=TOL, rtol=TOL, err_msg=f"{branch} {k}")


@pytest.mark.parametrize("name", list(RENDER_CFGS))
def test_render_rays_fine_matches_jax(tiny, name):
    jquery, tquery, rays = tiny
    jcfg = jr.RendererConfig(**RENDER_CFGS[name])
    key = jax.random.PRNGKey(13)
    want = jax.jit(lambda r, k: jr.render_rays(jquery, r, k, jcfg, **WANT))(
        jnp.asarray(rays.numpy()), key)
    z_jitter, fine = jax_render_draws(key, 1, rays.shape[1], jcfg)
    with torch.no_grad():
        got = tr.render_rays(tquery, rays, tr.RendererConfig(
            **RENDER_CFGS[name]), z_jitter=z_jitter, fine_draws=fine, **WANT)
    _compare(got, want)


@pytest.mark.parametrize("name", ["reuse", "requery"])
def test_render_rays_chunked_fine_matches_jax(tiny, name):
    """Three chunks of 300 of the 768 rays, the last one padded in JAX:
    each chunk's draws under fold_in(key, chunk)."""
    jquery, tquery, rays = tiny
    jcfg = jr.RendererConfig(**RENDER_CFGS[name])
    key = jax.random.PRNGKey(14)
    want = jax.jit(lambda r, k: jr.render_rays_chunked(
        jquery, r, k, jcfg, ray_chunk=300, **WANT))(
            jnp.asarray(rays.numpy()), key)
    z_jitter, fine = jax_render_draws(key, 1, rays.shape[1], jcfg,
                                      ray_chunk=300)
    with torch.no_grad():
        got = tr.render_rays_chunked(
            tquery, rays, tr.RendererConfig(**RENDER_CFGS[name]),
            ray_chunk=300, z_jitter=z_jitter, fine_draws=fine, **WANT)
    _compare(got, want)


@pytest.mark.parametrize("hard_cap,white,lindisp", [(False, False, True),
                                                    (True, True, False)])
def test_fine_reuse_matches_requery(hard_cap, white, lindisp):
    """tests/test_renderer.py:195 on the port: the same draws, reuse on
    and off, equal images (2e-5); huge depth_std clips many depth samples
    to near / far, ties that the stable order must break."""
    rays = _t(_rays(15))
    kw = dict(n_coarse=24, n_fine=16, n_fine_depth=6, depth_std=5.0,
              lindisp=lindisp, hard_alpha_cap=hard_cap, white_bkgd=white)
    gen = torch.Generator()
    gen.manual_seed(0)
    z_jitter = torch.rand((1, 64, 24), generator=gen)
    fine = tr.FineDraws(torch.rand((1, 64, 10), generator=gen),
                        torch.rand((1, 64, 10), generator=gen),
                        torch.randn((1, 64, 6), generator=gen))
    out = {reuse: tr.render_rays(_smooth_query(torch), rays,
                                 tr.RendererConfig(**kw,
                                                   fine_reuse_coarse=reuse),
                                 z_jitter=z_jitter, fine_draws=fine,
                                 want_weights=True)
           for reuse in (False, True)}
    ref, got = out[False]["fine"], out[True]["fine"]
    for k in ("rgb", "depth"):
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), atol=2e-5,
                                   err_msg=k)
    np.testing.assert_allclose(got["weights"].sum(-1).numpy(),
                               ref["weights"].sum(-1).numpy(), atol=2e-5)
    np.testing.assert_allclose(got["invalid"].mean(-2).numpy(),
                               ref["invalid"].mean(-2).numpy(), atol=1e-6)
    assert torch.equal(out[True]["coarse"]["depth"],
                       out[False]["coarse"]["depth"])


def test_draws_of_the_wrong_shape_raise():
    rays = _t(_rays(16, b=8))
    cfg = tr.RendererConfig(n_coarse=4, n_fine=4)
    with pytest.raises(ValueError, match="draws"):
        tr.render_rays(_smooth_query(torch), rays, cfg,
                       fine_draws=tr.FineDraws(u=torch.rand(1, 8, 3)))


def test_training_refuses_the_fine_pass():
    """The renderer serves n_fine > 0; the train step does not yet, and
    says so instead of dropping the fine branch."""
    from behindthescenes_tpu_torch.training.wrapper import BTSWrapper
    net = BTSNet.from_conf(MODEL_CONF)
    wrapper = BTSWrapper(net, tr.RendererConfig(n_coarse=4, n_fine=4),
                         dict(MODEL_CONF, sample_mode="random"))
    with pytest.raises(NotImplementedError, match="item 5"):
        wrapper.forward({"imgs": torch.zeros(1, 2, 16, 24, 3)}, None)
