"""The port's tile fetch (ops/grid_sample.grid_sample_2d_tiles and
tile_region_fit, the `n_tiles` path of BTSNet.sample_features, and the
patch-mode train step with `model_conf.tile_fetch_region`) against the
JAX package's: the op on random maps and tiles in f32 and bf16, its
gradient with respect to the map, tests/test_tile_fetch.py's train step
(tile against gather, and against JAX's tile step), and the tile step
through the chunked remat render with the fine pass, where a chunk's
points split into tiles as JAX splits them, padding included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behindthescenes_tpu.ops import grid_sample as jgs
from behindthescenes_tpu.parallel.mesh import make_mesh
from behindthescenes_tpu.training.trainer import BTSTrainer as JTrainer
from behindthescenes_tpu_torch.models import bts
from behindthescenes_tpu_torch.ops import grid_sample as tgs
from behindthescenes_tpu_torch.renderer import FineDraws
from behindthescenes_tpu_torch.training.wrapper import Draws
from test_tile_fetch import _config as tile_config
from test_torch_train import (JaxStep, _batch, _flat, _grads, _jax_init,
                              port_step, replay_draws)
from test_torch_train_modes import _modes_conf, _Step

# One intra-op thread: pytest-xdist runs several workers on this CPU,
# and torch's default of a thread per core makes every small op wait
# on threads that the other workers have swapped out.
torch.set_num_threads(1)

IMG_HW, C = (20, 30), 5
REGION = (6, 9)


def _tiles(seed: int):
    """A random map and 6 tiles of 10 points: 4 compact tiles (a 4x6
    pixel quad each, one of them across the border) and 2 spread over
    the whole map, which do not fit REGION."""
    rng = np.random.default_rng(seed)
    image = rng.normal(size=IMG_HW + (C,)).astype(np.float32)
    h, w = IMG_HW
    centre = rng.uniform(-0.8, 0.8, (6, 1, 2))
    spread = np.array([6.0 / w, 4.0 / h])
    coords = centre + rng.uniform(-1, 1, (6, 10, 2)) * spread
    coords[1] += np.array([0.9, 0.0])            # across the right border
    coords[4:] = rng.uniform(-1.1, 1.1, (2, 10, 2))
    return image, coords.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiles_match_jax(dtype):
    """grid_sample_2d_tiles and tile_region_fit against JAX's on the same
    map and tiles: f32 within 1e-6; bf16 within one bf16 rounding of the
    result (2^-8 relative plus 1e-6), the hat weights cast to bf16 on
    both sides. Points of fitting tiles equal grid_sample_2d (border,
    align_corners=False) within 1e-6 at f32, and the points of the
    tiles that do not fit which lie outside their region read exactly
    zero."""
    image, coords = _tiles(0)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jgs.grid_sample_2d_tiles(
        jnp.asarray(image, jdt), jnp.asarray(coords), REGION), np.float32)
    got = tgs.grid_sample_2d_tiles(torch.as_tensor(image).to(tdt),
                                   torch.as_tensor(coords), REGION)
    assert got.dtype == tdt and got.shape == (6, 10, C)
    got = got.float().numpy()
    fit = tgs.tile_region_fit(torch.as_tensor(coords), IMG_HW,
                              REGION).numpy()
    np.testing.assert_array_equal(fit, np.asarray(jgs.tile_region_fit(
        jnp.asarray(coords), IMG_HW, REGION)))
    assert fit[:4].all() and not fit[4:].any()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-6)
        exact = tgs.grid_sample_2d(
            torch.as_tensor(image).expand((6,) + image.shape),
            torch.as_tensor(coords)).numpy()
        np.testing.assert_allclose(got[fit], exact[fit], atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=1e-6)
    # Outside its region (anchored at the tile's clipped minimum) a
    # point's hat weights all vanish.
    h, w = IMG_HW
    px = np.clip(((coords[..., 0] + 1) * w - 1) / 2, 0, w - 1)
    py = np.clip(((coords[..., 1] + 1) * h - 1) / 2, 0, h - 1)
    x0 = np.clip(px.min(1).astype(int), 0, w - REGION[1])[:, None]
    y0 = np.clip(py.min(1).astype(int), 0, h - REGION[0])[:, None]
    outside = (px >= x0 + REGION[1]) | (py >= y0 + REGION[0])
    assert outside[4:].any() and not outside[:4].any()
    assert not got[outside].any()


def test_tile_gradient_matches_jax():
    """The gradient of sum(out * g) with respect to the map (autograd
    through the region gather, whose backward accumulates) against
    jax.grad of the same, within 1e-5."""
    image, coords = _tiles(1)
    g = np.random.default_rng(2).normal(size=(6, 10, C)).astype(np.float32)

    def jloss(im):
        return jnp.sum(jgs.grid_sample_2d_tiles(im, jnp.asarray(coords),
                                                REGION) * g)
    want = np.asarray(jax.grad(jloss)(jnp.asarray(image)))
    t_image = torch.as_tensor(image).requires_grad_()
    (tgs.grid_sample_2d_tiles(t_image, torch.as_tensor(coords), REGION)
     * torch.as_tensor(g)).sum().backward()
    got = t_image.grad.numpy()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_region_larger_than_the_map_raises():
    image, coords = _tiles(0)
    with pytest.raises(ValueError, match="exceeds"):
        tgs.grid_sample_2d_tiles(torch.as_tensor(image),
                                 torch.as_tensor(coords), (21, 9))


# ------------------------------------------------------------ train step
# tests/test_tile_fetch.py's config (ResNet-18 at 48x64, patch 4, 128
# rays of 12 samples, f32) on 2 items; (40, 56) covers every tile.
TILE = dict(shape=(2, 48, 64), conf=tile_config((40, 56)))
GATHER = dict(shape=(2, 48, 64), conf=tile_config())


@pytest.fixture(scope="module")
def tile_step():
    return JaxStep(TILE)


def test_tile_step_matches_gather_and_jax(tile_step):
    """The port's f32 step with the tile fetch against its step with the
    gathers on the same draws (tests/test_tile_fetch.py's bounds: loss
    within 1e-5, the updated lin_in within 1e-5), and against JAX's tile
    step: every loss term within 1e-5 relative, each MLP gradient within
    1e-4 x its largest entry, every gradient at a cosine of 0.999 (the
    encoder's BatchNorm gradients carry JAX's f32 variance cancellation,
    tests/test_torch_train.py)."""
    tile, tile_terms = port_step(tile_step, torch.float32)
    assert tile.wrapper.query_tiles == 128 // 16
    gather, gather_terms = port_step(_with_conf(tile_step, GATHER["conf"]),
                                     torch.float32)
    assert gather.wrapper.query_tiles is None
    assert abs(tile_terms["loss"] - gather_terms["loss"]) < 1e-5
    np.testing.assert_allclose(
        tile.net.mlp_coarse.lin_in.weight.detach().numpy(),
        gather.net.mlp_coarse.lin_in.weight.detach().numpy(), atol=1e-5)
    for k, want in tile_step.terms.items():
        np.testing.assert_allclose(tile_terms[k], want, rtol=1e-5,
                                   atol=1e-8, err_msg=k)
    got = _grads(tile)
    assert set(got) == set(tile_step.grads)
    for k, g in tile_step.grads.items():
        if "mlp" in k:
            assert np.abs(got[k] - g).max() <= 1e-4 * np.abs(g).max(), k
        if np.abs(g).max() > 0:
            cos = float((got[k] * g).sum() / (np.linalg.norm(got[k])
                                               * np.linalg.norm(g)))
            assert cos >= 0.999, (k, cos)


def _with_conf(step, conf):
    """`step` (its variables, batch, ids and draws) with another config."""
    other = object.__new__(type(step))
    other.__dict__.update(step.__dict__)
    other.conf = conf
    return other


# The overfit harness's learned map (24x32, no BatchNorm: JAX's f32
# gradients are exact to f32 noise) with an (8, 12) region, through the
# chunked remat render in chunks of 48 of the 128 rays (8 patches of 16):
# JAX pads the last chunk to 48 rays, and each chunk's points split into
# 8 tiles of 6 rays, which straddle patches and, in the padded chunk,
# take in the padded rays' points at the origin; with 8 fine samples that
# reuse the coarse ones. The region is small enough that tiles miss it,
# so the grouping shows: without the padding the loss moves by more than
# the bound.
REMAT = {"remat_render": True, "train_ray_chunk": 48,
         "tile_fetch_region": [8, 12]}
FINE = {"n_fine": 8, "fine_reuse_coarse": True}


def _padded_fine_draws(key, conf, n):
    """The coarse jitter and fine draws of JAX's chunked render: each
    chunk of train_ray_chunk rays (the last one padded) draws from
    fold_in(k_render, chunk) as renderer.render_rays splits it; the real
    rays' draws are the first B of their concatenation."""
    mc, rc = conf["model_conf"], conf["renderer"]
    rays, chunk = mc["ray_batch_size"], mc["train_ray_chunk"]
    k_render = jax.random.split(key, 3)[2]
    n_imp = rc["n_fine"]
    zs, us, js = [], [], []
    for i in range(-(-rays // chunk)):
        k_coarse, k_fine = jax.random.split(
            jax.random.fold_in(k_render, i), 5)[:2]
        zs.append(jax.random.uniform(k_coarse, (n, chunk, rc["n_coarse"])))
        k1, k2 = jax.random.split(k_fine)
        us.append(jax.random.uniform(k1, (n, chunk, n_imp)))
        js.append(jax.random.uniform(k2, (n, chunk, n_imp)))

    def cat(parts):
        return torch.as_tensor(np.concatenate(
            [np.asarray(a) for a in parts], 1)[:, :rays])
    return cat(zs), FineDraws(cat(us), cat(js))


def test_tile_step_through_padded_remat_chunks_matches_jax(monkeypatch):
    """One f32 step of the learned map with the tile fetch, the chunked
    remat render (padded last chunk) and the fine pass, from JAX's
    initial parameters with JAX's draws: every loss term within 2e-5
    relative and every gradient within 2e-4 x its largest entry of JAX's
    (the bounds of the remat mode in tests/test_torch_train_modes.py);
    some tile misses its region, so the tiles' grouping matters."""
    conf = _modes_conf(**REMAT)
    conf["renderer"].update(FINE)
    shape = (1, 24, 32)
    batch = _batch(shape)
    trainer = JTrainer(conf, mesh=make_mesh(jax.devices()[:1]),
                       compute_dtype=jnp.float32)
    assert trainer.wrapper.query_tiles == 8
    variables = _jax_init(trainer, batch, jax.random.PRNGKey(0))
    ids = trainer.wrapper.select_views(
        np.random.default_rng(conf["seed"]), 4, training=True)
    key = jax.random.PRNGKey(7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        data, _ = trainer.wrapper.forward({"params": params}, jbatch, key,
                                          ids, train=True)
        return trainer.criterion(data)
    grads, terms = jax.jit(jax.grad(loss_fn, has_aux=True))(
        variables["params"])
    mc = conf["model_conf"]
    rays = replay_draws(key, 1, len(ids.ids_loss), 24, 32, mc["patch_size"],
                        mc["ray_batch_size"], conf["renderer"]["n_coarse"])
    z_jitter, fine = _padded_fine_draws(key, conf, 1)
    step = _Step(conf, _flat(variables, ""), batch,
                 Draws(rays=rays.rays, z_jitter=z_jitter, fine=fine),
                 _flat(grads, "params/"),
                 {k: float(v) for k, v in terms.items()})
    fits = []

    def recorded(image, coords, region_hw):
        fits.append(tgs.tile_region_fit(coords, image.shape[:2], region_hw))
        return tgs.grid_sample_2d_tiles(image, coords, region_hw)
    monkeypatch.setattr(bts, "grid_sample_2d_tiles", recorded)
    port, port_terms = port_step(step, torch.float32)
    assert port_terms["loss_rgb_fine"] > 0
    for k, want in step.terms.items():
        np.testing.assert_allclose(port_terms[k], want, rtol=2e-5,
                                   atol=1e-8, err_msg=k)
    got = _grads(port)
    for k, g in step.grads.items():
        assert np.abs(got[k] - g).max() <= 2e-4 * np.abs(g).max(), k
    assert fits and not all(bool(f.all()) for f in fits)


def test_a_fitting_tile_can_pass_its_last_texel():
    """tile_region_fit (JAX's test, the port's alike) passes a tile whose
    clipped span is at most rw - 1 texels, but the region starts at the
    truncated minimum: a tile from x = 10.7 to 73.5 fits a 64-wide region
    [10, 73], yet its last point needs texel 74 and reads only part of
    its value. tile_points_inside marks that point; every other point
    equals grid_sample_2d."""
    image = torch.as_tensor(np.random.default_rng(5).normal(
        size=(192, 640, 8)).astype(np.float32))
    px = torch.tensor([10.7, 73.5, 40.0])
    py = torch.tensor([50.0, 50.3, 51.0])
    coords = torch.stack([(2 * px + 1) / 640 - 1, (2 * py + 1) / 192 - 1],
                         -1)[None]
    assert bool(tgs.tile_region_fit(coords, (192, 640), (16, 64))[0])
    assert bool(jgs.tile_region_fit(jnp.asarray(coords.numpy()),
                                    (192, 640), (16, 64))[0])
    inside = tgs.tile_points_inside(coords, (192, 640), (16, 64))
    assert inside.tolist() == [[True, False, True]]
    dev = (tgs.grid_sample_2d_tiles(image, coords, (16, 64))
           - tgs.grid_sample_2d(image[None], coords)).abs().amax(-1)[0]
    assert dev[1] > 0.1 and dev[inside[0]].max() < 1e-6
