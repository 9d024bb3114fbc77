"""The port's inference helpers against the JAX package's: `render_poses`
(novel views through the general path, JAX's draws replayed),
`render_profile` (the top-down density profile) in f32 and bf16, and the
five pose helpers of geometry.py, on the converged exp_synthetic
checkpoint at tests/test_sweep.py's size (48x64).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behindthescenes_tpu import geometry as jgeometry
from behindthescenes_tpu import inference as jinference
from behindthescenes_tpu import renderer as jrenderer
from behindthescenes_tpu_torch import geometry
from behindthescenes_tpu_torch import inference
from behindthescenes_tpu_torch import renderer as rlib
from test_torch_fine import jax_render_draws
from test_torch_sweep import H, W, Sides

# One intra-op thread: pytest-xdist runs several workers on this CPU,
# and torch's default of a thread per core makes every small op wait
# on threads that the other workers have swapped out.
torch.set_num_threads(1)

# The demos' profile bounds at bf16 (chip_smoke.py phase 23): the two
# bf16 encoders round their convolutions in another order, the density
# is rounded to 8 bits and the along-z sum runs in bf16, which moves a
# cell across the visibility cutoff now and then.
PROFILE_CELLS_EQUAL, PROFILE_ATOL = 0.99, 1e-2
SIGMA_RTOL = 1e-2


@pytest.fixture(scope="module")
def sides():
    return {False: Sides(bf16=False), True: Sides(bf16=True)}


def test_render_poses_matches_jax(sides):
    """Both views of the item through render_poses (16 coarse + 8 fine
    samples, chunks of 1000 rays, the last one padded on JAX's side) with
    JAX's draws replayed, f32: rgb within 1e-4, depth within 1e-3
    relative, the invalid share within 1e-6 except on the border pixels
    of view 0, the encoder's own camera, whose samples project onto the
    image's edge (x or y = +-1) where rounding decides validity."""
    s = sides[False]
    jcfg = jrenderer.RendererConfig(n_coarse=16, n_fine=8, lindisp=True)
    cfg = rlib.RendererConfig(n_coarse=16, n_fine=8, lindisp=True)
    key = jax.random.PRNGKey(5)
    jposes = jnp.stack([jnp.eye(4), s.jpose])
    jprojs = jnp.stack([s.jproj, s.jproj])
    want = jinference.render_poses(s.jnet, s.variables, s.jgrid, key, jposes,
                                   jprojs, H, W, jcfg, 1.0, 40.0,
                                   ray_chunk=1000)
    z_jitter, fine = jax_render_draws(key, 1, 2 * H * W, jcfg, 1000)
    with torch.no_grad():
        got = inference.render_poses(
            s.net, s.grid, torch.stack([torch.eye(4), s.pose]),
            torch.stack([s.proj, s.proj]), H, W, cfg, 1.0, 40.0,
            ray_chunk=1000, z_jitter=z_jitter, fine_draws=fine)
    assert got["rgb"].shape == (2, H, W, 3)
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(want["rgb"]),
                               atol=1e-4)
    np.testing.assert_allclose(got["depth"].numpy(),
                               np.asarray(want["depth"]), rtol=1e-3)
    inner = np.ones((2, H, W), bool)
    inner[0, [0, -1]] = inner[0, :, [0, -1]] = False
    np.testing.assert_allclose(got["invalid"].numpy()[inner],
                               np.asarray(want["invalid"])[inner], atol=1e-6)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_render_profile_matches_jax(sides, bf16):
    """The BEV profile of the encoded view on the default 18 m x 18 m grid
    (180 x 180 cells). f32: sigma within 1e-5 x its largest value, the
    profile within 1e-4 (1e-5 relative at 1). bf16: sigma's relative
    error over the grid, |sigma - sigma_jax| / |sigma_jax| in the 2-norm,
    within SIGMA_RTOL (measured 6.4e-3: the two bf16 encoders' features
    lie 2.9e-3 apart, and cell by cell sigma differs by a median 0.5%,
    up to 7%), and at least PROFILE_CELLS_EQUAL of the profile's cells
    within PROFILE_ATOL (measured 99.8%)."""
    s = sides[bf16]
    jp, js = jinference.render_profile(s.jnet, s.variables, s.jgrid)
    jp, js = np.asarray(jp, np.float32), np.asarray(js, np.float32)
    with torch.no_grad():
        p, sig = inference.render_profile(s.net, s.grid)
    p, sig = p.float().numpy(), sig.float().numpy()
    assert p.shape == sig.shape == (180, 180)
    assert js.max() > 1.0 and (jp > 0).any() and (jp == 0).any()
    if not bf16:
        np.testing.assert_allclose(sig, js, atol=1e-5 * js.max())
        np.testing.assert_allclose(p, jp, atol=1e-4)
        return
    assert np.linalg.norm(sig - js) <= SIGMA_RTOL * np.linalg.norm(js)
    assert np.mean(np.abs(p - jp) <= PROFILE_ATOL) >= PROFILE_CELLS_EQUAL


def _rotations(seed, n=16):
    """Random rotations, the identity, and 180-degree turns about each
    axis (the zero-difference branches of rot_to_quat's signs)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    rots = np.asarray(jgeometry.quat_to_rot(jnp.asarray(q, jnp.float32)))
    extra = [np.eye(3), np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]),
             np.diag([-1.0, -1, 1])]
    return q.astype(np.float32), np.concatenate(
        [rots, np.stack(extra)]).astype(np.float32)


def test_quat_to_rot_matches_jax():
    q, _ = _rotations(0)
    want = np.asarray(jgeometry.quat_to_rot(jnp.asarray(q)))
    got = geometry.quat_to_rot(torch.as_tensor(q)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_rot_to_quat_matches_jax():
    _, rots = _rotations(1)
    want = np.asarray(jgeometry.rot_to_quat(jnp.asarray(rots)))
    got = geometry.rot_to_quat(torch.as_tensor(rots)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    back = geometry.quat_to_rot(torch.as_tensor(got)).numpy()
    np.testing.assert_allclose(back, rots, atol=1e-5)


def test_look_at_matches_jax():
    rng = np.random.default_rng(2)
    for _ in range(8):
        origin, target = rng.normal(size=3) * 5, rng.normal(size=3)
        np.testing.assert_array_equal(geometry.look_at(origin, target),
                                      jgeometry.look_at(origin, target))
    up = (0.0, 0.0, 1.0)
    np.testing.assert_array_equal(geometry.look_at((1, 2, 3), (0, 0, 0), up),
                                  jgeometry.look_at((1, 2, 3), (0, 0, 0), up))


@pytest.mark.parametrize("name", ["coord_from_blender", "coord_to_blender"])
def test_blender_frames_match_jax(name):
    got, want = getattr(geometry, name)(), getattr(jgeometry, name)()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(geometry.coord_from_blender()
                                  @ geometry.coord_to_blender(), np.eye(4))
