"""The port's geometry, positional encoding and lattice resample
(behindthescenes_tpu_torch) against the JAX package on the same numpy
inputs, at f32. Tolerance 1e-6 absolute (scaled by the values' size
where they exceed 1): both sides compute the same f32 formulas, so only
the summation order of a few-term sum differs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behindthescenes_tpu import geometry as jgeo
from behindthescenes_tpu.ops import grid_sample as jgs
from behindthescenes_tpu.ops.posenc import PositionalEncoding as JPE
from behindthescenes_tpu_torch import geometry as tgeo
from behindthescenes_tpu_torch.ops import grid_sample as tgs
from behindthescenes_tpu_torch.ops.posenc import PositionalEncoding as TPE

ATOL = 1e-6


def _poses(rng, n=2, v=3):
    """Random rigid camera-to-world poses (n, v, 4, 4) f32."""
    out = np.tile(np.eye(4, dtype=np.float32), (n, v, 1, 1))
    for i in range(n):
        for j in range(v):
            q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
            out[i, j, :3, :3] = q * np.sign(np.linalg.det(q))
            out[i, j, :3, 3] = rng.normal(size=3)
    return out


def _close(a, b, scale=1.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               atol=ATOL * scale, rtol=0)


def test_invert_pose():
    p = _poses(np.random.default_rng(0))
    _close(tgeo.invert_pose(torch.as_tensor(p)),
           jgeo.invert_pose(jnp.asarray(p)), scale=4.0)


def test_rebase_poses_to_keyframe():
    p = _poses(np.random.default_rng(1))
    got = tgeo.rebase_poses_to_keyframe(torch.as_tensor(p))
    _close(got, jgeo.rebase_poses_to_keyframe(jnp.asarray(p)), scale=8.0)
    _close(got[:, 0], np.broadcast_to(np.eye(4), (2, 4, 4)), scale=8.0)


@pytest.mark.parametrize("hw", [(6, 10), (48, 64)])
def test_distance_to_z(hw):
    rng = np.random.default_rng(2)
    h, w = hw
    depth = rng.uniform(1, 40, (2, 1, h, w)).astype(np.float32)
    ks = np.tile(np.array([[1.2, 0, 0.05], [0, 1.6, -0.02], [0, 0, 1]],
                          np.float32), (2, 1, 1, 1))
    _close(tgeo.distance_to_z(torch.as_tensor(depth), torch.as_tensor(ks)),
           jgeo.distance_to_z(jnp.asarray(depth), jnp.asarray(ks)),
           scale=40.0)


@pytest.mark.parametrize("include_input", [True, False])
@pytest.mark.parametrize("d_in", [1, 2, 3])
def test_posenc_matches(d_in, include_input):
    x = np.random.default_rng(3).uniform(-1, 1, (5, 7, d_in)) \
        .astype(np.float32)
    jpe = JPE(num_freqs=6, d_in=d_in, freq_factor=1.5,
              include_input=include_input)
    tpe = TPE(num_freqs=6, d_in=d_in, freq_factor=1.5,
              include_input=include_input)
    assert tpe.d_out == jpe.d_out
    _close(tpe(torch.as_tensor(x)), jpe(jnp.asarray(x)))


@pytest.mark.parametrize("dims", [(0, 1), (2,), (0, 2)])
def test_posenc_subset_rows(dims):
    jpe, tpe = JPE(6, 3, 1.5, True), TPE(6, 3, 1.5, True)
    np.testing.assert_array_equal(tpe.subset_rows(dims),
                                  jpe.subset_rows(dims))
    # The rows pick the subset's code out of the full code.
    x = np.random.default_rng(4).uniform(-1, 1, (9, 3)).astype(np.float32)
    full = tpe(torch.as_tensor(x))
    _close(full[:, torch.as_tensor(tpe.subset_rows(dims))],
           tpe.subset(dims)(torch.as_tensor(x[:, list(dims)])))


@pytest.mark.parametrize("sizes", [(7, 5, False), (16, 16, False),
                                   (5, 12, True), (640, 320, False)])
def test_lattice_matrix(sizes):
    out_size, in_size, align = sizes
    np.testing.assert_array_equal(
        tgs._lattice_matrix(out_size, in_size, align),
        jgs._lattice_matrix(out_size, in_size, align))


@pytest.mark.parametrize("out_hw", [(12, 20), (7, 9), (24, 40)])
def test_resample_uniform_lattice(out_hw):
    img = np.random.default_rng(5).normal(size=(12, 20, 8)) \
        .astype(np.float32)
    got = tgs.resample_uniform_lattice(torch.as_tensor(img), out_hw)
    want = jgs.resample_uniform_lattice(jnp.asarray(img), out_hw)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, scale=4.0)


def test_resample_matches_grid_sample_border():
    """The lattice resample is what grid_sample (bilinear, border,
    align_corners=False) computes on the linspace(-1, 1) lattice."""
    img = np.random.default_rng(6).normal(size=(9, 13, 4)) \
        .astype(np.float32)
    oh, ow = 11, 17
    ys, xs = torch.linspace(-1, 1, oh), torch.linspace(-1, 1, ow)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([gx, gy], -1)[None]
    ref = torch.nn.functional.grid_sample(
        torch.as_tensor(img).permute(2, 0, 1)[None], grid, mode="bilinear",
        padding_mode="border", align_corners=False)[0].permute(1, 2, 0)
    _close(tgs.resample_uniform_lattice(torch.as_tensor(img), (oh, ow)),
           ref, scale=4.0)


@pytest.mark.parametrize("hw", [(1, 1), (1, 3), (3, 1), (4, 5), (2, 2)])
def test_reflect_pad1_matches_numpy(hw):
    """Conv3x3's one-pixel reflect padding equals np.pad / jnp.pad
    mode="reflect", a dimension of size 1 included (its edge)."""
    from behindthescenes_tpu_torch.models.encoder import reflect_pad1
    x = np.random.default_rng(0).normal(size=(2, 3) + hw).astype(np.float32)
    want = np.pad(x, [(0, 0), (0, 0), (1, 1), (1, 1)], mode="reflect")
    np.testing.assert_array_equal(reflect_pad1(torch.as_tensor(x)).numpy(),
                                  want)
