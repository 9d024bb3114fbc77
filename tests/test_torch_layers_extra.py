"""The port's layer-zoo extras (behindthescenes_tpu_torch/ops/
layers_extra.py) and 3D-conv residual blocks (models/resnet3dconv.py)
against the JAX package's modules on the CPU, on weights that JAX
initialises (carried over in torch's layouts) and inputs drawn from a
numpy seed.

Bounds: the geometry (ndc_grid, backproject, point_projection) and the
pads are elementwise in f32 on both sides: the pads bit-equal, ndc_grid
within one f32 ulp (XLA fuses jnp.linspace's arithmetic), the
projections within 1e-6 of their scale. The convolutions sum in another
order: within 1e-5 of the output's largest value in f32; in bf16 within
4 bf16 ulps of it (the bound of the encoder's bf16 test). residual_image
within 1e-5: the port's SSIM computes its window statistics in float64,
JAX's in f32 (3e-6 apart on unit-scale inputs, ops/ssim.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behindthescenes_tpu.models import resnet3dconv as jr3d
from behindthescenes_tpu.ops import layers_extra as jle
from behindthescenes_tpu_torch.models import resnet3dconv as tr3d
from behindthescenes_tpu_torch.ops import layers_extra as tle

# One intra-op thread: pytest-xdist runs several workers on this CPU,
# and torch's default of a thread per core makes every small op wait
# on threads that the other workers have swapped out.
torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, want, rel=1e-5):
    got = got.float().detach().numpy() if torch.is_tensor(got) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want,
                               atol=rel * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("h,w", [(1, 5), (7, 9), (48, 64)])
def test_ndc_grid_within_an_ulp(h, w):
    """jnp.linspace's start * (1 - i / n) + stop * i / n, which XLA fuses
    (its division becomes a product by the reciprocal), against the same
    formula evaluated operation by operation: within 2^-23, one f32 ulp
    of the grid's largest value."""
    want = np.asarray(jle.ndc_grid(h, w))
    got = tle.ndc_grid(h, w).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-23)
    np.testing.assert_array_equal(got[[0, -1]], want[[0, -1]])


def _cameras(rng, n):
    k = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    k[:, 0, 0], k[:, 1, 1] = rng.uniform(0.8, 1.5, n), rng.uniform(1, 2, n)
    k[:, :2, 2] = rng.uniform(-0.1, 0.1, (n, 2))
    return k


def _poses(rng, n, scale=0.1):
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    a = rng.uniform(-scale, scale, (n, 3))
    for i in range(n):
        c, s = np.cos(a[i, 0]), np.sin(a[i, 0])
        poses[i, :3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    poses[:, :3, 3] = rng.uniform(-scale, scale, (n, 3))
    return poses


def test_backproject_and_point_projection_match_jax():
    rng = np.random.default_rng(0)
    depth = rng.uniform(1, 20, (2, 12, 16, 1)).astype(np.float32)
    inv_k = np.linalg.inv(_cameras(rng, 2)).astype(np.float32)
    want = jle.backproject(jnp.asarray(depth), jnp.asarray(inv_k))
    got = tle.backproject(_t(depth), _t(inv_k))
    _close(got, want, 1e-6)
    k, t = _cameras(rng, 2), _poses(rng, 2)
    wxy, wz = jle.point_projection(want, jnp.asarray(k), jnp.asarray(t))
    gxy, gz = tle.point_projection(got, _t(k), _t(t))
    _close(gxy, wxy, 1e-6)
    _close(gz, wz, 1e-6)


def test_residual_image_matches_jax():
    rng = np.random.default_rng(1)
    n, h, w = 2, 24, 32
    key = rng.uniform(-1, 1, (n, h, w, 3)).astype(np.float32)
    frames = [rng.uniform(-1, 1, (n, h, w, 3)).astype(np.float32)
              for _ in range(2)]
    inv_depth = rng.uniform(0.05, 0.9, (n, h, w, 1)).astype(np.float32)
    key_pose, key_k = _poses(rng, n), _cameras(rng, n)
    poses = [_poses(rng, n, 0.3) for _ in range(2)]
    ks = [_cameras(rng, n) for _ in range(2)]
    want = jle.residual_image(
        jnp.asarray(key), jnp.asarray(key_pose), jnp.asarray(key_k),
        jnp.asarray(inv_depth), [jnp.asarray(f) for f in frames],
        [jnp.asarray(p) for p in poses], [jnp.asarray(k) for k in ks])
    got = tle.residual_image(_t(key), _t(key_pose), _t(key_k),
                             _t(inv_depth), [_t(f) for f in frames],
                             [_t(p) for p in poses], [_t(k) for k in ks])
    want = np.asarray(want)
    assert (want == 0).any() and (want > 0).any()    # unseen and seen
    np.testing.assert_array_equal(got.numpy() == 0, want == 0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("k,s,hw", [(3, 1, (9, 11)), (4, 2, (9, 11)),
                                    ((5, 1), (2, 1), (6, 7)),
                                    (1, 3, (8, 10)), (2, 1, (5, 5))])
def test_pad_same_matches_jax(k, s, hw):
    x = np.random.default_rng(2).normal(size=(2, *hw, 3)).astype(np.float32)
    np.testing.assert_array_equal(tle.pad_same(_t(x), k, s).numpy(),
                                  np.asarray(jle.pad_same(jnp.asarray(x),
                                                          k, s)))


@pytest.mark.parametrize("shape,orig", [((2, 12, 14, 3), (5, 6)),
                                        ((2, 9, 10, 3), (5, 5)),
                                        ((1, 10, 12, 2), (5, 6))])
def test_pad_same_transposed_matches_jax(shape, orig):
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    np.testing.assert_array_equal(
        tle.pad_same_transposed(_t(x), orig).numpy(),
        np.asarray(jle.pad_same_transposed(jnp.asarray(x), orig)))


def _conv_weight(kernel):
    """A Flax conv kernel (kh, kw, in, out) in torch's layout."""
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1).copy())


def _load_conv(conv, params):
    with torch.no_grad():
        conv.weight.copy_(_conv_weight(params["kernel"]))
        conv.bias.copy_(_t(params["bias"]))


LAYERS = {
    "ConvReLU": (lambda dt: jle.ConvReLU(8, 3, 2, compute_dtype=dt),
                 lambda dt: tle.ConvReLU(5, 8, 3, 2, compute_dtype=dt),
                 ("conv",)),
    "ConvReLU2": (lambda dt: jle.ConvReLU2(6, 5, 1, 0.2, compute_dtype=dt),
                  lambda dt: tle.ConvReLU2(5, 6, 5, 1, 0.2,
                                           compute_dtype=dt),
                  ("conv_y", "conv_x")),
    "Upconv": (lambda dt: jle.Upconv(7, compute_dtype=dt),
               lambda dt: tle.Upconv(5, 7, compute_dtype=dt), ("conv",)),
    "ConvSig": (lambda dt: jle.ConvSig(4, 4, 3, compute_dtype=dt),
                lambda dt: tle.ConvSig(5, 4, 4, 3, compute_dtype=dt),
                ("conv",)),
}


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_conv_layers_match_jax(name, bf16):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else \
        (jnp.float32, torch.float32)
    make_j, make_t, convs = LAYERS[name]
    x = np.random.default_rng(4).normal(size=(2, 11, 13, 5)) \
        .astype(np.float32)
    jmod = make_j(jdt)
    params = jmod.init(jax.random.PRNGKey(4), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(
        lambda p: p + 0.05 * jnp.asarray(
            np.random.default_rng(5).normal(size=p.shape), p.dtype), params)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = make_t(tdt)
    for c in convs:
        _load_conv(getattr(tmod, c), params[c])
    with torch.no_grad():
        got = tmod(_t(x))
    assert got.dtype == tdt
    _close(got, want, 2.0**-5 if bf16 else 1e-5)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("hw,skip", [((5, 6), True), ((4, 7), False)])
def test_refine_matches_jax(hw, skip, bf16):
    """Flax's ConvTranspose does not flip its kernel: torch's weight is
    the Flax kernel flipped in both spatial axes, (in, out, kh, kw)."""
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else \
        (jnp.float32, torch.float32)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, *hw, 6)).astype(np.float32)
    direct = rng.normal(size=(2, 2 * hw[0], 2 * hw[1], 3)).astype(np.float32)
    jmod = jle.Refine(5, compute_dtype=jdt)
    params = jmod.init(jax.random.PRNGKey(6), jnp.asarray(x))["params"]
    params["conv2d_t"]["bias"] = jnp.asarray(rng.normal(size=5) * 0.1,
                                             jnp.float32)
    want = jmod.apply({"params": params}, jnp.asarray(x),
                      jnp.asarray(direct) if skip else None)
    tmod = tle.Refine(6, 5, compute_dtype=tdt)
    kernel = np.asarray(params["conv2d_t"]["kernel"])     # (4, 4, in, out)
    with torch.no_grad():
        tmod.conv2d_t.weight.copy_(_t(kernel[::-1, ::-1].transpose(
            2, 3, 0, 1).copy()))
        tmod.conv2d_t.bias.copy_(_t(params["conv2d_t"]["bias"]))
        got = tmod(_t(x), _t(direct) if skip else None)
    assert got.shape == (2, 2 * hw[0], 2 * hw[1], 5 + 3 * skip)
    _close(got, want, 2.0**-5 if bf16 else 1e-5)


def _load_3d(conv, params, bias=True):
    with torch.no_grad():
        conv.weight.copy_(_t(np.asarray(params["kernel"])
                             .transpose(4, 3, 0, 1, 2).copy()))
        if bias:
            conv.bias.copy_(_t(params["bias"]))


@pytest.mark.parametrize("beta", [0.0, 2.0])
def test_resnet3dconv_matches_jax(beta):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 4, 5, 6, 3)).astype(np.float32)
    jmod = jr3d.Resnet3DConv(n_blocks=2, d_hidden=8, d_out=4, beta=beta)
    params = jmod.init(jax.random.PRNGKey(7), jnp.asarray(x))["params"]
    # the zero-initialised second convolutions moved, so they count
    params = jax.tree_util.tree_map(
        lambda p: p + 0.1 * jnp.asarray(rng.normal(size=p.shape),
                                        p.dtype), params)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = tr3d.Resnet3DConv(3, n_blocks=2, d_hidden=8, d_out=4, beta=beta)
    _load_3d(tmod.conv_in, params["conv_in"])
    _load_3d(tmod.conv_out, params["conv_out"])
    for i, block in enumerate(tmod.blocks):
        _load_3d(block.conv_0, params[f"block_{i}"]["conv_0"])
        _load_3d(block.conv_1, params[f"block_{i}"]["conv_1"])
    with torch.no_grad():
        got = tmod(_t(x))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("k,size_out", [(3, 6), (1, 4), (3, 4)])
def test_resnet_block3d_matches_jax(k, size_out):
    """A block with a kernel of 3 ("SAME" padding) and a shortcut where
    the width changes; the second convolution zero-initialised on both
    sides (the block starts as its shortcut)."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(1, 5, 4, 6, 4)).astype(np.float32)
    jmod = jr3d.ResnetBlock3DConv(size_out=size_out, kernel_size=k,
                                  beta=1.0)
    params = jmod.init(jax.random.PRNGKey(8), jnp.asarray(x))["params"]
    tmod = tr3d.ResnetBlock3DConv(4, size_out=size_out, kernel_size=k,
                                  beta=1.0)
    assert float(np.abs(np.asarray(params["conv_1"]["kernel"])).max()) \
        == 0.0 == float(tmod.conv_1.weight.abs().max())
    params = jax.tree_util.tree_map(
        lambda p: p + 0.1 * jnp.asarray(rng.normal(size=p.shape),
                                        p.dtype), params)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    _load_3d(tmod.conv_0, params["conv_0"])
    _load_3d(tmod.conv_1, params["conv_1"])
    if size_out != 4:
        _load_3d(tmod.shortcut, params["shortcut"], bias=False)
    else:
        assert tmod.shortcut is None and "shortcut" not in params
    with torch.no_grad():
        got = tmod(_t(x))
    _close(got, want, 1e-5)
