"""The port's spatial and global encoders (behindthescenes_tpu_torch/
models/encoder.py: SpatialEncoder, ImageEncoder, make_backbone's spatial
and global types) against the JAX package's on the CPU, on weights that
JAX initialises and the bridge (weights.py) carries over, with BatchNorm
statistics and inputs drawn from a numpy seed.

Bounds: f32 within 1e-5 of the map's largest value (the two sides sum
each convolution in another order); bf16 within the bound of the
flagship encoder's bf16 test (tests/test_torch_slice.py:233): 4 bf16
ulps of the largest value, median relative deviation under one ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behindthescenes_tpu.models import encoder as jenc
from behindthescenes_tpu.models.bts import BTSNet as JBTSNet
from behindthescenes_tpu_torch.models import encoder as tenc
from behindthescenes_tpu_torch.models.bts import BTSNet
from behindthescenes_tpu_torch.weights import (flat_from_state_dict,
                                               state_dict_from_flat)

# One intra-op thread: pytest-xdist runs several workers on this CPU,
# and torch's default of a thread per core makes every small op wait
# on threads that the other workers have swapped out.
torch.set_num_threads(1)

F32_OF_MAX = 1e-5


def _flatten(tree, prefix):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        out.update(_flatten(v, key) if isinstance(v, dict)
                   else {key: np.asarray(v, np.float32)})
    return out


def _perturbed_stats(variables, rng):
    """The JAX variables with BatchNorm statistics drawn from `rng` (init
    leaves mean 0, var 1, which would hide a swapped pair)."""
    stats = jax.tree_util.tree_map(
        lambda v: jnp.asarray(rng.uniform(-0.2, 0.2, v.shape)
                              if v.ndim and np.all(np.asarray(v) == 0)
                              else rng.uniform(0.5, 1.5, v.shape),
                              jnp.float32), variables["batch_stats"])
    return {"params": variables["params"], "batch_stats": stats}


def _port_state(variables, strip="encoder."):
    """The JAX encoder's variables as the port's state_dict of the same
    module (BTSNet-level names through the bridge, the BTSNet prefix
    taken off)."""
    flat = {**_flatten(variables["params"], "params/encoder"),
            **_flatten(variables["batch_stats"], "batch_stats/encoder")}
    sd = state_dict_from_flat(flat)
    return {k[len(strip):]: v for k, v in sd.items()}


def _images(seed, shape=(2, 48, 64, 3)):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _sides(btype, conf, seed, dtype_j=jnp.float32, dtype_t=torch.float32):
    x = _images(seed)
    jmod = jenc.make_backbone(dict(conf, type=btype), compute_dtype=dtype_j)
    variables = _perturbed_stats(
        jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x)),
        np.random.default_rng(seed + 100))
    want = [np.asarray(o.astype(jnp.float32))
            for o in jmod.apply(variables, jnp.asarray(x))]
    tmod = tenc.make_backbone(dict(conf, type=btype), compute_dtype=dtype_t)
    tmod.load_state_dict(_port_state(variables), strict=True)
    tmod.eval()
    with torch.no_grad():
        got = tmod(torch.as_tensor(x).permute(0, 3, 1, 2))
    return jmod, tmod, want, got


@pytest.mark.parametrize("layers,num_layers", [(18, 4), (34, 3), (50, 2)])
def test_spatial_encoder_f32_matches_jax(layers, num_layers):
    jmod, tmod, want, got = _sides(
        "spatial", {"resnet_layers": layers, "num_layers": num_layers}, 0)
    assert tmod.latent_size == jmod.latent_size
    assert len(got) == 1 and got[0].dtype == torch.float32
    got = got[0].permute(0, 2, 3, 1).numpy()
    assert got.shape == want[0].shape == (2, 24, 32, jmod.latent_size)
    np.testing.assert_allclose(got, want[0],
                               atol=F32_OF_MAX * np.abs(want[0]).max())


@pytest.mark.parametrize("btype,conf", [
    ("spatial", {"resnet_layers": 18}),
    ("global", {"resnet_layers": 18, "latent_size": 32})])
def test_bf16_encoders_match_jax(btype, conf):
    _, _, want, got = _sides(btype, conf, 1, jnp.bfloat16, torch.bfloat16)
    assert got[0].dtype == torch.float32
    got = got[0].numpy() if btype == "global" \
        else got[0].permute(0, 2, 3, 1).numpy()
    dev = np.abs(got - want[0])
    np.testing.assert_allclose(got, want[0],
                               atol=2.0**-5 * np.abs(want[0]).max())
    assert np.median(dev / np.maximum(np.abs(want[0]), 1e-3)) < 2.0**-7


@pytest.mark.parametrize("layers", [18, 34])
def test_image_encoder_f32_matches_jax(layers):
    jmod, tmod, want, got = _sides(
        "global", {"resnet_layers": layers, "latent_size": 24}, 2)
    assert tmod.latent_size == jmod.latent_size == 24
    assert got[0].shape == want[0].shape == (2, 24)
    np.testing.assert_allclose(got[0].numpy(), want[0],
                               atol=F32_OF_MAX * np.abs(want[0]).max())


def test_image_encoder_fc_round_trips_through_the_bridge():
    """encoder/fc maps both ways: the port's state_dict back to Flax keys
    gives the arrays JAX initialised."""
    jmod, tmod, _, _ = _sides("global", {"resnet_layers": 18,
                                         "latent_size": 8}, 3)
    sd = {f"encoder.{k}": v for k, v in tmod.state_dict().items()}
    flat = flat_from_state_dict(sd)
    assert flat["params/encoder/fc/kernel"].shape == (512, 8)
    jvars = jmod.init(jax.random.PRNGKey(3), jnp.zeros((1, 48, 64, 3)))
    np.testing.assert_array_equal(flat["params/encoder/fc/kernel"],
                                  np.asarray(jvars["params"]["fc"]["kernel"]))
    np.testing.assert_array_equal(flat["params/encoder/fc/bias"],
                                  np.asarray(jvars["params"]["fc"]["bias"]))


MODEL_CONF = {
    "z_near": 1.0, "z_far": 40.0, "inv_z": True, "learn_empty": True,
    "code_mode": "z",
    "code": {"num_freqs": 6, "freq_factor": 1.5, "include_input": True},
    "encoder": {"type": "spatial", "resnet_layers": 18, "num_layers": 4},
    "mlp_coarse": {"type": "resnet", "n_blocks": 0, "d_hidden": 32},
    "mlp_fine": {"type": "empty"},
}


def test_btsnet_encode_and_query_with_spatial_match_jax():
    """BTSNet with the spatial encoder: the feature grid (n, v, h/2, w/2,
    512) and a density query at world points, JAX-initialised weights
    through the bridge. Features within F32_OF_MAX of their max; sigma
    within 1e-4 relative (the MLP sums 551 inputs)."""
    rng = np.random.default_rng(4)
    images = rng.uniform(-1, 1, (1, 2, 48, 64, 3)).astype(np.float32)
    ks = np.tile(np.array([[1.2, 0, 0], [0, 1.6, 0], [0, 0, 1]],
                          np.float32), (1, 2, 1, 1))
    poses = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    poses[0, 1, 0, 3] = 0.3
    xyz = np.stack([rng.uniform(-2, 2, 64), rng.uniform(-1, 1, 64),
                    rng.uniform(2, 20, 64)], -1)[None].astype(np.float32)
    jnet = JBTSNet.from_conf(MODEL_CONF)
    variables = jnet.init(jax.random.PRNGKey(4), jnp.asarray(images),
                          jnp.asarray(ks), jnp.asarray(poses),
                          jnp.asarray(xyz))
    variables = {"params": variables["params"],
                 "batch_stats": _perturbed_stats(
                     {"params": None, "batch_stats":
                      variables["batch_stats"]["encoder"]},
                     rng)["batch_stats"]}
    variables["batch_stats"] = {"encoder": variables["batch_stats"]}
    jgrid = jnet.apply(variables, jnp.asarray(images), jnp.asarray(ks),
                       jnp.asarray(poses), ids_encoder=[0],
                       method=JBTSNet.encode)
    _, _, jsigma = jnet.apply(variables, jgrid, jnp.asarray(xyz),
                              only_density=True, method=JBTSNet.query)
    net = BTSNet.from_conf(MODEL_CONF)
    net.load_state_dict(state_dict_from_flat(
        {**_flatten(variables["params"], "params"),
         **_flatten(variables["batch_stats"], "batch_stats")}), strict=True)
    with torch.no_grad():
        grid = net.encode(torch.as_tensor(images), torch.as_tensor(ks),
                          torch.as_tensor(poses), ids_encoder=[0])
        _, _, sigma = net.query(grid, torch.as_tensor(xyz),
                                only_density=True)
    want = np.asarray(jgrid.features[0])
    assert want.shape == (1, 1, 24, 32, 512)
    np.testing.assert_allclose(grid.features[0].numpy(), want,
                               atol=F32_OF_MAX * np.abs(want).max())
    np.testing.assert_allclose(sigma.numpy(), np.asarray(jsigma), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(jsigma)).max())


def test_both_packages_refuse_a_btsnet_grid_from_global():
    """The global encoder's (n, latent) output has no pixels: JAX's encode
    fails where it flips each latent's width axis (IndexError), and the
    port refuses the net when it is built."""
    conf = dict(MODEL_CONF, encoder={"type": "global", "resnet_layers": 18,
                                     "latent_size": 16})
    images = jnp.zeros((1, 1, 48, 64, 3))
    ks = jnp.tile(jnp.eye(3), (1, 1, 1, 1))
    poses = jnp.tile(jnp.eye(4), (1, 1, 1, 1))
    with pytest.raises(IndexError):
        JBTSNet.from_conf(conf).init(jax.random.PRNGKey(0), images, ks,
                                     poses, jnp.zeros((1, 4, 3)))
    with pytest.raises(ValueError, match="global"):
        BTSNet.from_conf(conf)


@pytest.mark.parametrize("btype,bad", [
    ("spatial", "d_out"), ("spatial", "remat"), ("global", "num_layers"),
    ("global", "freeze")])
def test_unknown_keys_raise_in_both(btype, bad):
    conf = {"type": btype, bad: 1}
    with pytest.raises(ValueError, match=bad):
        jenc.make_backbone(conf)
    with pytest.raises(ValueError, match=bad):
        tenc.make_backbone(conf)


@pytest.mark.parametrize("btype,size", [("spatial", 512), ("global", 128)])
def test_defaults_match_jax(btype, size):
    """Both types default to ResNet-34: spatial with 4 layers (64 + 64 +
    128 + 256 channels), global with a 128-wide latent."""
    jmod = jenc.make_backbone({"type": btype})
    tmod = tenc.make_backbone({"type": btype})
    assert tmod.latent_size == jmod.latent_size == size
    assert len(tmod.encoder.encoder.layer2) == 4       # ResNet-34
    with pytest.raises(NotImplementedError):
        tenc.make_backbone({"type": "unknown"})
