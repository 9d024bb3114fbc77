"""Where the port's bf16 layers add their bias (ROADMAP Queue C): a Flax
Dense or Conv with dtype bf16 rounds the product (or the convolution) to
bf16 and then adds the bias in bf16, two roundings; the port's dense and
conv helpers fused the bias into the product and rounded once, one bf16
ulp off JAX in 61-64% of a random ResnetFC's outputs and in 14-16% of a
KITTI-360 density query's (the occupancy evaluators' tests found it).
Both now round as Flax does."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behindthescenes_tpu.models.encoder import ConvBlock3x3
from behindthescenes_tpu.models.mlp import make_mlp as j_make_mlp
from behindthescenes_tpu_torch.models.encoder import Conv3x3
from behindthescenes_tpu_torch.models.mlp import make_mlp

# One intra-op thread: pytest-xdist runs several workers on this CPU,
# and torch's default of a thread per core makes every small op wait
# on threads that the other workers have swapped out.
torch.set_num_threads(1)

D_IN = 103


def _torch_name(path):
    """A Flax ResnetFC parameter path -> the port's state_dict key."""
    *mods, leaf = path
    mods = [f"blocks.{m.split('_')[1]}" if m.startswith("block_") else m
            for m in mods]
    return ".".join(mods + ["weight" if leaf == "kernel" else "bias"])


# The share of a ResnetFC's bf16 outputs that may differ from JAX's: the
# two frameworks sum a layer's f32 products in different orders, and a
# last-bit difference of the sum can round to the other bf16 neighbour
# (measured: at most 1 of 4,096 outputs; with a fused bias 61-64%;
# tools/k360_agreement.py).
SHARE = 1e-3


@pytest.mark.parametrize("n_blocks", [0, 1])
def test_bf16_resnetfc_rounds_its_bias_as_flax(n_blocks):
    """The flagship-width ResnetFC in bf16 (lin_in and lin_out in bf16,
    the blocks in f32 as Flax promotes them) on the same weights, with
    nonzero biases, and the same inputs: at most SHARE of the outputs
    differ."""
    conf = {"type": "resnet", "n_blocks": n_blocks, "d_hidden": 64}
    jm = j_make_mlp(conf, d_out=1, dtype=jnp.bfloat16)
    rng = np.random.default_rng(0)
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, D_IN)))["params"]
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        params)
    x = rng.standard_normal((4096, D_IN)).astype(np.float32)
    want = np.asarray(jm.apply({"params": params},
                               jnp.asarray(x, jnp.bfloat16))
                      .astype(jnp.float32))
    net = make_mlp(conf, D_IN, 1, dtype=torch.bfloat16)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    net.load_state_dict({
        _torch_name([k.key for k in path]):
            torch.as_tensor(np.array(v).T if path[-1].key == "kernel"
                            else np.array(v)) for path, v in flat})
    with torch.no_grad():
        got = net(torch.as_tensor(x).bfloat16()).float().numpy()
    assert got.shape == want.shape
    assert np.mean(got != want) <= SHARE


def test_bf16_decoder_conv_rounds_its_bias_as_flax():
    """The decoder's reflect-padded 3x3 conv in bf16 against the JAX
    package's ConvBlock3x3 on the same weights, with inputs and weights
    whose sums are exact in f32 (so only the rounding points can differ):
    bit-equal (with a fused bias some outputs round to the other bf16
    neighbour)."""
    rng = np.random.default_rng(0)
    x = rng.integers(-4, 5, (1, 12, 10, 16)).astype(np.float32)
    w = rng.integers(-8, 9, (3, 3, 16, 8)).astype(np.float32) / 8
    b = rng.integers(-512, 512, 8).astype(np.float32) / 64
    want = np.asarray(ConvBlock3x3(8, elu=False,
                                   compute_dtype=jnp.bfloat16).apply(
        {"params": {"conv": {"kernel": jnp.asarray(w),
                             "bias": jnp.asarray(b)}}},
        jnp.asarray(x)).astype(jnp.float32))
    conv = Conv3x3(16, 8)
    conv.conv.load_state_dict({
        "weight": torch.as_tensor(w.transpose(3, 2, 0, 1).copy()),
        "bias": torch.as_tensor(b)})
    with torch.no_grad():
        got = conv(torch.as_tensor(x).permute(0, 3, 1, 2), torch.bfloat16)
    np.testing.assert_array_equal(
        got.float().permute(0, 2, 3, 1).numpy(), want)
