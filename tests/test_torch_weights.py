"""The port's weight bridge (behindthescenes_tpu_torch/weights.py) on the
committed flagship artifact: every array lands in the port's state_dict
under the reference torch name, and the port's ResNet-50 encoder computes
the JAX package's features from the same image.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behindthescenes_tpu import geometry as jgeo
from behindthescenes_tpu.import_torch import import_bts_checkpoint
from behindthescenes_tpu.models.bts import BTSNet as JBTSNet
from behindthescenes_tpu.utils.io import load_params_npz as j_load_npz
from behindthescenes_tpu_torch import geometry as tgeo
from behindthescenes_tpu_torch.eval_depth import (FLAGSHIP_MODEL_CONF,
                                                  load_model)
from behindthescenes_tpu_torch.weights import (load_params_npz,
                                               state_dict_from_flat,
                                               torch_name)

# One intra-op thread: pytest-xdist runs several workers on this CPU,
# and torch's default of a thread per core makes every small op wait
# on threads that the other workers have swapped out.
torch.set_num_threads(1)

ARTIFACT = os.path.join(os.path.dirname(__file__), "..", "media", "weights",
                        "flagship_fast_conv.npz")


@pytest.fixture(scope="module")
def flat():
    return load_params_npz(ARTIFACT)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, key) if isinstance(v, dict) else {key: v})
    return out


def test_npz_reader_matches_jax(flat):
    want = _flatten(j_load_npz(ARTIFACT))
    assert sorted(flat) == sorted(want)
    for k, v in want.items():
        assert flat[k].dtype == np.float32
        np.testing.assert_array_equal(flat[k], v)


def test_every_array_loads_strictly(flat):
    net = load_model(ARTIFACT, device="cpu")
    sd = net.state_dict()
    n_bn = sum(k.endswith("running_mean") for k in sd)
    assert len(sd) == len(flat) + n_bn       # + num_batches_tracked
    assert sd["encoder.encoder.encoder.conv1.weight"].shape == (64, 3, 7, 7)
    np.testing.assert_array_equal(
        sd["encoder.encoder.encoder.conv1.weight"].numpy(),
        flat["params/encoder/encoder/conv1/kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["mlp_coarse.lin_in.weight"].numpy(),
        flat["params/mlp_coarse/lin_in/kernel"].T)


@pytest.mark.parametrize("key,name", [
    ("params/encoder/encoder/bn1/scale", "encoder.encoder.encoder.bn1.weight"),
    ("batch_stats/encoder/encoder/layer3_0/downsample/bn/var",
     "encoder.encoder.encoder.layer3.0.downsample.1.running_var"),
    ("params/encoder/encoder/layer2_1/conv3/bn/bias",
     "encoder.encoder.encoder.layer2.1.bn3.bias"),
    ("params/encoder/decoder/upconv_3_1/conv/kernel",
     "encoder.decoder.decoder.3.conv.conv.weight"),
    ("params/encoder/decoder/dispconv_0/conv/bias",
     "encoder.decoder.decoder.10.conv.bias"),
    ("params/mlp_coarse/block_2/fc_1/kernel", "mlp_coarse.blocks.2.fc_1.weight"),
    ("params/mlp_fine/lin_3/bias", "mlp_fine.lin3.bias"),
])
def test_torch_names(key, name):
    assert torch_name(key, (0,))[0] == name


def test_names_are_the_reference_checkpoint_keys(flat, tmp_path):
    """Saved as a torch checkpoint, the port's state_dict goes through the
    JAX package's importer of REFERENCE checkpoints (import_torch.py) and
    gives back exactly the artifact's arrays."""
    path = tmp_path / "port.pt"
    torch.save(state_dict_from_flat(flat), path)
    params, stats = import_bts_checkpoint(str(path), resnet_layers=50,
                                          scales=(0,))
    got = _flatten({"params": params, "batch_stats": stats})
    assert sorted(got) == sorted(flat)
    for k, v in got.items():
        np.testing.assert_array_equal(np.asarray(v), flat[k])


def test_flagship_encoder_features_match_jax():
    """ResNet-50 features of one 64x192 image, f32 on both sides.
    Tolerance 1e-4 abs + 1e-4 rel: the f32 convolutions sum up to
    3*3*2048 terms per output in another order than XLA, over some 60
    layers (measured max deviation ~3e-5 at feature values ~11)."""
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (1, 2, 64, 192, 3)).astype(np.float32)
    ks = np.tile(np.array([[1.2, 0, 0], [0, 3.6, 0], [0, 0, 1]], np.float32),
                 (1, 2, 1, 1))
    poses = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    poses[0, 1, 0, 3] = 0.4

    jnet = JBTSNet.from_conf(FLAGSHIP_MODEL_CONF)
    grid = jnet.apply(j_load_npz(ARTIFACT), jnp.asarray(images),
                      jnp.asarray(ks), jgeo.rebase_poses_to_keyframe(
                          jnp.asarray(poses)),
                      ids_encoder=[0], ids_render=[0], method=JBTSNet.encode)
    want = np.asarray(grid.features[0])

    net = load_model(ARTIFACT, device="cpu")
    with torch.no_grad():
        tgrid = net.encode(torch.as_tensor(images), torch.as_tensor(ks),
                           tgeo.rebase_poses_to_keyframe(
                               torch.as_tensor(poses)),
                           ids_encoder=[0], ids_render=[0])
    got = tgrid.features[0].numpy()
    assert got.shape == want.shape == (1, 1, 64, 192, 64)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tgrid.f_poses_w2c.numpy(),
                               np.asarray(grid.f_poses_w2c), atol=1e-6)
    np.testing.assert_allclose(tgrid.color_imgs.numpy(),
                               np.asarray(grid.color_imgs), atol=1e-7)
