"""The port's single-image depth slice as a whole, against the JAX
package on the same inputs: the committed synthetic checkpoint
(media/weights/synthetic_conv_step8400.npz, the exp_synthetic model:
ResNet-18, 16-channel latents, ResnetFC width 32) at 48x64 with 24 coarse
samples, deterministic and jittered, plus the other MLP branches of the
self-view query and the synthetic scenes themselves.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behindthescenes_tpu import geometry as jgeo
from behindthescenes_tpu import renderer as jrenderer
from behindthescenes_tpu.datasets.synthetic import \
    SyntheticBoxDataset as JDataset
from behindthescenes_tpu.evaluation.depth import DepthEvaluator as JEval
from behindthescenes_tpu.inference import render_depth_selfview as jrender
from behindthescenes_tpu.models.bts import BTSNet as JBTSNet
from behindthescenes_tpu.models.mlp import make_mlp as j_make_mlp
from behindthescenes_tpu.utils.io import load_params_npz as j_load_npz
from behindthescenes_tpu_torch import geometry as tgeo
from behindthescenes_tpu_torch.datasets.synthetic import \
    SyntheticBoxDataset as TDataset
from behindthescenes_tpu_torch.datasets.synthetic import make_test_dataset
from behindthescenes_tpu_torch.eval_depth import evaluate, load_model
from behindthescenes_tpu_torch.evaluation.depth import DepthEvaluator
from behindthescenes_tpu_torch.inference import render_depth_selfview
from behindthescenes_tpu_torch.models.bts import (BTSNet,
                                                  selfview_decode_route)
from behindthescenes_tpu_torch.models.mlp import ResnetFC
from behindthescenes_tpu_torch.renderer import RendererConfig
from behindthescenes_tpu_torch.weights import state_dict_from_flat

# One intra-op thread: pytest-xdist runs several workers on this CPU,
# and torch's default of a thread per core makes every small op wait
# on threads that the other workers have swapped out.
torch.set_num_threads(1)

ARTIFACT = os.path.join(os.path.dirname(__file__), "..", "media", "weights",
                        "synthetic_conv_step8400.npz")
# configs/exp_synthetic.yaml model_conf.
MODEL_CONF = {
    "z_near": 1.0, "z_far": 40.0, "inv_z": True, "learn_empty": False,
    "code_mode": "z",
    "code": {"num_freqs": 6, "freq_factor": 1.5, "include_input": True},
    "encoder": {"type": "monodepth2", "resnet_layers": 18,
                "num_ch_dec": (16, 16, 32, 32, 64), "d_out": 16,
                "scales": (0,)},
    "mlp_coarse": {"type": "resnet", "n_blocks": 0, "d_hidden": 32},
    "mlp_fine": {"type": "empty"},
}
H, W, K = 48, 64, 24
J_CFG = jrenderer.RendererConfig(n_coarse=K, lindisp=True,
                                 hard_alpha_cap=True)
T_CFG = RendererConfig(n_coarse=K, lindisp=True, hard_alpha_cap=True)
# Depth tolerance (metres, depths up to 40): both sides are f32 end to end;
# the encoder's convolutions sum in another order, which moves densities
# by ~1e-5 and the composited depth by about as much times the depth.
DEPTH_ATOL = 2e-3


@pytest.mark.parametrize("kw", [
    dict(height=48, width=64, seed=2),
    dict(height=24, width=40, seed=1, frame_count=4),
    dict(height=24, width=32, seed=3, thin_structures=2),
    dict(height=24, width=32, seed=2, scene_type="indoor"),
])
def test_synthetic_scenes_are_identical(kw):
    jds, tds = JDataset(length=3, **kw), TDataset(length=3, **kw)
    for i in range(2):
        a, b = jds[i], tds[i]
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.fixture(scope="module")
def batch():
    ds = make_test_dataset(image_size=(H, W))
    s = ds[1]
    return {k: v[None] for k, v in s.items()}


@pytest.fixture(scope="module")
def jax_side(batch):
    net = JBTSNet.from_conf(MODEL_CONF)
    variables = j_load_npz(ARTIFACT)
    poses_r = jgeo.rebase_poses_to_keyframe(jnp.asarray(batch["poses"]))
    grid = net.apply(variables, jnp.asarray(batch["imgs"]),
                     jnp.asarray(batch["projs"]), poses_r, ids_encoder=[0],
                     ids_render=[0], method=JBTSNet.encode)
    return net, variables, grid


@pytest.fixture(scope="module")
def port_side(batch):
    net = load_model(ARTIFACT, MODEL_CONF, device="cpu")
    poses_r = tgeo.rebase_poses_to_keyframe(torch.as_tensor(batch["poses"]))
    with torch.no_grad():
        grid = net.encode(torch.as_tensor(batch["imgs"]),
                          torch.as_tensor(batch["projs"]), poses_r,
                          ids_encoder=[0], ids_render=[0])
    return net, grid


def test_test_split_matches_jax_factory():
    from behindthescenes_tpu.datasets.factory import make_datasets
    _, jds = make_datasets({"type": "Synthetic", "image_size": [H, W],
                            "data_fc": 2, "length": 64})
    tds = make_test_dataset(image_size=(H, W), length=64)
    assert len(tds) == len(jds)
    np.testing.assert_array_equal(tds[3]["depths"], jds[3]["depths"])


def test_deterministic_depth_matches_jax(jax_side, port_side):
    jnet, variables, jgrid = jax_side
    net, grid = port_side
    want, jw, _ = jrender(jnet, variables, jgrid, jax.random.PRNGKey(0), H,
                          W, J_CFG, 1.0, 40.0, deterministic=True)
    with torch.no_grad():
        got, tw, _ = render_depth_selfview(net, grid, H, W, T_CFG, 1.0, 40.0,
                                           deterministic=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=DEPTH_ATOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-4)


def test_jittered_depth_matches_jax_with_same_z(jax_side, port_side):
    """The port takes the JAX run's own stratified z (same key) as
    `z_samp`; its f32 decode is the selfview kernel's plain version, the
    JAX one is call_split + softplus."""
    jnet, variables, jgrid = jax_side
    net, grid = port_side
    key = jax.random.PRNGKey(7)
    want, _, z = jrender(jnet, variables, jgrid, key, H, W, J_CFG, 1.0,
                         40.0, deterministic=False)
    rays = jnp.concatenate([jnp.zeros((H * W, 6)),
                            jnp.full((H * W, 1), 1.0),
                            jnp.full((H * W, 1), 40.0)], -1)
    np.testing.assert_array_equal(
        np.asarray(z), np.asarray(jrenderer.sample_coarse(key, rays, K,
                                                          True)))
    with torch.no_grad():
        got, _, _ = render_depth_selfview(
            net, grid, H, W, T_CFG, 1.0, 40.0, deterministic=False,
            z_samp=torch.as_tensor(np.array(z)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=DEPTH_ATOL)


def test_depth_metrics_match_jax_evaluator(batch):
    """DepthEvaluator end to end (deterministic, the eval default) on two
    test scenes: the metrics agree to 1e-4."""
    jnet = JBTSNet.from_conf(MODEL_CONF)
    variables = j_load_npz(ARTIFACT)
    jev = JEval(jnet, J_CFG, MODEL_CONF)
    net = load_model(ARTIFACT, MODEL_CONF, device="cpu")
    ds = make_test_dataset(image_size=(H, W))
    batches = [{k: v[None] for k, v in ds[i].items()} for i in range(2)]
    means, per_scene = evaluate(net, batches, MODEL_CONF, T_CFG)
    for b, got in zip(batches, per_scene):
        want = jev.evaluate(variables, b)
        for k in ("abs_rel", "sq_rel", "rmse", "a1", "a2", "a3"):
            assert abs(got[k] - want[k]) < 1e-4, (k, got[k], want[k])
    assert set(means) == set(per_scene[0])


def test_bf16_jitter_takes_the_jitter_kernel_path(batch, port_side,
                                                  monkeypatch):
    """bf16 compute routes the jittered decode through call_split_jitter
    (the jitter_density kernel's wrapper; its plain version on the CPU)
    and stays near the f32 depth."""
    net16 = load_model(ARTIFACT, MODEL_CONF, bf16=True, device="cpu")
    calls = []
    orig = ResnetFC.call_split_jitter
    monkeypatch.setattr(ResnetFC, "call_split_jitter",
                        lambda self, *a, **k: calls.append(1)
                        or orig(self, *a, **k))
    ev16 = DepthEvaluator(net16, T_CFG, MODEL_CONF, jitter=True)
    ev32 = DepthEvaluator(port_side[0], T_CFG, MODEL_CONF, jitter=True)
    args = [torch.as_tensor(batch[k]) for k in ("imgs", "projs", "poses")]
    z = torch.as_tensor(np.random.default_rng(0).uniform(
        1.0, 40.0, (H * W, K)).astype(np.float32)).sort(-1).values
    d16 = ev16.render(*args, z_samp=z)
    d32 = ev32.render(*args, z_samp=z)
    assert calls and torch.isfinite(d16).all()
    rel = ((d16 - d32).abs() / d32).median().item()
    assert rel < 0.02, rel


@pytest.fixture(scope="module")
def bf16_sides(batch):
    """Both packages at bf16 compute (the eval harness default,
    behindthescenes_tpu/evaluation/tasks.py:25): each side's own encoder,
    then a jittered render with the JAX run's stratified z fed to the
    port. The JAX decode is forced onto its jitter_density kernel
    (interpret mode on the CPU), as it runs on a TPU."""
    from behindthescenes_tpu.ops.pallas import jitter_density as jjd
    jnet = JBTSNet.from_conf(MODEL_CONF, compute_dtype=jnp.bfloat16)
    variables = j_load_npz(ARTIFACT)
    poses_r = jgeo.rebase_poses_to_keyframe(jnp.asarray(batch["poses"]))
    jgrid = jnet.apply(variables, jnp.asarray(batch["imgs"]),
                       jnp.asarray(batch["projs"]), poses_r, ids_encoder=[0],
                       ids_render=[0], method=JBTSNet.encode)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BTS_JITTER_PALLAS", "1")
        orig = jjd.jitter_density_pallas
        mp.setattr(jjd, "jitter_density_pallas",
                   lambda *a, **k: calls.append(1) or orig(*a, **k))
        want, _, z = jrender(jnet, variables, jgrid, jax.random.PRNGKey(7),
                             H, W, J_CFG, 1.0, 40.0, deterministic=False)
        want_sigma = jnet.apply(variables, jgrid, z,
                                method=JBTSNet.query_selfview_density)
    assert calls, "the JAX bf16 decode did not take its kernel"
    net = load_model(ARTIFACT, MODEL_CONF, bf16=True, device="cpu")
    poses_t = tgeo.rebase_poses_to_keyframe(torch.as_tensor(batch["poses"]))
    with torch.no_grad():
        grid = net.encode(torch.as_tensor(batch["imgs"]),
                          torch.as_tensor(batch["projs"]), poses_t,
                          ids_encoder=[0], ids_render=[0])
    return dict(jnet=jnet, variables=variables, jgrid=jgrid,
                want=np.asarray(want), want_sigma=np.asarray(want_sigma),
                z=np.array(z), net=net, grid=grid)


def test_bf16_encoder_features_match_jax(bf16_sides):
    """ResNet-18 features at bf16 compute (each conv rounds its inputs
    and weights to bf16): within 4 bf16 ulps of the map's largest value
    (atol 2^-5 max|f|), median relative deviation within one ulp (2^-7)."""
    want = np.asarray(bf16_sides["jgrid"].features[0].astype(jnp.float32))
    got = bf16_sides["grid"].features[0]
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    dev = np.abs(got - want)
    np.testing.assert_allclose(got, want, atol=2.0**-5 * np.abs(want).max())
    assert np.median(dev / np.maximum(np.abs(want), 1e-3)) < 2.0**-7


def test_bf16_jittered_decode_matches_jax_on_same_features(bf16_sides):
    """The bf16 jittered decode (lattice, bf16 static hidden, the
    jitter_density kernel's plain version) on the JAX run's own features
    and z: density within the jitter kernel's bf16 tolerance, atol/rtol
    2e-2 (tests/test_pallas_jitter.py)."""
    net, grid = bf16_sides["net"], bf16_sides["grid"]
    feats = torch.as_tensor(np.array(
        bf16_sides["jgrid"].features[0].astype(jnp.float32))) \
        .to(torch.bfloat16)
    same = dataclasses.replace(grid, features=(feats,))
    with torch.no_grad():
        got = net.query_selfview_density(same,
                                         torch.as_tensor(bf16_sides["z"]))
    np.testing.assert_allclose(got.float().numpy(), bf16_sides["want_sigma"],
                               atol=2e-2, rtol=2e-2)


def test_bf16_deterministic_decode_matches_jax_on_same_features(bf16_sides):
    """The JAX package's default evaluation (bf16 compute, the shared
    camera-z ladder, shared_z_tail_jnp) against the port's bf16
    deterministic decode (the shared_z kernel's plain version) on the JAX
    run's own features: both add hs + hd in bf16 before the relu and sum
    the same bf16 terms in f32, so the densities (up to 16 here) agree
    within 1e-5, the shared_z kernel's f32 tolerance. Adding hs + hd in
    f32 instead misses by up to 6e-2."""
    net, grid = bf16_sides["net"], bf16_sides["grid"]
    s = (np.arange(K, dtype=np.float32) + 0.5) / K
    z_cam = (1.0 / ((1.0 - s) / 1.0 + s / 40.0)).astype(np.float32)
    want = bf16_sides["jnet"].apply(
        bf16_sides["variables"], bf16_sides["jgrid"], jnp.asarray(z_cam),
        method=JBTSNet.query_selfview_density_shared_z)
    feats = torch.as_tensor(np.array(
        bf16_sides["jgrid"].features[0].astype(jnp.float32))) \
        .to(torch.bfloat16)
    same = dataclasses.replace(grid, features=(feats,))
    with torch.no_grad():
        got = net.query_selfview_density_shared_z(same,
                                                  torch.as_tensor(z_cam))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1e-5)


def test_bf16_jittered_depth_matches_jax(bf16_sides):
    """Jittered bf16 depth end to end, each side from its own encoder,
    with the same z: median relative deviation within 2^-8 and the largest
    within 2^-4, the bf16 feature deviations above carried through the
    decode and the composite."""
    net, grid = bf16_sides["net"], bf16_sides["grid"]
    with torch.no_grad():
        got, _, _ = render_depth_selfview(
            net, grid, H, W, T_CFG, 1.0, 40.0, deterministic=False,
            z_samp=torch.as_tensor(bf16_sides["z"]))
    want = bf16_sides["want"]
    rel = np.abs(got.float().numpy() - want) / want
    assert np.median(rel) < 2.0**-8, np.median(rel)
    assert rel.max() < 2.0**-4, rel.max()


def _jax_init(mlp_conf, code_mode="z", d_out=1):
    conf = dict(MODEL_CONF, mlp_coarse=mlp_conf, code_mode=code_mode,
                sample_color=d_out == 1)
    net = JBTSNet.from_conf(conf)
    rng = np.random.default_rng(0)
    images = jnp.asarray(rng.uniform(-1, 1, (1, 1, 64, 96, 3)), jnp.float32)
    ks = jnp.asarray(np.tile(np.array([[1.2, 0, 0], [0, 1.8, 0], [0, 0, 1]],
                                      np.float32), (1, 1, 1, 1)))
    poses = jnp.asarray(np.tile(np.eye(4, dtype=np.float32), (1, 1, 1, 1)))
    # The trained encoder of the artifact, a JAX-initialized MLP.
    variables = j_load_npz(ARTIFACT)
    d_in = MODEL_CONF["encoder"]["d_out"] + 39
    mlp = j_make_mlp(mlp_conf, d_out=d_out)
    variables["params"]["mlp_coarse"] = mlp.init(
        jax.random.PRNGKey(0), jnp.zeros((1, d_in)))["params"]
    return conf, net, variables, images, ks, poses


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, key) if isinstance(v, dict)
                   else {key: np.asarray(v, np.float32)})
    return out


@pytest.mark.parametrize("mlp_conf,code_mode", [
    ({"type": "resnet", "n_blocks": 1, "d_hidden": 32}, "z"),
    ({"type": "mlp", "dims": [32, 32], "skip_in": [1]}, "distance"),
    ({"type": "resnet", "n_blocks": 0, "d_hidden": 16}, "distance"),
])
def test_other_mlp_branches_match_jax(mlp_conf, code_mode):
    """ResnetFC with blocks (call_split), the generic-MLP branch and the
    distance code: JAX-initialized weights through the bridge, the same
    z samples on both sides. Tolerance 2e-5 on sigma (f32 both sides)."""
    conf, jnet, variables, images, ks, poses = _jax_init(mlp_conf, code_mode)
    jgrid = jnet.apply(variables, images, ks, poses, ids_encoder=[0],
                       method=JBTSNet.encode)
    z = np.sort(np.random.default_rng(1).uniform(1, 40, (64 * 96, 8)), -1) \
        .astype(np.float32)
    want = jnet.apply(variables, jgrid, jnp.asarray(z),
                      method=JBTSNet.query_selfview_density)
    net = BTSNet.from_conf(conf)
    net.load_state_dict(state_dict_from_flat(_flatten(variables)))
    with torch.no_grad():
        grid = net.encode(*(torch.as_tensor(np.asarray(a))
                            for a in (images, ks, poses)), ids_encoder=[0])
        got = net.query_selfview_density(grid, torch.as_tensor(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)


def _port_net(conf, variables, compute_dtype=torch.float32):
    net = BTSNet.from_conf(conf, compute_dtype=compute_dtype)
    net.load_state_dict(state_dict_from_flat(_flatten(variables)))
    return net


def _port_grid_on_jax_features(net, jgrid, images, ks, poses):
    """The port's FeatureGrid with the JAX run's own features, so that
    the decode alone is compared."""
    with torch.no_grad():
        grid = net.encode(*(torch.as_tensor(np.asarray(a))
                            for a in (images, ks, poses)), ids_encoder=[0])
    feats = torch.as_tensor(np.array(jgrid.features[0].astype(jnp.float32)))
    return dataclasses.replace(grid, features=(feats.to(net.compute_dtype),))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_shared_ladder_multi_column_matches_jax(bf16):
    """`sample_color: false` (d_out 4, a relu density) on the deterministic
    ladder: JAX sends every no-block ResnetFC to shared_z_tail, which for
    D != 1 is shared_z_tail_jnp (the relu in the compute dtype, the
    contraction and b_out in f32). The port's density matches within
    1e-5, the shared_z tolerance, on the JAX run's own features; the
    bf16 lin_out the port used before was 1.6e-2 off."""
    mlp_conf = {"type": "resnet", "n_blocks": 0, "d_hidden": 32}
    conf, jnet, variables, images, ks, poses = _jax_init(mlp_conf, d_out=4)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    jnet = JBTSNet.from_conf(conf, compute_dtype=jdt)
    jgrid = jnet.apply(variables, images, ks, poses, ids_encoder=[0],
                       method=JBTSNet.encode)
    s = (np.arange(K, dtype=np.float32) + 0.5) / K
    z_cam = (1.0 / ((1.0 - s) / 1.0 + s / 40.0)).astype(np.float32)
    want = jnet.apply(variables, jgrid, jnp.asarray(z_cam),
                      method=JBTSNet.query_selfview_density_shared_z)
    net = _port_net(conf, variables,
                    torch.bfloat16 if bf16 else torch.float32)
    grid = _port_grid_on_jax_features(net, jgrid, images, ks, poses)
    with torch.no_grad():
        got = net.query_selfview_density_shared_z(grid,
                                                  torch.as_tensor(z_cam))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1e-5)


@pytest.mark.parametrize("args,route", [
    ((True, True, True, True, True, 64, 64, 6), "jitter"),
    ((True, True, True, True, True, 30, 48, 6), "jitter"),
    ((True, True, True, True, True, 64, 64, 4), "jitter"),
    ((True, True, True, False, True, 64, 64, 6), "selfview"),
    ((True, True, True, False, True, 24, 32, 6), "selfview"),
    ((True, True, True, False, True, 30, 32, 6), "call_split"),
    ((True, True, True, False, True, 64, 48, 6), "call_split"),
    ((True, True, True, False, True, 64, 64, 4), "call_split"),
    ((True, True, True, False, False, 64, 64, 6), "call_split"),
    ((True, False, True, True, True, 64, 64, 6), "call_split"),
    ((True, True, False, True, True, 64, 64, 6), "call_split"),
    ((False, False, True, False, True, 64, 64, 6), "generic"),
])
def test_selfview_decode_route(args, route):
    """(ResnetFC, no blocks, input in the code, bf16, softplus density, K,
    H, octaves) -> the jittered decode's route, chosen before any call:
    bf16 no-block models take the jitter_density kernels at every shape,
    as JAX takes its kernel; f32 ones the selfview kernel where it is built
    for the shapes, else call_split, JAX's own f32 route."""
    assert selfview_decode_route(*args) == route


@pytest.mark.parametrize("h,k", [(48, 8), (32, 30)],
                         ids=["H48", "K30"])
def test_unbuilt_decode_shapes_match_jax_f32(h, k):
    """f32 no-block models at shapes the selfview kernel is not built for
    (H = 48; K = 30, no multiple of 4) decode through call_split, as the
    JAX package decodes every f32 model: the same z on both sides, sigma
    within 2e-5 / 1e-5 (both f32)."""
    mlp_conf = {"type": "resnet", "n_blocks": 0, "d_hidden": h}
    conf, jnet, variables, images, ks, poses = _jax_init(mlp_conf)
    jgrid = jnet.apply(variables, images, ks, poses, ids_encoder=[0],
                       method=JBTSNet.encode)
    z = np.sort(np.random.default_rng(3).uniform(1, 40, (64 * 96, k)), -1) \
        .astype(np.float32)
    want = jnet.apply(variables, jgrid, jnp.asarray(z),
                      method=JBTSNet.query_selfview_density)
    net = _port_net(conf, variables)
    assert selfview_decode_route(True, True, True, False, True, k, h, 6) \
        == "call_split"
    with torch.no_grad():
        grid = net.encode(*(torch.as_tensor(np.asarray(a))
                            for a in (images, ks, poses)), ids_encoder=[0])
        got = net.query_selfview_density(grid, torch.as_tensor(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)


def test_unbuilt_width_bf16_decode_matches_jax_kernel():
    """A bf16 no-block model of width 48 takes the jitter route, as JAX
    takes its jitter_density kernel at any width (forced here, interpret
    mode on the CPU); on the card the wrapper launches the runtime-shape
    kernel for it. Same features and z on both sides: density within the
    jitter kernel's bf16 tolerance, atol/rtol 2e-2."""
    from behindthescenes_tpu.ops.pallas import jitter_density as jjd
    from behindthescenes_tpu_torch.ops.kernels.jitter_density import \
        kernel_for
    h, k = 48, 20
    mlp_conf = {"type": "resnet", "n_blocks": 0, "d_hidden": h}
    conf, _, variables, images, ks, poses = _jax_init(mlp_conf)
    jnet = JBTSNet.from_conf(conf, compute_dtype=jnp.bfloat16)
    jgrid = jnet.apply(variables, images, ks, poses, ids_encoder=[0],
                       method=JBTSNet.encode)
    z = np.sort(np.random.default_rng(4).uniform(1, 40, (64 * 96, k)), -1) \
        .astype(np.float32)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BTS_JITTER_PALLAS", "1")
        orig = jjd.jitter_density_pallas
        mp.setattr(jjd, "jitter_density_pallas",
                   lambda *a, **kw: calls.append(1) or orig(*a, **kw))
        want = jnet.apply(variables, jgrid, jnp.asarray(z),
                          method=JBTSNet.query_selfview_density)
    assert calls, "the JAX bf16 decode did not take its kernel"
    net = _port_net(conf, variables, torch.bfloat16)
    assert selfview_decode_route(True, True, True, True, True, k, h, 6) \
        == "jitter"
    assert kernel_for(h, 6) == "any"
    grid = _port_grid_on_jax_features(net, jgrid, images, ks, poses)
    with torch.no_grad():
        got = net.query_selfview_density(grid, torch.as_tensor(z))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


def test_encoder_reaches_a_one_pixel_map_as_jax():
    """A 32x32 image takes the ResNet-18 encoder down to a 1x1 map, which
    the decoder's reflect-padded convolutions pad as jnp.pad does (the
    edge). Features within 1e-4 abs + rel of the JAX package's (f32 both
    sides, as the flagship encoder test)."""
    rng = np.random.default_rng(5)
    images = rng.uniform(-1, 1, (1, 1, 32, 32, 3)).astype(np.float32)
    ks = np.array([[[[1.2, 0, 0], [0, 1.2, 0], [0, 0, 1]]]], np.float32)
    poses = np.eye(4, dtype=np.float32)[None, None]
    jnet = JBTSNet.from_conf(MODEL_CONF)
    jgrid = jnet.apply(j_load_npz(ARTIFACT), jnp.asarray(images),
                       jnp.asarray(ks), jnp.asarray(poses), ids_encoder=[0],
                       method=JBTSNet.encode)
    net = load_model(ARTIFACT, MODEL_CONF, device="cpu")
    with torch.no_grad():
        grid = net.encode(torch.as_tensor(images), torch.as_tensor(ks),
                          torch.as_tensor(poses), ids_encoder=[0])
    want = np.asarray(jgrid.features[0])
    assert want.shape == (1, 1, 32, 32, 16)
    np.testing.assert_allclose(grid.features[0].numpy(), want, atol=1e-4,
                               rtol=1e-4)
