"""The port's mesh extraction (behindthescenes_tpu_torch/utils/recon.py)
and segmentation metrics (utils/metrics_extra.py) against the JAX
package's on the CPU, on inputs made from a numpy seed.

Marching tetrahedra, save_obj and the metrics are numpy on both sides
and must be bit-equal. extract_mesh_from_density queries each package's
own BTSNet (JAX-initialised weights through the bridge, f32): the
volumes within 1e-5 of their largest value (the two sides sum each
convolution in another order), and the meshes' triangle counts within
1% (a grid value within that rounding of the threshold may flip a
tetrahedron).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behindthescenes_tpu.models.bts import BTSNet as JBTSNet
from behindthescenes_tpu.utils import metrics_extra as jmetrics
from behindthescenes_tpu.utils import recon as jrecon
from behindthescenes_tpu_torch.models.bts import BTSNet
from behindthescenes_tpu_torch.utils import metrics_extra as tmetrics
from behindthescenes_tpu_torch.utils import recon as trecon
from behindthescenes_tpu_torch.weights import state_dict_from_flat

# One intra-op thread: pytest-xdist runs several workers on this CPU,
# and torch's default of a thread per core makes every small op wait
# on threads that the other workers have swapped out.
torch.set_num_threads(1)


def _volumes():
    rng = np.random.default_rng(0)
    x, y, z = np.meshgrid(*(np.linspace(-1, 1, n) for n in (12, 10, 9)),
                          indexing="ij")
    sphere = (1.0 - np.sqrt(x * x + y * y + z * z)).astype(np.float32)
    return [("noise", rng.uniform(0, 1, (9, 8, 7)).astype(np.float32)),
            ("sphere", sphere),
            ("ties", rng.integers(0, 3, (6, 6, 6)).astype(np.float64) / 2),
            ("flat", np.zeros((1, 4, 4), np.float32))]


@pytest.mark.parametrize("name,volume", _volumes(),
                         ids=[n for n, _ in _volumes()])
def test_marching_tetrahedra_bit_equal(name, volume):
    kw = dict(threshold=0.5, spacing=(0.5, 0.25, 2.0), origin=(-1, 0, 3))
    want_v, want_f = jrecon.marching_tetrahedra(volume, **kw)
    got_v, got_f = trecon.marching_tetrahedra(volume, **kw)
    assert got_v.dtype == want_v.dtype and got_f.dtype == want_f.dtype
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_f, want_f)
    if name in ("noise", "sphere"):
        assert len(got_f) > 0


def test_save_obj_bytes_equal(tmp_path):
    volume = _volumes()[1][1]
    verts, faces = trecon.marching_tetrahedra(volume, 0.3)
    jrecon.save_obj(str(tmp_path / "j.obj"), verts, faces)
    trecon.save_obj(str(tmp_path / "t.obj"), verts, faces)
    assert (tmp_path / "t.obj").read_bytes() == \
        (tmp_path / "j.obj").read_bytes()


MODEL_CONF = {
    "z_near": 3.0, "z_far": 40.0, "inv_z": True, "learn_empty": False,
    "code_mode": "z",
    "code": {"num_freqs": 6, "freq_factor": 1.5, "include_input": True},
    "encoder": {"type": "monodepth2", "resnet_layers": 18,
                "num_ch_dec": (32, 32, 64, 128, 256), "d_out": 16,
                "scales": (0,)},
    "mlp_coarse": {"type": "resnet", "n_blocks": 0, "d_hidden": 16},
    "mlp_fine": {"type": "empty"},
}


def _flatten(tree, prefix):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        out.update(_flatten(v, key) if isinstance(v, dict)
                   else {key: np.asarray(v, np.float32)})
    return out


@pytest.fixture(scope="module")
def meshes():
    """Both packages' density volume and mesh of one encoded image at a
    16^3 grid; the MLP's output bias moved so that the surface crosses
    the grid."""
    rng = np.random.default_rng(1)
    images = rng.uniform(-1, 1, (1, 1, 48, 64, 3)).astype(np.float32)
    ks = np.array([[[[0.92, 0, 0], [0, 2.9, 0], [0, 0, 1]]]], np.float32)
    poses = np.eye(4, dtype=np.float32)[None, None]
    jnet = JBTSNet.from_conf(MODEL_CONF)
    variables = jnet.init(jax.random.PRNGKey(1), jnp.asarray(images),
                          jnp.asarray(ks), jnp.asarray(poses),
                          jnp.zeros((1, 4, 3)))
    variables = jax.tree_util.tree_map(lambda v: v, variables)
    variables["params"]["mlp_coarse"]["lin_out"]["bias"] = jnp.asarray(
        [0.3], jnp.float32)
    jgrid = jnet.apply(variables, jnp.asarray(images), jnp.asarray(ks),
                       jnp.asarray(poses), ids_encoder=[0],
                       method=JBTSNet.encode)
    kw = dict(resolution=16, query_batch=1000)
    want_v, want_f = jrecon.extract_mesh_from_density(jnet, variables, jgrid,
                                                      **kw)
    # JAX's volume, queried as its extract_mesh_from_density queries it.
    xs, ys, zs = (np.linspace(*r, 16) for r in ((-10, 10), (-5, 2), (3, 40)))
    pts = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1) \
        .reshape(-1, 3).astype(np.float32)
    want_vol = np.concatenate([np.asarray(jnet.apply(
        variables, jgrid, jnp.asarray(pts[i:i + 1000])[None],
        only_density=True, method=JBTSNet.query)[2][0, :, 0])
        for i in range(0, len(pts), 1000)]).reshape(16, 16, 16)
    net = BTSNet.from_conf(MODEL_CONF)
    net.load_state_dict(state_dict_from_flat(
        {**_flatten(variables["params"], "params"),
         **_flatten(variables["batch_stats"], "batch_stats")}), strict=True)
    with torch.no_grad():
        grid = net.encode(torch.as_tensor(images), torch.as_tensor(ks),
                          torch.as_tensor(poses), ids_encoder=[0])
    got_vol = trecon.density_volume(net, grid, **kw)
    got_v, got_f = trecon.extract_mesh_from_density(net, grid, **kw)
    return dict(want_vol=want_vol, want=(want_v, want_f), got_vol=got_vol,
                got=(got_v, got_f))


def test_density_volume_matches_jax(meshes):
    want, got = meshes["want_vol"], meshes["got_vol"]
    assert got.shape == (16, 16, 16) and got.dtype == np.float32
    assert (want > 0.5).any() and (want < 0.5).any()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_extract_mesh_matches_jax(meshes):
    (wv, wf), (gv, gf) = meshes["want"], meshes["got"]
    assert len(wf) > 50
    assert abs(len(gf) - len(wf)) <= 0.01 * len(wf)
    # On JAX's own volume the port's mesh is JAX's, bit for bit.
    spacing = (20 / 15, 7 / 15, 37 / 15)
    v, f = trecon.marching_tetrahedra(meshes["want_vol"], 0.5, spacing,
                                      (-10, -5, 3))
    np.testing.assert_array_equal(v, wv)
    np.testing.assert_array_equal(f, wf)
    v, f = trecon.extract_mesh_from_density(
        None, None, resolution=16, volume=meshes["want_vol"])
    np.testing.assert_array_equal(f, wf)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_extra_equal(seed):
    rng = np.random.default_rng(seed)
    true = rng.integers(0, 4, (3, 24, 32))
    pred = np.where(rng.uniform(size=true.shape) < 0.8, true,
                    rng.integers(0, 5, true.shape))
    assert tmetrics.adjusted_rand_index(true, pred) == \
        jmetrics.adjusted_rand_index(true, pred)
    assert tmetrics.fg_ari(true, pred) == jmetrics.fg_ari(true, pred)
    # one-hot stacks are argmaxed first; empty and all-background inputs
    onehot_t = np.eye(4)[true[0]].transpose(2, 0, 1).astype(np.float32)
    onehot_p = np.eye(5)[pred[0]].transpose(2, 0, 1).astype(np.float32)
    assert tmetrics.fg_ari(onehot_t, onehot_p) == \
        jmetrics.fg_ari(onehot_t, onehot_p)
    assert np.isnan(tmetrics.adjusted_rand_index([], []))
    assert np.isnan(tmetrics.fg_ari(np.zeros((4, 4), int),
                                    np.ones((4, 4), int)))
    assert tmetrics.adjusted_rand_index(true[0], true[0]) == 1.0
