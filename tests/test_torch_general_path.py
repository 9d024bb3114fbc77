"""The port's general cross-view path against the JAX package on the same
inputs, made with numpy from a seed: geometry, grid sampling (f32 and the
bf16 packed semantics), SSIM, the reconstruction loss, the patch sampler,
the field query at two widths in f32 and bf16, and the general depth path
of the evaluator on the flagship checkpoint.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behindthescenes_tpu import geometry as jgeo
from behindthescenes_tpu import losses as jlosses
from behindthescenes_tpu import ray_sampler as jrs
from behindthescenes_tpu import renderer as jrenderer
from behindthescenes_tpu.evaluation.depth import DepthEvaluator as JEval
from behindthescenes_tpu.models.bts import BTSNet as JBTSNet
from behindthescenes_tpu.ops import grid_sample as jgs
from behindthescenes_tpu.ops.ssim import ssim as jssim
from behindthescenes_tpu.utils.io import load_params_npz as j_load_npz
from behindthescenes_tpu_torch import geometry as tgeo
from behindthescenes_tpu_torch import losses as tlosses
from behindthescenes_tpu_torch import ray_sampler as trs
from behindthescenes_tpu_torch.datasets.synthetic import make_test_dataset
from behindthescenes_tpu_torch.eval_depth import (FLAGSHIP_MODEL_CONF,
                                                  load_model)
from behindthescenes_tpu_torch.evaluation.depth import DepthEvaluator
from behindthescenes_tpu_torch.models.bts import BTSNet
from behindthescenes_tpu_torch.ops import grid_sample as tgs
from behindthescenes_tpu_torch.ops.ssim import ssim as tssim
from behindthescenes_tpu_torch.renderer import RendererConfig
from behindthescenes_tpu_torch.weights import state_dict_from_flat

# One intra-op thread: pytest-xdist runs several workers on this CPU,
# and torch's default of a thread per core makes every small op wait
# on threads that the other workers have swapped out.
torch.set_num_threads(1)

FLAGSHIP = os.path.join(os.path.dirname(__file__), "..", "media", "weights",
                        "flagship_fast_conv.npz")


def _t(a):
    return torch.as_tensor(np.array(a))


def _poses(rng, v):
    """v camera-to-world poses: small rotations, translations of a few m."""
    out = []
    for _ in range(v):
        ax = rng.normal(size=3) * 0.1
        th = np.linalg.norm(ax)
        k = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]],
                      [-ax[1], ax[0], 0]]) / max(th, 1e-9)
        rot = np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k
        pose = np.eye(4)
        pose[:3, :3], pose[:3, 3] = rot, rng.normal(size=3)
        out.append(pose)
    return np.stack(out).astype(np.float32)


def _ks(rng, v):
    ks = np.tile(np.eye(3, dtype=np.float32), (v, 1, 1))
    ks[:, 0, 0] = rng.uniform(0.5, 1.0, v)
    ks[:, 1, 1] = rng.uniform(1.4, 2.0, v)
    ks[:, :2, 2] = rng.uniform(-0.05, 0.05, (v, 2))
    return ks


# ---------------------------------------------------------------- geometry
def test_gen_rays_matches_jax():
    rng = np.random.default_rng(0)
    poses, ks = _poses(rng, 3), _ks(rng, 3)
    focal = np.stack([ks[:, 0, 0], ks[:, 1, 1]], -1)
    c = ks[:, :2, 2]
    for norm_dir in (True, False):
        want = jgeo.gen_rays(jnp.asarray(poses), 20, 12, 1.0, 40.0,
                             focal=jnp.asarray(focal), c=jnp.asarray(c),
                             norm_dir=norm_dir)
        got = tgeo.gen_rays(_t(poses), 20, 12, 1.0, 40.0, focal=_t(focal),
                            c=_t(c), norm_dir=norm_dir)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_project_points_matches_jax():
    rng = np.random.default_rng(1)
    xyz = rng.uniform(-6, 6, (2, 300, 3)).astype(np.float32)
    xyz[..., 2] += 4.0
    w2c = np.stack([np.linalg.inv(_poses(rng, 3)) for _ in range(2)]) \
        .astype(np.float32)
    ks = np.stack([_ks(rng, 3) for _ in range(2)])
    want = jgeo.project_points(jnp.asarray(xyz), jnp.asarray(w2c),
                               jnp.asarray(ks), eps=1e-3)
    got = tgeo.project_points(_t(xyz), _t(w2c), _t(ks), eps=1e-3)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert 0 < got[3].float().mean() < 1


# ------------------------------------------------------------ grid sampling
def _map_and_coords(seed, c=5, p=400):
    rng = np.random.default_rng(seed)
    image = rng.normal(size=(2, 3, 9, 13, c)).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (2, 3, p, 2)).astype(np.float32)
    return image, coords


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample_2d_matches_jax(mode, padding_mode):
    """Values and the gradient with respect to the map, 1e-6."""
    image, coords = _map_and_coords(2)
    cot = np.random.default_rng(3).normal(size=(2, 3, 400, 5)) \
        .astype(np.float32)
    kw = dict(align_corners=False, padding_mode=padding_mode, mode=mode)

    def jfun(im):
        return jnp.sum(jgs.grid_sample_2d(im, jnp.asarray(coords), **kw)
                       * cot)
    want = jgs.grid_sample_2d(jnp.asarray(image), jnp.asarray(coords), **kw)
    want_grad = jax.grad(jfun)(jnp.asarray(image))
    im = _t(image).requires_grad_(True)
    got = tgs.grid_sample_2d(im, _t(coords), **kw)
    (got * _t(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6)
    np.testing.assert_allclose(im.grad.numpy(), np.asarray(want_grad),
                               atol=1e-6)


@pytest.mark.parametrize("path,c,dtype", [
    ("xpair", 48, jnp.bfloat16), ("packed", 16, jnp.bfloat16),
    ("packed", 3, jnp.float16), ("packed", 3, jnp.float32)])
def test_packed_sampling_semantics_match_jax(path, c, dtype):
    """The port gathers the corners from the unpacked map; the values are
    those of pack_corners_x + grid_sample_2d_xpair (bf16 lerp) and
    pack_corners + grid_sample_2d_packed (f32 weights) on the same maps:
    at most one ulp of the result's dtype apart (measured: equal)."""
    image, coords = _map_and_coords(4, c=c)
    jim = jnp.asarray(image).astype(dtype)
    if path == "xpair":
        want = jgs.grid_sample_2d_xpair(jgs.pack_corners_x(jim),
                                        jnp.asarray(coords))
        got = tgs.grid_sample_2d_xpair(_t(jim.astype(jnp.float32)).to(
            torch.bfloat16), _t(coords))
    else:
        want = jgs.grid_sample_2d_packed(jgs.pack_corners(jim),
                                         jnp.asarray(coords))
        tdt = {jnp.bfloat16: torch.bfloat16, jnp.float16: torch.float16,
               jnp.float32: torch.float32}[dtype]
        got = tgs.grid_sample_2d_packed(_t(jim.astype(jnp.float32)).to(tdt),
                                        _t(coords))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    ulp = 2.0 ** -7 if want.dtype == np.float32 and path == "xpair" \
        else 2.0 ** -23
    np.testing.assert_allclose(got, want, rtol=ulp, atol=1e-30)


# --------------------------------------------------------------- SSIM, loss
@pytest.mark.parametrize("kw,atol", [
    (dict(pad_reflection=False, gaussian_average=True, comp_mode=True), 1e-6),
    (dict(), 1e-5), (dict(eval_mode=True), 1e-5)],
    ids=["loss", "default", "eval"])
def test_ssim_matches_jax(kw, atol):
    """The loss's options (zero pad, gaussian window, comp_mode): 1e-6 of
    JAX's f32 evaluation. The box window with reflect padding is worse
    conditioned: JAX's f32 evaluation is up to 3.5e-6 from its float64
    one there, and an f32 evaluation that sums in another order up to
    5.6e-6 from JAX's (measured), so those options are held to 1e-5 of
    JAX's f32. The port computes the window statistics in float64: for
    every option it is within 1e-6 of JAX's float64 evaluation and the
    nearer of the two to it."""
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 1, (6, 4, 4, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (6, 4, 4, 3)).astype(np.float32)
    got = tssim(_t(a), _t(b), **kw).numpy()
    want = np.asarray(jssim(jnp.asarray(a), jnp.asarray(b), **kw))
    with jax.enable_x64(True):
        exact = np.asarray(jssim(jnp.asarray(a, jnp.float64),
                                 jnp.asarray(b, jnp.float64), **kw))
    assert exact.dtype == np.float64
    np.testing.assert_allclose(got, want, atol=atol)
    np.testing.assert_allclose(got, exact, atol=1e-6)
    assert np.abs(got - exact).max() <= np.abs(want - exact).max()


def test_l1ssim_matches_jax():
    rng = np.random.default_rng(5)
    img0 = rng.uniform(0, 1, (2, 3, 4, 4, 2, 3)).astype(np.float32)
    img1 = rng.uniform(0, 1, (2, 3, 4, 4, 1, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tlosses.compute_errors_l1ssim(_t(img0), _t(img1)).numpy(),
        np.asarray(jlosses.compute_errors_l1ssim(jnp.asarray(img0),
                                                 jnp.asarray(img1))),
        atol=1e-6)


def test_edge_aware_smoothness_matches_jax():
    rng = np.random.default_rng(6)
    img = rng.uniform(0, 1, (2, 3, 8, 8, 1, 3)).astype(np.float32)
    depth = rng.uniform(1, 40, (2, 3, 4, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tlosses.edge_aware_smoothness(_t(img), _t(depth)).numpy(),
        np.asarray(jlosses.edge_aware_smoothness(jnp.asarray(img),
                                                 jnp.asarray(depth))),
        atol=1e-6)


def _render_data(seed, n=2, pc=3, p=4, nv=2, k=6):
    """A reconstructed patch render dict with views that tie (both out of
    frame: the same colour) and rays that are invalid in one or both."""
    rng = np.random.default_rng(seed)
    shp = (n, pc, p, p)
    rgb = rng.uniform(0, 1, shp + (nv, 3)).astype(np.float32)
    rgb[:, 0, :2, :2, 1] = rgb[:, 0, :2, :2, 0]
    w = rng.uniform(0, 1, shp + (k,)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    branch = {"rgb": rgb, "depth": rng.uniform(1, 40, shp)
              .astype(np.float32), "weights": w,
              "alphas": rng.uniform(0, 1, shp + (k,)).astype(np.float32),
              "invalid": (rng.uniform(size=shp + (k, nv)) < 0.4)
              .astype(np.float32),
              "rgb_samps": rng.uniform(0, 1, shp + (k, nv, 3))
              .astype(np.float32)}
    return {"coarse": [branch], "fine": [dict(branch)],
            "rgb_gt": rng.uniform(0, 1, shp + (3,)).astype(np.float32)}


@pytest.mark.parametrize("policy", ["strict", "weight_guided", "none",
                                    "weight_guided_diverse"])
def test_reconstruction_loss_matches_jax(policy):
    """Every term of the loss dict, 1e-6, with all regularizers on, and the
    gradient with respect to the rendered colours (shared among tied
    views, as jnp.min shares it)."""
    conf = {"criterion": "l1+ssim", "invalid_policy": policy,
            "lambda_edge_aware_smoothness": 1e-3, "lambda_entropy": 0.1,
            "lambda_depth_reg": 0.1, "lambda_alpha_reg": 0.1,
            "lambda_surfaceness_reg": 0.1, "lambda_depth_smoothness": 0.1}
    data = _render_data(7)
    jdata = jax.tree_util.tree_map(jnp.asarray, data)
    jfn = jlosses.ReconstructionLoss.from_conf(conf)
    want, want_d = jfn(jdata)

    def jloss(rgb):
        d = dict(jdata, coarse=[dict(jdata["coarse"][0], rgb=rgb)],
                 fine=[dict(jdata["fine"][0], rgb=rgb)])
        return jfn(d)[0]
    want_g = jax.grad(jloss)(jdata["coarse"][0]["rgb"])
    tdata = {"coarse": [{k: _t(v) for k, v in data["coarse"][0].items()}],
             "rgb_gt": _t(data["rgb_gt"])}
    rgb = tdata["coarse"][0]["rgb"].requires_grad_(True)
    tdata["fine"] = [dict(tdata["coarse"][0])]
    got, got_d = tlosses.ReconstructionLoss.from_conf(conf)(tdata)
    got.backward()
    assert set(got_d) == set(want_d)
    for key in want_d:
        np.testing.assert_allclose(float(got_d[key]), float(want_d[key]),
                                   rtol=1e-6, atol=1e-7, err_msg=key)
    np.testing.assert_allclose(rgb.grad.numpy(), np.asarray(want_g),
                               atol=1e-6)


# ------------------------------------------------------------- ray sampler
def test_patch_sampler_replays_jax_draws():
    """Rays, ground-truth colours and `reconstruct` of the patch sampler
    with the draws the JAX sampler makes from its key (split per batch
    item, then into views, rows and columns): colours and layout exact,
    rays as gen_rays (1e-6)."""
    rng = np.random.default_rng(8)
    n, v, h, w = 2, 3, 12, 16
    images = rng.uniform(0, 1, (n, v, h, w, 3)).astype(np.float32)
    poses = np.stack([_poses(rng, v) for _ in range(n)])
    projs = np.stack([_ks(rng, v) for _ in range(n)])
    key = jax.random.PRNGKey(3)
    js = jrs.PatchRaySampler(64, 1.0, 40.0, patch_size=4)
    want_rays, want_rgb = js.sample(key, jnp.asarray(images),
                                    jnp.asarray(poses), jnp.asarray(projs))
    draws = []
    for kk in jax.random.split(key, n):
        kv, ky, kx = jax.random.split(kk, 3)
        draws.append([np.asarray(jax.random.randint(kv, (4,), 0, v)),
                      np.asarray(jax.random.randint(ky, (4,), 0, h - 4)),
                      np.asarray(jax.random.randint(kx, (4,), 0, w - 4))])
    draws = trs.PatchDraws(*(torch.as_tensor(np.stack(d)).long()
                             for d in zip(*draws)))
    ts = trs.PatchRaySampler(64, 1.0, 40.0, patch_size=4)
    rays, rgb = ts.sample(_t(images), _t(poses), _t(projs), draws=draws)
    np.testing.assert_array_equal(rgb.numpy(), np.asarray(want_rgb))
    np.testing.assert_allclose(rays.numpy(), np.asarray(want_rays),
                               atol=1e-6)
    rd = _render_data(9, n=n, pc=1, p=8, nv=2, k=5)["coarse"][0]
    flat = {"rgb": rd["rgb"].reshape(n, 64, 6),
            "depth": rd["depth"].reshape(n, 64),
            "weights": rd["weights"].reshape(n, 64, 5),
            "invalid": rd["invalid"].reshape(n, 64, 5, 2)}
    want = js.reconstruct({"coarse": jax.tree_util.tree_map(jnp.asarray,
                                                            flat),
                           "fine": jax.tree_util.tree_map(jnp.asarray, flat),
                           "rgb_gt": want_rgb})
    got = ts.reconstruct({"coarse": {k: _t(x) for k, x in flat.items()},
                          "fine": {k: _t(x) for k, x in flat.items()},
                          "rgb_gt": rgb})
    for branch in ("coarse", "fine"):
        for key_ in flat:
            np.testing.assert_array_equal(got[branch][key_].numpy(),
                                          np.asarray(want[branch][key_]))
    np.testing.assert_array_equal(got["rgb_gt"].numpy(),
                                  np.asarray(want["rgb_gt"]))


# ------------------------------------------------------------------- query
def _query_conf(d_out):
    return {"z_near": 1.0, "z_far": 40.0, "inv_z": True,
            "learn_empty": True, "code_mode": "z",
            "code": {"num_freqs": 6, "freq_factor": 1.5,
                     "include_input": True},
            "encoder": {"type": "dummy", "size": (16, 24), "d_out": d_out},
            "mlp_coarse": {"type": "resnet", "n_blocks": 0, "d_hidden": 32},
            "mlp_fine": {"type": "empty"}}


def _flat_variables(variables):
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]:
        out["/".join(str(getattr(p, "key", p)) for p in kp)] = \
            np.asarray(leaf, np.float32)
    return out


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("d_out", [16, 48], ids=["4corner", "xpair"])
def test_query_matches_jax(d_out, bf16):
    """BTSNet.query at world points seen by two render views, on the JAX
    run's own feature map (a learned map of the given width, the same
    initial parameters carried across): rgb, invalid and sigma. f32: 1e-5
    (measured 4e-7 on sigma). bf16 (x-pair lerp in bf16 at d_out 48; f32
    weights at 16; f16 colours; the MLP in bf16): measured equal, held to
    1e-2."""
    rng = np.random.default_rng(10)
    n, v, h, w = 1, 3, 32, 48
    images = rng.uniform(-1, 1, (n, v, h, w, 3)).astype(np.float32)
    poses = _poses(rng, v)[None] * np.array([1, 1, 1, 0.3], np.float32)
    poses[..., 3, 3] = 1.0
    projs = _ks(rng, v)[None]
    conf = _query_conf(d_out)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else \
        (jnp.float32, torch.float32)
    jnet = JBTSNet.from_conf(conf, compute_dtype=jdt)
    xyz = np.concatenate([rng.uniform(-3, 3, (n, 500, 2)),
                          rng.uniform(1, 30, (n, 500, 1))], -1) \
        .astype(np.float32)
    variables = jnet.init(jax.random.PRNGKey(0), jnp.asarray(images),
                          jnp.asarray(projs), jnp.asarray(poses),
                          jnp.asarray(xyz))
    jgrid = jnet.apply(variables, jnp.asarray(images), jnp.asarray(projs),
                       jnp.asarray(poses), ids_encoder=[0],
                       ids_render=[1, 2], method=JBTSNet.encode)
    want = jnet.apply(variables, jgrid, jnp.asarray(xyz),
                      method=JBTSNet.query)
    net = BTSNet.from_conf(conf, compute_dtype=tdt)
    net.load_state_dict(state_dict_from_flat(_flat_variables(variables)))
    with torch.no_grad():
        grid = net.encode(_t(images), _t(projs), _t(poses), ids_encoder=[0],
                          ids_render=[1, 2])
        feats = _t(jgrid.features[0].astype(jnp.float32)).to(tdt)
        grid.features = (feats,)
        got = net.query(grid, _t(xyz))
    tol = 1e-2 if bf16 else 1e-5
    for name, a, b in zip(("rgb", "invalid", "sigma"), got, want):
        b = np.asarray(b.astype(jnp.float32))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.float().numpy(), b, atol=tol,
                                   rtol=tol, err_msg=name)
    assert 0 < float(got[1].mean()) < 1


# ---------------------------------------------------- general depth path
EVAL_HW = (48, 64)
EVAL_CFG = dict(n_coarse=64, lindisp=True, hard_alpha_cap=True)


@pytest.fixture(scope="module")
def flagship_port():
    return load_model(FLAGSHIP, device="cpu")


@pytest.fixture(scope="module")
def eval_batches():
    ds = make_test_dataset(image_size=EVAL_HW)
    return [{k: v[None] for k, v in ds[i].items()} for i in range(4)]


def test_general_depth_matches_jax(flagship_port, eval_batches):
    """The flagship checkpoint at 48x64 through both evaluators' general
    path (eval_selfview: false) on one scene, the port fed the JAX run's
    coarse jitter (its key split five ways, the first drawn uniform):
    every view's z-depth within 1e-4 (f32)."""
    batch = eval_batches[0]
    conf = dict(FLAGSHIP_MODEL_CONF, eval_selfview=False)
    jnet = JBTSNet.from_conf(FLAGSHIP_MODEL_CONF)
    jev = JEval(jnet, jrenderer.RendererConfig(**EVAL_CFG), conf)
    assert not jev.use_selfview
    _, v, h, w, _ = batch["imgs"].shape
    key = jax.random.PRNGKey(0)
    want = jev._build_render(h, w, v)(
        j_load_npz(FLAGSHIP), jnp.asarray(batch["imgs"]),
        jnp.asarray(batch["projs"]), jnp.asarray(batch["poses"]), key)
    want = np.asarray(want["fine"]["depth"])                # (1, v, h, w)
    jitter = jax.random.uniform(jax.random.split(key, 5)[0],
                                (1, v * h * w, EVAL_CFG["n_coarse"]))
    ev = DepthEvaluator(flagship_port, RendererConfig(**EVAL_CFG), conf)
    got = ev.render_general(_t(batch["imgs"]), _t(batch["projs"]),
                            _t(batch["poses"]), z_jitter=_t(jitter))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)
    key_depth = ev.render(_t(batch["imgs"]), _t(batch["projs"]),
                          _t(batch["poses"]), z_jitter=_t(jitter))
    np.testing.assert_array_equal(key_depth.numpy(), got[:, 0].numpy())


def test_general_path_meets_selfview_bounds(flagship_port, eval_batches):
    """The evaluator's self-view default and its general path give the
    same metrics on 4 scenes within the JAX package's bounds
    (tests/test_accuracy_gate.py:153-155): abs_rel 0.02, a1 0.05, rmse
    0.05, each times max(1, value)."""
    rcfg = RendererConfig(**EVAL_CFG)
    ev_sv = DepthEvaluator(flagship_port, rcfg, FLAGSHIP_MODEL_CONF)
    ev_gen = DepthEvaluator(flagship_port, rcfg,
                            dict(FLAGSHIP_MODEL_CONF, eval_selfview=False))
    assert ev_sv.use_selfview and not ev_gen.use_selfview
    gen = torch.Generator()
    gen.manual_seed(0)
    for batch in eval_batches:
        m_sv = ev_sv.evaluate(batch)
        m_gen = ev_gen.evaluate(batch, generator=gen)
        for k, tol in (("abs_rel", 0.02), ("a1", 0.05), ("rmse", 0.05)):
            assert abs(m_sv[k] - m_gen[k]) < tol * max(1.0, m_gen[k]), \
                (k, m_sv[k], m_gen[k])
