"""The training remainder of the port against the JAX package on the same
numpy inputs made from a seed: the patch and perceptual image processors,
the automask loss, the three model keys (empty_empty, return_sample_depth,
nearest colours), nearest's rounding at exact .5 coordinates, the plasma
table, and one f32 train step each with the fine pass (reusing the coarse
samples, re-querying them, with around-depth samples, and through the
chunked remat render), with automasking and with the patch processor:
the loss terms and every gradient against JAX's step from the same
parameters, views and draws (the JAX step's key splits replayed).
"""
import dataclasses

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

from behindthescenes_tpu import losses as jlosses
from behindthescenes_tpu.models import image_processor as jip
from behindthescenes_tpu.models.bts import BTSNet as JBTSNet
from behindthescenes_tpu.ops import grid_sample as jgs
from behindthescenes_tpu.parallel.mesh import make_mesh
from behindthescenes_tpu.training.trainer import BTSTrainer as JTrainer
from behindthescenes_tpu_torch import losses as tlosses
from behindthescenes_tpu_torch.models import image_processor as tip
from behindthescenes_tpu_torch.models.bts import BTSNet
from behindthescenes_tpu_torch.ops import grid_sample as tgs
from behindthescenes_tpu_torch.renderer import FineDraws
from behindthescenes_tpu_torch.training.wrapper import Draws
from behindthescenes_tpu_torch.utils.plotting import PLASMA, color_tensor
from behindthescenes_tpu_torch.weights import state_dict_from_flat
from test_torch_general_path import (_flat_variables, _ks, _poses,
                                     _query_conf, _render_data)
from test_torch_train import (_batch, _config, _flat, _grads, _jax_init,
                              port_step, replay_draws)

# One intra-op thread: pytest-xdist runs several workers on this CPU,
# and torch's default of a thread per core makes every small op wait
# on threads that the other workers have swapped out.
torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.array(a))


# -------------------------------------------------------- image processors
@pytest.mark.parametrize("p", [3, 5])
def test_patch_processor_matches_jax(p):
    """3 p^2 channels of edge-padded shifted copies: equal to JAX's."""
    images = np.random.default_rng(p).uniform(
        -1, 1, (2, 3, 9, 13, 3)).astype(np.float32)
    want = jip.PatchProcessor(p)(jnp.asarray(images))
    got = tip.PatchProcessor(p)(_t(images))
    assert tip.PatchProcessor(p).channels == 3 * p * p == want.shape[-1]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _lpips_npz(path, seed=0):
    """Random LPIPS-VGG weights in the JAX package's npz layout
    (scripts/convert_lpips_weights.py): conv{i}_w HWIO, conv{i}_b,
    lin{i}_w, shift and scale. The real weights are not in the repo."""
    rng = np.random.default_rng(seed)
    arrays, c_in, ci = {}, 3, 0
    for c_out, n_convs in zip((64, 128, 256, 512, 512), (2, 2, 3, 3, 3)):
        for _ in range(n_convs):
            arrays[f"conv{ci}_w"] = (rng.normal(size=(3, 3, c_in, c_out))
                                     * np.sqrt(2 / (9 * c_in))) \
                .astype(np.float32)
            arrays[f"conv{ci}_b"] = rng.normal(size=c_out).astype(
                np.float32) * 0.1
            c_in, ci = c_out, ci + 1
    for i, c in enumerate((64, 128, 256, 512, 512)):
        arrays[f"lin{i}_w"] = rng.uniform(0, 1, c).astype(np.float32)
    arrays["shift"] = np.array([-0.030, -0.088, -0.188], np.float32)
    arrays["scale"] = np.array([0.458, 0.448, 0.450], np.float32)
    np.savez(path, **arrays)
    return str(path)


@pytest.mark.parametrize("layers", [1, 2, 3])
def test_perceptual_processor_matches_jax(layers, tmp_path):
    """The first `layers` stages' unit-normalised activations, nearest-
    resized to the image, on random weights in the JAX npz layout: within
    2e-5 of JAX's (both convolve in f32; measured under 1e-6)."""
    path = _lpips_npz(tmp_path / "lpips.npz")
    images = np.random.default_rng(layers).uniform(
        -1, 1, (1, 2, 20, 28, 3)).astype(np.float32)
    jproc = jip.PerceptualProcessor(layers, path)
    tproc = tip.PerceptualProcessor(layers, path)
    assert tproc.channels == jproc.channels == sum(
        (64, 128, 256)[:layers])
    want = np.asarray(jproc(jnp.asarray(images)))
    got = tproc(_t(images)).numpy()
    assert got.shape == want.shape == (1, 2, 20, 28, tproc.channels)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_perceptual_processor_without_weights_raises(monkeypatch):
    """Without weights both packages raise the same error."""
    monkeypatch.delenv("BTS_LPIPS_WEIGHTS", raising=False)
    with pytest.raises(NotImplementedError) as want:
        jip.make_image_processor({"type": "perceptual"})
    with pytest.raises(NotImplementedError) as got:
        tip.make_image_processor({"type": "perceptual"})
    assert str(got.value) == str(want.value)


# ----------------------------------------------------------- automasking
def test_automask_loss_matches_jax():
    """The loss with automasking on a 4-channel render dict (colour + the
    baseline error as the last channel): every term within 1e-6 of JAX's,
    and the gradient with respect to the rendered channels; the baseline
    caps the error where it is lower (some rays here)."""
    conf = {"criterion": "l1+ssim", "invalid_policy": "weight_guided",
            "lambda_edge_aware_smoothness": 1e-3}
    data = _render_data(11)
    rng = np.random.default_rng(12)
    for branch in ("coarse", "fine"):
        b = data[branch][0]
        b["rgb"] = np.concatenate(
            [b["rgb"], rng.uniform(0, 1, b["rgb"].shape[:-1] + (1,))
             .astype(np.float32)], -1)
    data["rgb_gt"] = np.concatenate(
        [data["rgb_gt"], rng.uniform(0.0, 0.3, data["rgb_gt"].shape[:-1]
                                     + (1,)).astype(np.float32)], -1)
    jloss = jlosses.ReconstructionLoss.from_conf(conf, use_automasking=True)
    tloss = tlosses.ReconstructionLoss.from_conf(conf, use_automasking=True)

    def jfn(rgb_c, rgb_f):
        d = jax.tree_util.tree_map(jnp.asarray, data)
        d["coarse"][0]["rgb"], d["fine"][0]["rgb"] = rgb_c, rgb_f
        return jloss(d)
    (jl, jterms), jgrad = jax.value_and_grad(jfn, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(data["coarse"][0]["rgb"]),
        jnp.asarray(data["fine"][0]["rgb"]))
    tdata = {"coarse": [{k: _t(v) for k, v in data["coarse"][0].items()}],
             "fine": [{k: _t(v) for k, v in data["fine"][0].items()}],
             "rgb_gt": _t(data["rgb_gt"])}
    for branch in ("coarse", "fine"):
        tdata[branch][0]["rgb"].requires_grad_(True)
    tl, tterms = tloss(tdata)
    tl.backward()
    for k, v in jterms.items():
        np.testing.assert_allclose(float(tterms[k]), float(v), atol=1e-6,
                                   err_msg=k)
    for branch, g in zip(("coarse", "fine"), jgrad):
        np.testing.assert_allclose(tdata[branch][0]["rgb"].grad.numpy(),
                                   np.asarray(g), atol=1e-7)
    plain = jlosses.ReconstructionLoss.from_conf(conf)
    d3 = jax.tree_util.tree_map(jnp.asarray, data)
    for branch in ("coarse", "fine"):
        d3[branch][0]["rgb"] = d3[branch][0]["rgb"][..., :-1]
    d3["rgb_gt"] = d3["rgb_gt"][..., :-1]
    assert float(plain(d3)[0]) > float(jl)


# ------------------------------------------------------------ model keys
def _keys_query(conf, tdt, jdt):
    """BTSNet.query of both packages on one scene (three views, a learned
    map, the JAX run's feature map on both sides)."""
    rng = np.random.default_rng(20)
    n, v, h, w = 1, 3, 32, 48
    images = rng.uniform(-1, 1, (n, v, h, w, 3)).astype(np.float32)
    poses = _poses(rng, v)[None] * np.array([1, 1, 1, 0.3], np.float32)
    poses[..., 3, 3] = 1.0
    projs = _ks(rng, v)[None]
    xyz = np.concatenate([rng.uniform(-3, 3, (n, 500, 2)),
                          rng.uniform(1, 30, (n, 500, 1))], -1) \
        .astype(np.float32)
    jnet = JBTSNet.from_conf(conf, compute_dtype=jdt)
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
        grid.features = (_t(jgrid.features[0].astype(jnp.float32))
                         .to(tdt),)
        got = net.query(grid, _t(xyz))
    return got, [np.asarray(x.astype(jnp.float32)) for x in want]


@pytest.mark.parametrize("case", [
    ("empty_empty", {"empty_empty": True}, "f32"),
    ("return_sample_depth", {"return_sample_depth": True}, "f32"),
    ("nearest", {"color_interpolation": "nearest"}, "f32"),
    ("nearest", {"color_interpolation": "nearest"}, "bf16")],
    ids=["empty_empty", "return_sample_depth", "nearest", "nearest_bf16"])
def test_model_keys_query_matches_jax(case):
    """rgb, invalid and sigma of BTSNet.query with each model key, against
    JAX's: f32 within 1e-5 (as tests/test_torch_general_path.py's query),
    bf16 within 1e-2. empty_empty zeroes sigma exactly where the feature
    is invalid; return_sample_depth appends the distance to each view's
    colours (4 channels a view); nearest samples colours without the
    bilinear lerp, from f32 maps in bf16 as JAX does (no f16 copy)."""
    name, keys, prec = case
    tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if prec == "bf16"
                else (torch.float32, jnp.float32))
    conf = dict(_query_conf(16), **keys)
    got, want = _keys_query(conf, tdt, jdt)
    tol = 1e-2 if prec == "bf16" else 1e-5
    for label, a, b in zip(("rgb", "invalid", "sigma"), got, want):
        assert tuple(a.shape) == b.shape, label
        np.testing.assert_allclose(a.float().numpy(), b, atol=tol,
                                   rtol=tol, err_msg=label)
    rgb, invalid, sigma = (a.float().numpy() for a in got)
    if name == "empty_empty":
        inv_feat = invalid.max(-1) > 0
        assert 0 < inv_feat.mean() < 1
        base, _ = _keys_query(_query_conf(16), tdt, jdt)
        only_feat = base[2][..., 0].numpy() != sigma[..., 0]
        assert (sigma[..., 0][only_feat] == 0).all() and only_feat.any()
    if name == "return_sample_depth":
        assert rgb.shape[-1] == 2 * 4
        assert (rgb.reshape(1, 500, 2, 4)[..., 3] > 0).all()
    if name == "nearest":
        # every colour channel is a pixel value of the render views
        assert rgb.shape[-1] == 2 * 3


def test_nearest_rounds_half_to_even_as_jax():
    """Coordinates that land exactly on .5 after unnormalising (x = k +
    0.5 for W = 8, y likewise for H = 6): both packages round half to
    even (jnp.round and torch.round), so the same pixel is read; and the
    rest of a grid as well."""
    rng = np.random.default_rng(30)
    image = rng.normal(size=(1, 6, 8, 4)).astype(np.float32)
    xs = np.arange(-1, 8) / 4 - 0.75                  # x = -0.5 .. 7.5
    ys = np.arange(-1, 6) / 3 - 2 / 3                 # y = -0.5 .. 5.5
    gx, gy = np.meshgrid(xs, ys)
    coords = np.stack([gx.ravel(), gy.ravel()], -1)[None].astype(np.float32)
    coords = np.concatenate([coords, rng.uniform(
        -1.2, 1.2, (1, 100, 2)).astype(np.float32)], 1)
    for pad in ("border", "zeros"):
        want = jgs.grid_sample_2d(jnp.asarray(image), jnp.asarray(coords),
                                  mode="nearest", padding_mode=pad)
        got = tgs.grid_sample_2d(_t(image), _t(coords), mode="nearest",
                                 padding_mode=pad)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x_un = ((coords[0, :63, 0] + 1) * 8 - 1) / 2
    assert np.allclose(x_un - np.floor(x_un), 0.5)
    picked = tgs.grid_sample_2d(_t(image), _t(coords[:, :63]),
                                mode="nearest")[0].numpy()
    assert (np.round(x_un) % 2 == 0).all()
    ix = np.clip(np.round(x_un).astype(int), 0, 7)
    iy = np.clip(np.round(((coords[0, :63, 1] + 1) * 6 - 1) / 2)
                 .astype(int), 0, 5)
    np.testing.assert_array_equal(picked, image[0, iy, ix])


# ------------------------------------------------ ties in the fine pass
def test_fine_gradients_with_ties_match_jnp_sort():
    """The fine pass's gradients with respect to the coarse and the new
    depths where samples tie (new copies of coarse depths, two equal new
    depths, one at the ray's near bound) equal those of JAX's re-query
    path, jnp.sort of the concatenation then the composite: both of the
    port's paths, the merged composite of `fine_reuse_coarse` (a stable
    sort) and the re-query, within 1e-5 (measured 1.3e-6). At a tie the
    gap is 0, and |gap| carries jnp.abs's gradient there (1, where
    torch's abs has 0). JAX's own merged composite (a masked minimum over
    successors) shares a tied successor's gradient among the ties and so
    departs from its jnp.sort path; the port keeps to jnp.sort's."""
    from behindthescenes_tpu import renderer as jr
    from behindthescenes_tpu_torch import renderer as tr
    from test_torch_fine import _rays, _smooth_query
    rays = _rays(10)
    rng = np.random.default_rng(11)
    z_c = np.sort(rng.uniform(3, 8, (1, 64, 12)), -1).astype(np.float32)
    z_n = rng.uniform(3, 8, (1, 64, 9)).astype(np.float32)
    z_n[..., :3] = z_c[..., 2:5]
    z_n[..., 3] = 3.0
    z_n[..., 4] = z_n[..., 5]
    cot_rgb = rng.normal(size=(1, 64, 6)).astype(np.float32)
    cot_d = rng.normal(size=(1, 64)).astype(np.float32)
    cfg = dict(n_coarse=12, n_fine=9, hard_alpha_cap=True)

    def jf(zc, zn):
        zs = jnp.sort(jnp.concatenate([zc, zn], -1), -1)
        o = jr.composite(_smooth_query(jnp), jnp.asarray(rays), zs,
                         jr.RendererConfig(**cfg))
        return jnp.sum(o["rgb"] * cot_rgb) + jnp.sum(o["depth"] * cot_d)
    want = jax.grad(jf, argnums=(0, 1))(jnp.asarray(z_c), jnp.asarray(z_n))
    for reuse in (True, False):
        zc, zn = _t(z_c).requires_grad_(True), _t(z_n).requires_grad_(True)
        qf, rcfg = _smooth_query(torch), tr.RendererConfig(
            **cfg, fine_reuse_coarse=reuse)
        if reuse:
            cached = tr.composite(qf, _t(rays), zc, rcfg)
            out = tr.composite_merged(qf, _t(rays), zc, cached, zn, rcfg)
        else:
            zs = torch.sort(torch.cat([zc, zn], -1), dim=-1,
                            stable=True).values
            out = tr.composite(qf, _t(rays), zs, rcfg)
        (torch.sum(out["rgb"] * _t(cot_rgb))
         + torch.sum(out["depth"] * _t(cot_d))).backward()
        for got, w in ((zc.grad, want[0]), (zn.grad, want[1])):
            np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                       atol=1e-5, err_msg=str(reuse))


# ---------------------------------------------------------------- plasma
def test_plasma_table_matches_matplotlib():
    """The port's 256-entry plasma table and color_tensor against
    matplotlib's colormap, to 1e-6: the table itself, and a map of random
    values (out of range and NaN included)."""
    cm = matplotlib.colormaps["plasma"]
    np.testing.assert_allclose(PLASMA, cm(np.arange(256))[:, :3],
                               atol=1e-6)
    x = np.random.default_rng(40).uniform(-0.2, 1.2, (3, 17, 23))
    x[0, 0, :3] = (np.nan, 1.0, 0.0)
    x = x.astype(np.float32)
    want = cm(np.clip(x, 0, 1))[..., :3]
    np.testing.assert_allclose(color_tensor(x), want, atol=1e-6)


def test_visualization_grids_match_jax():
    """build_visualization_images of both packages on the same render dict
    (2 views, 2 render views, 12 samples; NaN-free): every grid within
    1e-6, and JAX's make_grid equal to the port's copy."""
    from behindthescenes_tpu.training.visualize import \
        build_visualization_images as jbuild
    from behindthescenes_tpu_torch.training.visualize import \
        build_visualization_images as tbuild
    rng = np.random.default_rng(50)
    v, h, w, k, vr = 2, 12, 16, 12, 2

    def branch():
        return {"rgb": rng.uniform(-0.1, 1.1, (1, v, h, w, vr, 3)),
                "depth": rng.uniform(0.5, 60, (1, v, h, w)),
                "alphas": rng.uniform(0, 1, (1, v, h, w, k)),
                "invalid": (rng.uniform(size=(1, v, h, w, k, vr)) < 0.3)
                * 1.0}
    data = {"imgs": rng.uniform(-1, 1, (1, v, h, w, 3)),
            "coarse": [branch()], "fine": [branch(), branch()]}
    data = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), data)
    want = jbuild(data, 1.0, 40.0)
    got = tbuild(jax.tree_util.tree_map(torch.as_tensor, data), 1.0, 40.0)
    assert set(got) == set(want)
    for name, img in want.items():
        assert got[name].shape == img.shape, name
        np.testing.assert_allclose(got[name], img, atol=1e-6, err_msg=name)


def test_training_task_writes_the_visualization(monkeypatch, tmp_path):
    """The training task hands the harness the visualisation hook where
    TensorBoard is there: a run of tests/test_harness.py's tiny config
    with visualize_every 2 writes every grid at iterations 2 and 4."""
    from behindthescenes_tpu_torch.training import tasks
    from test_harness import _tiny_config

    class Writer:
        def __init__(self):
            self.images = []

        def add_image(self, tag, img, global_step, dataformats):
            assert dataformats == "HWC" and img.ndim == 3
            self.images.append((tag, global_step))

        def add_scalar(self, *args, **kwargs):
            pass

        def flush(self):
            pass

        def close(self):
            pass
    writer = Writer()
    monkeypatch.setattr(tasks, "_tensorboard", lambda config: writer)
    conf = dict(_tiny_config(str(tmp_path / "run"), 4), visualize_every=2,
                validate_every=1000, checkpoint_every=1000)
    tasks.bts_training(conf, device="cpu")
    steps = sorted({s for _, s in writer.images})
    assert steps == [2, 4]
    tags = {t for t, s in writer.images if s == 2}
    assert {"vis/input_im", "vis/recon_im", "vis/recon_depth_0",
            "vis/depth_profile", "vis/ray_entropy", "vis/alpha_sum",
            "vis/invalids", "vis/recon_mse"} == tags


# ------------------------------------------------------ the train steps
# The overfit harness's model (a learned map, no BatchNorm) at 24x32, 1
# item, 128 rays of 8 coarse samples, so JAX's f32 gradients are exact to
# f32 noise and the port is held to them directly.
def _modes_conf(**model):
    conf = _config({"type": "dummy", "size": (24, 32), "d_out": 16}, 32, 4,
                   4, 128, 8, lr=5e-3)
    conf["model_conf"].update(model)
    return conf


FINE = {"n_fine": 8, "fine_reuse_coarse": True}
MODES = {
    "fine_reuse": (FINE, {}),
    "fine_requery": (dict(FINE, fine_reuse_coarse=False), {}),
    "fine_depth": (dict(FINE, n_fine_depth=4, depth_std=0.25), {}),
    "fine_remat": (FINE, {"remat_render": True, "train_ray_chunk": 64}),
    "automask": ({}, {"use_automasking": True}),
    "patch": ({}, {"image_processor": {"type": "patch", "patch_size": 3}}),
}


def replay_fine(key, conf, n):
    """The coarse jitter and the fine draws of the JAX step with `key`:
    wrapper.forward's k_render, per chunk of `train_ray_chunk` rays folded
    with the chunk's index where the remat render chunks the rays
    (renderer.py:363-442); each render_rays splits its key five ways
    (k_coarse, k_fine, k_fd, ...) and sample_fine splits k_fine in two."""
    mc, rc = conf["model_conf"], conf["renderer"]
    rays = mc["ray_batch_size"]
    chunk = mc["train_ray_chunk"] if mc.get("remat_render") else rays
    k_render = jax.random.split(key, 3)[2]
    keys = [k_render] if rays <= chunk else [
        jax.random.fold_in(k_render, i) for i in range(rays // chunk)]
    n_fd = rc.get("n_fine_depth", 0)
    n_imp = rc.get("n_fine", 0) - n_fd
    out = {"z_jitter": [], "u": [], "jitter": [], "normals": []}
    for kc in keys:
        k_coarse, k_fine, k_fd = jax.random.split(kc, 5)[:3]
        cb = min(chunk, rays)
        out["z_jitter"].append(jax.random.uniform(
            k_coarse, (n, cb, rc["n_coarse"])))
        if n_imp > 0:
            k1, k2 = jax.random.split(k_fine)
            out["u"].append(jax.random.uniform(k1, (n, cb, n_imp)))
            out["jitter"].append(jax.random.uniform(k2, (n, cb, n_imp)))
        if n_fd > 0:
            out["normals"].append(jax.random.normal(k_fd, (n, cb, n_fd)))
    cat = {k: torch.as_tensor(np.concatenate([np.asarray(a) for a in v], 1))
           if v else None for k, v in out.items()}
    fine = None if n_imp + n_fd == 0 else FineDraws(
        cat["u"], cat["jitter"], cat["normals"])
    return cat["z_jitter"], fine


@dataclasses.dataclass
class _Step:
    conf: dict
    flat0: dict
    batch: dict
    draws: Draws
    grads: dict
    terms: dict


def jax_mode_step(mode: str, key: int = 7) -> _Step:
    """JAX's f32 step of MODES[mode] (its initial variables, views, draws)
    and the same draws for the port."""
    renderer, model = MODES[mode]
    conf = _modes_conf(**model)
    conf["renderer"].update(renderer)
    shape = (1, 24, 32)
    batch = _batch(shape)
    trainer = JTrainer(conf, mesh=make_mesh(jax.devices()[:1]),
                       compute_dtype=jnp.float32)
    variables = _jax_init(trainer, batch, jax.random.PRNGKey(0))
    ids = trainer.wrapper.select_views(
        np.random.default_rng(conf["seed"]), 4, training=True)
    jkey = jax.random.PRNGKey(key)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        data, _ = trainer.wrapper.forward({"params": params}, jbatch, jkey,
                                          ids, train=True)
        return trainer.criterion(data)
    grads, terms = jax.jit(jax.grad(loss_fn, has_aux=True))(
        variables["params"])
    mc = conf["model_conf"]
    draws = replay_draws(jkey, 1, len(ids.ids_loss), 24, 32,
                         mc["patch_size"], mc["ray_batch_size"],
                         conf["renderer"]["n_coarse"])
    z_jitter, fine = replay_fine(jkey, conf, 1)
    return _Step(conf, _flat(variables, ""), batch,
                 Draws(rays=draws.rays, z_jitter=z_jitter, fine=fine),
                 _flat(grads, "params/"),
                 {k: float(v) for k, v in terms.items()})


@pytest.fixture(scope="module")
def mode_steps():
    return {}


def _mode_step(mode_steps, mode):
    if mode not in mode_steps:
        mode_steps[mode] = jax_mode_step(mode)
    return mode_steps[mode]


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_step_matches_jax(mode, mode_steps):
    """One f32 step of each mode from JAX's initial parameters with JAX's
    draws: every loss term within 1e-5 relative (atol 1e-8) of JAX's f32
    step, and every gradient tensor within 1e-4 x its largest entry of
    JAX's (the learned map has no BatchNorm, so JAX's f32 gradients are
    exact to f32 noise). Measured: terms 1.7e-6 to 5.9e-6, gradients
    8.6e-6 to 2.0e-5. The chunked remat render is held to 2e-5 and 2e-4:
    JAX's lax.map body sums in another order, and the one-entry lin_out
    bias, a sum over every sample with cancellation, lands 1.2e-4 apart
    (terms 1.0e-5), while the port's chunked step equals its unchunked one
    (test_remat_step_equals_unchunked_step). The fine modes render the
    fine pass (loss_rgb_fine > 0); automasking and the patch processor
    supervise 4 and 27 channels."""
    step = _mode_step(mode_steps, mode)
    rtol, gtol = (2e-5, 2e-4) if mode == "fine_remat" else (1e-5, 1e-4)
    trainer, terms = port_step(step, torch.float32)
    assert set(terms) == set(step.terms)
    for k, want in step.terms.items():
        np.testing.assert_allclose(terms[k], want, rtol=rtol, atol=1e-8,
                                   err_msg=k)
    if mode.startswith("fine"):
        assert terms["loss_rgb_fine"] > 0
    got = _grads(trainer)
    assert set(got) == set(step.grads)
    for k, g in step.grads.items():
        scale = np.abs(g).max()
        assert np.abs(got[k] - g).max() <= gtol * scale, (
            k, np.abs(got[k] - g).max() / max(scale, 1e-30))
    channels = trainer.wrapper.train_sampler.channels
    assert channels == {"automask": 4, "patch": 27}.get(mode, 3)


def test_reuse_step_equals_requery_step(mode_steps):
    """The port's step reusing the coarse samples equals its step
    re-querying them (the same draws): loss terms within 1e-6 relative,
    gradients within 1e-5 x max|g|, as tests/test_train_fine.py:46-62
    holds the JAX package's."""
    step = _mode_step(mode_steps, "fine_reuse")
    requery = dataclasses.replace(step, conf=_modes_conf())
    requery.conf["renderer"].update(MODES["fine_requery"][0])
    a, ta = port_step(step, torch.float32)
    b, tb = port_step(requery, torch.float32)
    for k in ta:
        np.testing.assert_allclose(ta[k], tb[k], rtol=1e-6, atol=1e-9,
                                   err_msg=k)
    ga, gb = _grads(a), _grads(b)
    for k in ga:
        assert np.abs(ga[k] - gb[k]).max() <= 1e-5 * np.abs(gb[k]).max(), k


def test_remat_step_equals_unchunked_step(mode_steps):
    """The port's remat render in chunks of 64 rays (each chunk's query
    re-run in the backward pass) equals the unchunked render on the same
    draws: loss terms within 1e-6 relative, gradients within 1e-5 x
    max|g| (measured 4.1e-7)."""
    step = _mode_step(mode_steps, "fine_remat")
    flat = dataclasses.replace(step, conf=_modes_conf())
    flat.conf["renderer"].update(MODES["fine_remat"][0])
    a, ta = port_step(step, torch.float32)
    b, tb = port_step(flat, torch.float32)
    assert a.wrapper.remat_render and not b.wrapper.remat_render
    for k in ta:
        np.testing.assert_allclose(ta[k], tb[k], rtol=1e-6, atol=1e-9,
                                   err_msg=k)
    ga, gb = _grads(a), _grads(b)
    for k in ga:
        assert np.abs(ga[k] - gb[k]).max() <= 1e-5 * np.abs(gb[k]).max(), k
