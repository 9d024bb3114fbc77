"""The port's sweep-mode frame renderer (models/sweep.py) and the NVS
evaluator's sweep mode against the JAX package's, on the converged
exp_synthetic checkpoint (synthetic_conv_step8400.npz) at
tests/test_sweep.py's size (ResNet-18, 48x64, K = 24): the same encoded
view (each side's own encode of the same image), the same novel pose,
the same arguments. The sweep draws nothing, so only rounding separates
the two sides.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behindthescenes_tpu import geometry as jgeometry
from behindthescenes_tpu import renderer as jrenderer
from behindthescenes_tpu.datasets.factory import make_datasets
from behindthescenes_tpu.datasets.synthetic import collate
from behindthescenes_tpu.evaluation.nvs import NVSEvaluator as JNVS
from behindthescenes_tpu.models import sweep as jsweep
from behindthescenes_tpu.models.bts import BTSNet as JBTSNet
from behindthescenes_tpu.utils.io import load_params_npz
from behindthescenes_tpu_torch import geometry
from behindthescenes_tpu_torch import renderer as rlib
from behindthescenes_tpu_torch.evaluation.nvs import NVSEvaluator
from behindthescenes_tpu_torch.models import sweep
from behindthescenes_tpu_torch.models.bts import BTSNet
from behindthescenes_tpu_torch.weights import load_weights

# One intra-op thread: pytest-xdist runs several workers on this CPU,
# and torch's default of a thread per core makes every small op wait
# on threads that the other workers have swapped out.
torch.set_num_threads(1)

ARTIFACT = os.path.join(os.path.dirname(__file__), "..", "media", "weights",
                        "synthetic_conv_step8400.npz")
MC = {
    "arch": "BTSNet", "z_near": 1.0, "z_far": 40.0, "inv_z": True,
    "learn_empty": False,
    "encoder": {"type": "monodepth2", "resnet_layers": 18,
                "num_ch_dec": (16, 16, 32, 32, 64), "d_out": 16,
                "scales": (0,)},
    "code": {"num_freqs": 6, "freq_factor": 1.5, "include_input": True},
    "mlp_coarse": {"type": "resnet", "n_blocks": 0, "d_hidden": 32},
    "mlp_fine": {"type": "empty"},
}
H, W, K = 48, 64, 24
CFG = dict(n_coarse=K, lindisp=True, hard_alpha_cap=True)
# tests/test_sweep.py:80-88's bounds of the exact sweep against the
# general path, which hold the port against JAX here too.
EXACT_TOL = {"rgb": 2e-5, "depth": 1e-4, "weights": 2e-5}
# The warp lattice and the approximate colour modes at f32: two
# encoders that sum their convolutions in another order give features
# ~1e-6 apart, which the resample and the MLP carry through.
APPROX_TOL = {"rgb": 1e-4, "depth": 1e-3, "weights": 1e-4}


def _batch():
    _, ds = make_datasets({"type": "Synthetic", "image_size": (H, W),
                           "data_fc": 2, "length": 64})
    return collate([ds[0]])


class Sides:
    """The encoded view and the novel pose on both sides, in one dtype."""

    def __init__(self, bf16: bool):
        batch = _batch()
        jdt = jnp.bfloat16 if bf16 else jnp.float32
        tdt = torch.bfloat16 if bf16 else torch.float32
        self.jnet = JBTSNet.from_conf(MC, compute_dtype=jdt)
        self.variables = load_params_npz(ARTIFACT)
        images = jnp.asarray(batch["imgs"])
        projs = jnp.asarray(batch["projs"])
        poses = jgeometry.rebase_poses_to_keyframe(jnp.asarray(
            batch["poses"]))
        self.jgrid = self.jnet.apply(
            self.variables, images, projs, poses, ids_encoder=[0],
            ids_render=[0], images_alt=images[:, :1] * 0.5 + 0.5,
            method=JBTSNet.encode)
        self.jpose, self.jproj = poses[0, 1], projs[0, 1]

        self.net = load_weights(BTSNet.from_conf(MC, compute_dtype=tdt),
                                ARTIFACT).eval()
        t_images = torch.as_tensor(batch["imgs"])
        t_projs = torch.as_tensor(batch["projs"])
        t_poses = geometry.rebase_poses_to_keyframe(
            torch.as_tensor(batch["poses"]))
        with torch.no_grad():
            self.grid = self.net.encode(
                t_images, t_projs, t_poses, ids_encoder=[0], ids_render=[0],
                images_alt=t_images[:, :1] * 0.5 + 0.5)
        self.pose, self.proj = t_poses[0, 1], t_projs[0, 1]

    def jax(self, **kw):
        cfg = jrenderer.RendererConfig(**CFG)
        out = jsweep.render_frame_sweep(
            self.jnet, self.variables, self.jgrid, self.jpose, self.jproj,
            (H, W), cfg, **kw)["coarse"]
        return {k: np.asarray(v, np.float32) for k, v in out.items()}

    @torch.no_grad()
    def port(self, **kw):
        out = sweep.render_frame_sweep(
            self.net, self.grid, self.pose, self.proj, (H, W),
            rlib.RendererConfig(**CFG), **kw)["coarse"]
        return {k: v.float().numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def f32():
    return Sides(bf16=False)


@pytest.fixture(scope="module")
def bf16():
    return Sides(bf16=True)


def _close(got, want, tol):
    assert set(got) == set(want)
    for k, t in tol.items():
        assert got[k].shape == want[k].shape, k
        err = np.abs(got[k] - want[k]).max()
        assert err <= t, (k, err)
    np.testing.assert_array_equal(got["invalid"] > 0, want["invalid"] > 0)
    np.testing.assert_array_equal(got["z_samps"], want["z_samps"])


def test_exact_sweep_matches_jax(f32):
    """warp_scale=None, color_mode="exact" in f32: rgb within 2e-5, depth
    within 1e-4, weights within 2e-5, the invalid masks equal."""
    kw = dict(warp_scale=None, color_mode="exact")
    _close(f32.port(**kw), f32.jax(**kw), EXACT_TOL)


@pytest.mark.parametrize("mlp_at_warp", [True, False])
def test_warp_sweep_matches_jax(f32, mlp_at_warp):
    """The default warp lattice (0.5 x the feature map), decoding at the
    lattice (the logits resampled in f32) or at render resolution (the
    features resampled), with top-M colours, within APPROX_TOL."""
    kw = dict(warp_scale=0.5, mlp_at_warp=mlp_at_warp, color_mode="topm")
    _close(f32.port(**kw), f32.jax(**kw), APPROX_TOL)


@pytest.mark.parametrize("color_mode", ["topm", "expected", "none"])
def test_color_modes_match_jax(f32, color_mode):
    """Each colour mode on the exact fetch, within APPROX_TOL; "none" is
    zeros with an all-valid colour mask."""
    kw = dict(warp_scale=None, color_mode=color_mode)
    got, want = f32.port(**kw), f32.jax(**kw)
    _close(got, want, APPROX_TOL)
    if color_mode == "none":
        assert not got["rgb"].any()


def test_topm_ties_are_zero_weights(f32):
    """torch.topk and lax.top_k may order equal weights differently. On
    the converged frame no two weights tie at the top-8 boundary unless
    both are zero. Zero ties change nothing: with every weight but each
    ray's 4 largest set to 0, presenting the samples in the reverse order
    (so that topk keeps other zero samples) gives the same colour and the
    same any-sample mask (threshold 1e-4)."""
    out = f32.port(warp_scale=None, color_mode="exact")
    w = torch.as_tensor(out["weights"])
    ranked = torch.sort(w[0], -1, descending=True).values
    tied = ranked[:, 7] == ranked[:, 8]
    assert (ranked[tied, 7] == 0).all()
    w = torch.where(w >= ranked[None, :, 3:4], w, torch.zeros_like(w))
    origin = f32.pose[:3, 3]
    focal = torch.stack([f32.proj[0, 0], f32.proj[1, 1]])
    c = torch.stack([f32.proj[0, 2], f32.proj[1, 2]])
    dirs = geometry.gen_rays(f32.pose[None], W, H, 1.0, 40.0, focal=focal,
                             c=c)[0, ..., 3:6].reshape(H * W, 3)
    z = sweep.sweep_z_ladder(K, 1.0, 40.0, True)
    rev = torch.arange(K - 1, -1, -1)
    rgb_a, inv_a = sweep.sweep_colors(f32.grid, origin, dirs, z, w,
                                      color_mode="topm")
    rgb_b, inv_b = sweep.sweep_colors(f32.grid, origin, dirs, z[rev],
                                      w[..., rev], color_mode="topm")
    np.testing.assert_allclose(rgb_a.numpy(), rgb_b.numpy(), atol=1e-6)
    np.testing.assert_array_equal(inv_a.numpy(), inv_b.numpy())


@pytest.mark.parametrize("planes_per_step", [5, 7])
def test_planes_per_step_not_dividing_k(f32, planes_per_step):
    """A block size that does not divide K falls to its largest divisor
    below (5 -> 4, 7 -> 6) on both sides; the frame is the exact one."""
    assert sweep._block_divisor(K, planes_per_step) == planes_per_step - 1
    kw = dict(warp_scale=None, color_mode="exact",
              planes_per_step=planes_per_step)
    _close(f32.port(**kw), f32.jax(**kw), EXACT_TOL)
    _close(f32.port(**kw), f32.port(warp_scale=None, color_mode="exact"),
           {"rgb": 1e-6, "depth": 1e-5, "weights": 1e-6})


def test_bf16_sweep(f32, bf16):
    """bf16 (x-pair-free: 16 latent channels take the 4-corner lerp, f16
    colours): within the JAX test's own 0.02 mean of the f32 frame
    (tests/test_sweep.py:113), and within 0.02 max, 0.002 mean of rgb of
    JAX's bf16 frame, depth within 2% of it, as bf16's 8-bit mantissa
    rounds both sides at the same places."""
    kw = dict(warp_scale=1.0, color_mode="topm")
    a, b, j = f32.port(**kw), bf16.port(**kw), bf16.jax(**kw)
    assert np.isfinite(b["rgb"]).all()
    assert np.abs(a["rgb"] - b["rgb"]).mean() < 0.02
    d = np.abs(b["rgb"] - j["rgb"])
    assert d.max() < 0.02 and d.mean() < 0.002, (d.max(), d.mean())
    rel = np.abs(b["depth"] - j["depth"]) / j["depth"]
    assert rel.max() < 0.02, rel.max()


def test_exact_sweep_matches_the_general_path(f32):
    """The port's exact sweep equals its own general path (the cross-view
    query composited over the sweep's shared ladder,
    tests/test_sweep.py:58-71) within tests/test_sweep.py:80-88's
    bounds."""
    net, grid, pose, proj = f32.net, f32.grid, f32.pose, f32.proj
    cfg = rlib.RendererConfig(**CFG)
    z = sweep.sweep_z_ladder(K, 1.0, 40.0, True)
    focal = torch.stack([proj[0, 0], proj[1, 1]])
    c = torch.stack([proj[0, 2], proj[1, 2]])
    rays = geometry.gen_rays(pose[None], W, H, 1.0, 40.0, focal=focal,
                             c=c).reshape(1, H * W, 8)
    with torch.no_grad():
        gen = rlib.composite(lambda xyz, coarse: net.query(
            grid, xyz, coarse=coarse), rays, z.expand(1, H * W, K), cfg)
    gen = {k: v.float().numpy() for k, v in gen.items()}
    out = f32.port(warp_scale=None, color_mode="exact")
    for k, t in EXACT_TOL.items():
        assert np.abs(out[k] - gen[k]).max() <= t, k
    np.testing.assert_array_equal(out["invalid"][..., 0] > 0,
                                  gen["invalid"][..., 0] > 0)


# (the port's nvs_sweep, JAX's): JAX's evaluator reads `nvs_sweep: true`
# as {} and then tests that dict's truth, so true renders through its
# general path (behindthescenes_tpu/evaluation/nvs.py:39-42); its sweep
# defaults are reached with any non-empty dict, here warp_scale 0.5, the
# default itself. The port's true is the sweep with the defaults.
SWEEP_CONFS = {
    "defaults": (True, {"warp_scale": 0.5}),
    "exact": ({"warp_scale": None, "color_mode": "exact"},) * 2,
    "warp0.25_expected": ({"warp_scale": 0.25, "mlp_at_warp": False,
                           "color_mode": "expected"},) * 2,
}


@pytest.mark.parametrize("case", list(SWEEP_CONFS))
def test_nvs_evaluator_sweep_matches_jax(case):
    """NVSEvaluator with model_conf.nvs_sweep (true: the defaults; a dict:
    render_frame_sweep's keywords) against JAX's sweep evaluator on the
    same item, f32: PSNR within 0.01 dB, SSIM within 1e-4. The sweep
    draws nothing, so the generator changes nothing."""
    port_conf, jax_conf = SWEEP_CONFS[case]
    batch = _batch()
    jmc = dict(MC, nvs_sweep=jax_conf)
    jev = JNVS(JBTSNet.from_conf(jmc), jrenderer.RendererConfig(**CFG), jmc)
    assert jev.sweep_conf == jax_conf
    want = jev.evaluate(load_params_npz(ARTIFACT), batch)
    mc = dict(MC, nvs_sweep=port_conf)
    ev = NVSEvaluator(load_weights(BTSNet.from_conf(mc), ARTIFACT).eval(),
                      rlib.RendererConfig(**CFG), mc)
    assert ev.sweep_conf == ({} if port_conf is True else port_conf)
    gen = torch.Generator()
    gen.manual_seed(3)
    got = ev.evaluate(batch, generator=gen)
    assert abs(got["psnr"] - want["psnr"]) <= 0.01, (got, want)
    assert abs(got["ssim"] - want["ssim"]) <= 1e-4, (got, want)
    assert ev.evaluate(batch) == got


def test_mesh_argument_raises(f32):
    """Ray sharding over several cards is not ported: a mesh raises and
    names its ROADMAP item."""
    with pytest.raises(NotImplementedError, match="item 5"):
        f32.port(mesh=object())
