"""The paper's KITTI raw depth and RealEstate10K NVS benchmarks through the
port's task runner against the JAX package's, on small trees of the
port's generators (frames written by its JPEG writer: JAX decodes them
with cv2, the port with its own reader): `-cn eval_depth` with
media/weights/k360_synth_conv.npz and `-cn eval_nvs` with
media/weights/re10k_synth_conv.npz (the weight bridge), cut to a small
image size, in f32; one training micro-step of `-cn exp_kitti_raw` and of
`-cn exp_re10k` on a batch of each loader, against JAX's f32 step and its
float64 evaluation as tests/test_torch_train.py holds the flagship's; and
both training configs through `python -m behindthescenes_tpu_torch.train`
for two micro-steps."""
import math
import os
import types

import jax
import numpy as np
import pytest
import torch

from behindthescenes_tpu import config as jconfig
from behindthescenes_tpu import renderer as jr
from behindthescenes_tpu.evaluation import tasks as jtasks
from behindthescenes_tpu.parallel.mesh import make_mesh
from behindthescenes_tpu.training.trainer import BTSTrainer as JTrainer
from behindthescenes_tpu_torch import train as ttrain
from behindthescenes_tpu_torch.config import (find_config, load_config,
                                              parse_cli_overrides)
from behindthescenes_tpu_torch.datasets import gen_synthetic_kitti_raw as gkr
from behindthescenes_tpu_torch.datasets import gen_synthetic_re10k as gre
from behindthescenes_tpu_torch.datasets.factory import make_datasets
from behindthescenes_tpu_torch.datasets.synthetic import collate
from behindthescenes_tpu_torch.evaluation import tasks as ttasks
from behindthescenes_tpu_torch.evaluation.nvs import NVSEvaluator
from behindthescenes_tpu_torch.training.wrapper import Draws
from test_torch_fine import jax_render_draws
from test_torch_train import (_cos, _flat, _grads, _jax_init,
                              jax_float64_step, port_step, replay_draws)

# One intra-op thread: pytest-xdist runs several workers on this CPU,
# and torch's default of a thread per core makes every small op wait
# on threads that the other workers have swapped out.
torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WEIGHTS = os.path.join(ROOT, "media", "weights")
K360 = os.path.join(WEIGHTS, "k360_synth_conv.npz")
RE10K = os.path.join(WEIGHTS, "re10k_synth_conv.npz")
# PSNR (dB) and SSIM between two f32 evaluations whose encoders sum their
# convolutions in another order (tests/test_torch_nvs.py:55); other means
# within 2e-4 relative (tests/test_torch_nvs.py:233).
PSNR_TOL, SSIM_TOL = 1e-3, 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_device_jax():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BTS_EVAL_SHARD", "0")
        yield


@pytest.fixture(scope="module")
def kitti_tree(tmp_path_factory):
    """Six frames at a cut size, test keyframes 2 and 3, frames 1 and 4
    (both views) to train on."""
    root = tmp_path_factory.mktemp("kitti_raw_drive")
    gkr.generate_tree(root, n_frames=6, test_keyframes=(2, 3),
                      size=(94, 311))
    return root


@pytest.fixture(scope="module")
def re10k_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("re10k_tree")
    gre.generate_tree(root, n_frames=14, test_keyframes=(0, 2),
                      size=(36, 64))
    return root


def _close(got, want):
    assert set(got) == set(want)
    for k in want:
        tol = PSNR_TOL if k == "psnr" else SSIM_TOL if k == "ssim" else \
            2e-4 * max(1.0, abs(want[k]))
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])


def _both(name, args):
    path = find_config(name)
    return (jconfig.load_config(path, jconfig.parse_cli_overrides(args)),
            load_config(path, parse_cli_overrides(args)))


def test_eval_depth_task_matches_jax(kitti_tree):
    """-cn eval_depth at 32x96 in f32, the deterministic shared-z ladder
    (z code, no blocks): the port's means equal JAX's on the velodyne
    ground truth of both test keyframes."""
    args = [f"checkpoint={K360}", "data.image_size=[32, 96]", "bf16=false",
            "num_workers=0", *gkr.overrides(kitti_tree)]
    jconf, conf = _both("eval_depth", args)
    want = jtasks.evaluate_depth(jconf)
    got = ttasks.evaluate_depth(conf, device="cpu")
    _close(got, want)
    assert 0 < got["abs_rel"] < 1 and got["a1"] > 0


def test_eval_nvs_task_matches_jax(re10k_tree, monkeypatch):
    """-cn eval_nvs at 32x48 with 16 samples in f32, both test keyframes:
    the port's task fed the draws of JAX's per-item keys PRNGKey(i)."""
    h, w = 32, 48
    args = [f"checkpoint={RE10K}", f"data.image_size=[{h}, {w}]",
            "bf16=false", "num_workers=0", "renderer.n_coarse=16",
            *gre.overrides(re10k_tree)]
    jconf, conf = _both("eval_nvs", args)
    want = jtasks.evaluate_nvs(jconf)
    jcfg = jr.RendererConfig.from_conf(jconf["renderer"])
    evaluate, seen = NVSEvaluator.evaluate, []

    def with_jax_draws(self, batch, generator=None):
        z_jitter, fine = jax_render_draws(
            jax.random.PRNGKey(len(seen)), 1, 2 * h * w, jcfg)
        seen.append(generator.initial_seed())
        return evaluate(self, batch, z_jitter=z_jitter, fine_draws=fine)
    monkeypatch.setattr(NVSEvaluator, "evaluate", with_jax_draws)
    got = ttasks.evaluate_nvs(conf, device="cpu")
    assert seen == [0, 1]
    _close(got, want)
    assert got["psnr"] > 15


# ------------------------------------------------------------ training
# The configs' own model, loss and renderer, cut to ResNet-18, 2 items,
# 128 patch rays (two 8x8 patches) x 8 samples at a small image size.
TRAIN_CUTS = {
    "exp_kitti_raw": ("kitti_tree", (32, 96)),
    "exp_re10k": ("re10k_tree", (32, 48)),
}


def _train_conf(name, tree):
    _, hw = TRAIN_CUTS[name]
    over = gkr.overrides(tree) if name == "exp_kitti_raw" \
        else gre.overrides(tree)
    return load_config(find_config(name), parse_cli_overrides([
        *over, f"data.image_size=[{hw[0]}, {hw[1]}]",
        "model_conf.encoder.resnet_layers=18",
        "model_conf.encoder.pretrained=false",
        "model_conf.ray_batch_size=128", "renderer.n_coarse=8",
        "batch_size=2", "num_workers=0"]))


def disk_step(conf, key=7):
    """One JAX f32 train step of `conf` on the first two training items
    of the port's loader (whose items equal the JAX loader's: see
    tests/test_torch_kitti_raw.py and test_torch_realestate10k.py), with
    JAX's initial variables and views; its draws replayed for the port,
    the flip included. The attributes are those tests/test_torch_train.py's
    port_step and jax_float64_step read."""
    train, _ = make_datasets(conf["data"])
    batch = collate([train[0], train[1]])
    n, v, h, w, _ = batch["imgs"].shape
    trainer = JTrainer(conf, mesh=make_mesh(jax.devices()[:1]),
                       compute_dtype=jax.numpy.float32)
    variables = _jax_init(trainer, batch, jax.random.PRNGKey(0))
    step = types.SimpleNamespace(conf=conf, batch=batch,
                                 key=jax.random.PRNGKey(key))
    step.params = variables["params"]
    step.batch_stats = variables.get("batch_stats", {})
    step.flat0 = {**_flat(step.params, "params/"),
                  **_flat(step.batch_stats, "batch_stats/")}
    step.ids = trainer.wrapper.select_views(
        np.random.default_rng(conf["seed"]), v, training=True)
    jbatch = {k: jax.numpy.asarray(x) for k, x in batch.items()}

    def loss_fn(params, batch_stats):
        data, new_vars = trainer.wrapper.forward(
            {"params": params, "batch_stats": batch_stats}, jbatch,
            step.key, step.ids, train=True)
        loss, terms = trainer.criterion(data)
        return loss, (terms, new_vars.get("batch_stats", {}))
    grads, (terms, _) = jax.jit(jax.grad(loss_fn, has_aux=True))(
        step.params, step.batch_stats)
    step.grads = _flat(grads, "params/")
    step.terms = {k: float(x) for k, x in terms.items()}
    mc = conf["model_conf"]
    draws = replay_draws(step.key, n, len(step.ids.ids_loss), h, w,
                         mc["patch_size"], mc["ray_batch_size"],
                         conf["renderer"]["n_coarse"])
    k_flip = jax.random.split(step.key, 3)[0]
    flip = bool(jax.random.uniform(k_flip, ()) > 0.5)
    assert mc["flip_augmentation"]
    step.draws = Draws(flip=flip, rays=draws.rays, z_jitter=draws.z_jitter)
    return step


# Each gradient tensor's distance from JAX's float64 step, over max|g|:
# exp_kitti_raw's as the flagship's (tests/test_torch_train.py); on
# exp_re10k both f32 steps, the port's and JAX's, sit up to 1.33e-3 from
# float64 (its distance code takes sines of arguments up to 1.5 x 32 x
# 100 in f32), the port on some tensors 1e-4 farther than JAX and on
# others nearer.
EXACT_RTOL = {"exp_kitti_raw": 1e-4, "exp_re10k": 2e-3}


@pytest.mark.parametrize("name", sorted(TRAIN_CUTS))
def test_train_step_matches_jax(name, request):
    """The f32 step's loss terms within 1e-5 relative of JAX's f32 step;
    each gradient tensor within EXACT_RTOL x max|g| of JAX's float64
    evaluation of the same step, and within 1e-4 x max|g| plus JAX's own
    distance from float64 of JAX's f32 tensor at a cosine of 0.999
    (BatchNorm's f32 variance moves JAX's ResNet gradients: see
    test_torch_train.test_f32_step_matches_jax); over all tensors, no
    farther from exact than JAX's f32 step plus 1e-4."""
    tree = request.getfixturevalue(TRAIN_CUTS[name][0])
    step = disk_step(_train_conf(name, tree))
    trainer, terms = port_step(step, torch.float32)
    assert set(terms) == set(step.terms)
    for k, want in step.terms.items():
        np.testing.assert_allclose(terms[k], want, rtol=1e-5, atol=1e-8,
                                   err_msg=k)
    exact, _, _ = jax_float64_step(step)
    got = _grads(trainer)
    assert set(got) == set(step.grads) == set(exact)
    port_err = jax_err = 0.0
    for k, g in step.grads.items():
        scale = np.abs(exact[k]).max()
        if scale == 0:
            assert not got[k].any(), k
            continue
        port_gap = np.abs(got[k] - exact[k]).max()
        jax_gap = np.abs(g - exact[k]).max()
        port_err = max(port_err, port_gap / scale)
        jax_err = max(jax_err, jax_gap / scale)
        assert port_gap <= EXACT_RTOL[name] * scale, k
        assert np.abs(got[k] - g).max() <= 1e-4 * scale + jax_gap, k
        assert _cos(got[k], g) >= 0.999, k
    assert port_err <= jax_err + 1e-4, (port_err, jax_err)


@pytest.mark.parametrize("name", sorted(TRAIN_CUTS))
def test_training_task_runs(name, request, tmp_path, monkeypatch):
    """`python -m behindthescenes_tpu_torch.train -cn NAME` on the tree,
    cut as above: two micro-steps (one update) with finite losses, and a
    checkpoint at the stop."""
    tree = request.getfixturevalue(TRAIN_CUTS[name][0])
    _, hw = TRAIN_CUTS[name]
    over = gkr.overrides(tree) if name == "exp_kitti_raw" \
        else gre.overrides(tree)
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "torch_home"))
    losses = []
    from behindthescenes_tpu_torch.training import tasks

    def on_iteration(it, trainer, loss_dict):
        losses.append(float(loss_dict["loss"]))
    run = tasks.bts_training
    monkeypatch.setattr(tasks, "bts_training", lambda config, device=None,
                        **kw: run(config, device=device,
                                  on_iteration=on_iteration))
    ttrain.main(["-cn", name, *over, f"data.image_size=[{hw[0]}, {hw[1]}]",
                 "model_conf.encoder.resnet_layers=18",
                 "model_conf.ray_batch_size=128", "renderer.n_coarse=8",
                 "batch_size=2", "accumulate_steps=2", "num_workers=0",
                 "stop_iteration=2", "validate_every=100",
                 f"output_path={tmp_path / 'run'}", "--device", "cpu"])
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert os.listdir(tmp_path / "run" / "checkpoints")
