"""The port's evaluation path against the JAX package's: PSNR, SSIM and
LPIPS (on synthetic VGG weights; the real ones cannot be fetched), the
NVS evaluator and the depth evaluator's `mode: nvs` on committed
checkpoints with JAX's draws replayed, the RE10K-shape model's
distance-coded one-block depth, the task runner and its harness, and the
`python -m behindthescenes_tpu_torch.eval` entry point. All in f32 at
small shapes; the JAX evaluators run on one device (BTS_EVAL_SHARD=0) so
that their draws are those of one chunk.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behindthescenes_tpu import config as jconfig
from behindthescenes_tpu import renderer as jr
from behindthescenes_tpu.datasets.factory import make_datasets as j_datasets
from behindthescenes_tpu.datasets.synthetic import collate
from behindthescenes_tpu.evaluation import metrics as jm
from behindthescenes_tpu.evaluation import tasks as jtasks
from behindthescenes_tpu.evaluation.depth import DepthEvaluator as JDepth
from behindthescenes_tpu.evaluation.nvs import NVSEvaluator as JNVS
from behindthescenes_tpu.models.bts import BTSNet as JBTSNet
from behindthescenes_tpu.utils.io import load_params_npz as j_load_npz
from behindthescenes_tpu_torch import eval as teval
from behindthescenes_tpu_torch import renderer as tr
from behindthescenes_tpu_torch.config import (find_config, load_config,
                                              parse_cli_overrides)
from behindthescenes_tpu_torch.datasets.loader import DataLoader
from behindthescenes_tpu_torch.datasets.synthetic import SyntheticBoxDataset
from behindthescenes_tpu_torch.evaluation import harness
from behindthescenes_tpu_torch.evaluation import metrics as tm
from behindthescenes_tpu_torch.evaluation import tasks as ttasks
from behindthescenes_tpu_torch.evaluation.depth import DepthEvaluator
from behindthescenes_tpu_torch.evaluation.nvs import NVSEvaluator
from behindthescenes_tpu_torch.models.bts import BTSNet
from behindthescenes_tpu_torch.weights import load_weights
from test_torch_fine import jax_render_draws

# One intra-op thread: pytest-xdist runs several workers on this CPU,
# and torch's default of a thread per core makes every small op wait
# on threads that the other workers have swapped out.
torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WEIGHTS = os.path.join(ROOT, "media", "weights")
THIN = os.path.join(WEIGHTS, "thin_synth_conv.npz")
RE10K = os.path.join(WEIGHTS, "re10k_synth_conv.npz")
# PSNR (dB) and SSIM between two f32 evaluations whose encoders sum their
# convolutions in another order (densities ~1e-5 apart).
PSNR_TOL, SSIM_TOL = 1e-3, 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_device_jax():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BTS_EVAL_SHARD", "0")
        yield


def _conf(name):
    return load_config(find_config(name))


# ------------------------------------------------------------- metrics
@pytest.mark.parametrize("shape", [(17, 23), (20, 26, 3)])
def test_psnr_ssim_match_jax(shape):
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    assert abs(tm.psnr(a, b) - jm.psnr(a, b)) < 1e-9
    assert abs(tm.ssim(a, b) - jm.ssim(a, b)) < 1e-9
    assert tm.psnr(a, a) == float("inf")


VGG_CFG = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 256),
           (256, 256), (256, 256), (256, 512), (512, 512), (512, 512),
           (512, 512), (512, 512), (512, 512)]
LIN_CH = [64, 128, 256, 512, 512]


@pytest.fixture(scope="module")
def fake_lpips_npz(tmp_path_factory):
    """tests/test_lpips_perceptual.py:12-26's synthetic weights, with
    nonzero biases."""
    rng = np.random.default_rng(0)
    out = {}
    for i, (cin, cout) in enumerate(VGG_CFG):
        out[f"conv{i}_w"] = rng.standard_normal(
            (3, 3, cin, cout)).astype(np.float32) * 0.05
        out[f"conv{i}_b"] = rng.standard_normal(cout).astype(np.float32) \
            * 0.01
    for i, c in enumerate(LIN_CH):
        out[f"lin{i}_w"] = np.abs(rng.standard_normal(c)).astype(np.float32)
    out["shift"] = np.array([-0.030, -0.088, -0.188], dtype=np.float32)
    out["scale"] = np.array([0.458, 0.448, 0.450], dtype=np.float32)
    path = tmp_path_factory.mktemp("lpips") / "fake_lpips.npz"
    np.savez(path, **out)
    return str(path)


def test_lpips_matches_jax(fake_lpips_npz):
    """36x44: the 2x2 VALID pools drop odd rows and columns."""
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, (36, 44, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), 0, 1).astype(np.float32)
    want = jm.LPIPSVGG(fake_lpips_npz)(a, b)
    got = tm.LPIPSVGG(fake_lpips_npz)(a, b)
    assert want > 0 and abs(got - want) <= 1e-5 * max(1.0, want)
    assert tm.LPIPSVGG(fake_lpips_npz)(a, a) < 1e-9


def test_lpips_without_weights_is_none(monkeypatch):
    monkeypatch.delenv("BTS_LPIPS_WEIGHTS", raising=False)
    assert tm.LPIPSVGG.maybe_create(None) is None
    assert tm.LPIPSVGG.maybe_create("/no/such/weights.npz") is None


# ----------------------------------------------------------- evaluators
def _sides(name, ckpt):
    """The config's model from `ckpt` on both sides, f32."""
    mc = _conf(name)["model_conf"]
    jnet = JBTSNet.from_conf(mc)
    net = load_weights(BTSNet.from_conf(mc), ckpt).eval()
    return mc, jnet, j_load_npz(ckpt), net


def _batch(scene, hw, idx=0, fc=2):
    _, ds = j_datasets({"type": "Synthetic", "image_size": hw,
                        "scene": scene, "data_fc": fc})
    return collate([ds[idx]])


def _close(got, want):
    assert set(got) == set(want)
    for k in want:
        tol = PSNR_TOL if k == "psnr" else SSIM_TOL if k == "ssim" else \
            2e-4 * max(1.0, abs(want[k]))
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])


NVS_CASES = {
    # thin family, 8 coarse + 8 importance fine with reuse, encoded at half
    # resolution
    "thin_fine_reuse": ("eval_synthetic_thin_nvs", THIN, "street", (24, 32),
                        dict(n_coarse=8, n_fine=8, fine_reuse_coarse=True,
                             lindisp=True, hard_alpha_cap=True), (12, 16)),
    # the RE10K-shape model: distance code, one block, d_out 32
    "re10k": ("eval_synthetic_re10k_nvs", RE10K, "indoor", (32, 48),
              dict(n_coarse=16, lindisp=True, hard_alpha_cap=True), None),
}


@pytest.mark.parametrize("case", list(NVS_CASES))
def test_nvs_evaluator_matches_jax(case):
    name, ckpt, scene, hw, rkw, er = NVS_CASES[case]
    mc, jnet, variables, net = _sides(name, ckpt)
    batch = _batch(scene, hw)
    key = jax.random.PRNGKey(3)
    jcfg = jr.RendererConfig(**rkw)
    want = JNVS(jnet, jcfg, mc, eval_resolution=er).evaluate(
        variables, batch, key=key)
    z_jitter, fine = jax_render_draws(key, 1, 2 * hw[0] * hw[1], jcfg)
    got = NVSEvaluator(net, tr.RendererConfig(**rkw), mc,
                       eval_resolution=er).evaluate(
        batch, z_jitter=z_jitter, fine_draws=fine)
    _close(got, want)


def test_depth_evaluator_nvs_mode_matches_jax():
    """mode: nvs on the thin family with the fine pass: depth metrics of
    view 0 and PSNR/SSIM of the middle frame through the general path."""
    mc, jnet, variables, net = _sides("eval_synthetic_thin", THIN)
    batch = _batch("street", (24, 32), idx=1)
    rkw = dict(n_coarse=8, n_fine=8, fine_reuse_coarse=True, lindisp=True,
               hard_alpha_cap=True)
    key = jax.random.PRNGKey(4)
    jcfg = jr.RendererConfig(**rkw)
    want = JDepth(jnet, jcfg, mc, eval_nvs=True).evaluate(variables, batch,
                                                          key=key)
    z_jitter, fine = jax_render_draws(key, 1, 2 * 24 * 32, jcfg)
    ev = DepthEvaluator(net, tr.RendererConfig(**rkw), mc, eval_nvs=True)
    assert not ev.use_selfview
    got = ev.evaluate(batch, z_jitter=z_jitter, fine_draws=fine)
    assert {"psnr", "ssim", "abs_rel", "a1"} <= set(got)
    _close(got, want)


def test_re10k_selfview_depth_matches_jax():
    """The RE10K-shape checkpoint's keyframe depth through the self-view
    path: distance code and one block decode through call_split, with
    JAX's stratified draw."""
    mc, jnet, variables, net = _sides("exp_synthetic_re10k", RE10K)
    batch = _batch("indoor", (32, 48), fc=3)
    rkw = dict(n_coarse=16, lindisp=True, hard_alpha_cap=True)
    key = jax.random.PRNGKey(5)
    want = JDepth(jnet, jr.RendererConfig(**rkw), mc).evaluate(
        variables, batch, key=key)
    stub = jnp.concatenate([jnp.zeros((32 * 48, 6)),
                            jnp.full((32 * 48, 1), mc["z_near"]),
                            jnp.full((32 * 48, 1), mc["z_far"])], -1)
    z_samp = jr.sample_coarse(key, stub, 16, True)
    ev = DepthEvaluator(net, tr.RendererConfig(**rkw), mc)
    assert ev.use_selfview and not ev.deterministic
    got = ev.evaluate(batch, z_samp=torch.as_tensor(np.asarray(z_samp)))
    _close(got, want)


def test_nvs_sweep_matches_jax():
    """eval_synthetic_thin_nvs's model with sweep-mode serving, one scene
    at 24x32, f32: the port's evaluator with `nvs_sweep: true` (the
    defaults: warp 0.5, decode at the lattice, top-8 colours) against
    JAX's with those defaults named (JAX reads `true` as an empty dict
    and renders its general path then,
    behindthescenes_tpu/evaluation/nvs.py:39-42). The sweep draws
    nothing: PSNR within PSNR_TOL, SSIM within SSIM_TOL."""
    mc, jnet, variables, net = _sides("eval_synthetic_thin_nvs", THIN)
    cfg = dict(n_coarse=16, lindisp=True, hard_alpha_cap=True)
    jmc = dict(mc, nvs_sweep={"warp_scale": 0.5})
    want = JNVS(jnet, jr.RendererConfig(**cfg), jmc).evaluate(
        variables, _batch("street", (24, 32)))
    got = NVSEvaluator(net, tr.RendererConfig(**cfg),
                       dict(mc, nvs_sweep=True)).evaluate(
        _batch("street", (24, 32)))
    _close(got, want)


# ------------------------------------------------------ the task runner
def test_depth_task_matches_jax():
    """eval_synthetic with the committed ResNet-18 checkpoint at 24x32 in
    f32, deterministic self-view depth: the JAX task's means."""
    args = ["data.image_size=[24, 32]", "bf16=false",
            "checkpoint=" + os.path.join(WEIGHTS,
                                         "synthetic_conv_step8400.npz")]
    path = find_config("eval_synthetic")
    want = jtasks.evaluate_depth(jconfig.load_config(
        path, jconfig.parse_cli_overrides(args)))
    got = ttasks.evaluate_depth(load_config(
        path, parse_cli_overrides(args)), device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 2e-4 * max(1.0, abs(want[k])), k


def test_nvs_task_matches_jax(monkeypatch):
    """eval_synthetic_thin_nvs at 24x32, 4 items, 8 + 8 with reuse, f32:
    the port's task fed the draws of JAX's per-item keys PRNGKey(i)."""
    args = ["data.image_size=[24, 32]", "data.length=32", "bf16=false",
            "renderer.n_coarse=8", "renderer.n_fine=8",
            "renderer.fine_reuse_coarse=true", "checkpoint=" + THIN]
    path = find_config("eval_synthetic_thin_nvs")
    jconf = jconfig.load_config(path, jconfig.parse_cli_overrides(args))
    want = jtasks.evaluate_nvs(jconf)
    jcfg = jr.RendererConfig.from_conf(jconf["renderer"])
    evaluate, seen = NVSEvaluator.evaluate, []

    def with_jax_draws(self, batch, generator=None):
        z_jitter, fine = jax_render_draws(
            jax.random.PRNGKey(len(seen)), 1, 2 * 24 * 32, jcfg)
        seen.append(generator.initial_seed())
        return evaluate(self, batch, z_jitter=z_jitter, fine_draws=fine)
    monkeypatch.setattr(NVSEvaluator, "evaluate", with_jax_draws)
    got = ttasks.evaluate_nvs(load_config(
        path, parse_cli_overrides(args)), device="cpu")
    assert seen == [0, 1, 2, 3]
    _close(got, want)


def test_tasks_compute_in_bf16_by_default():
    conf = _conf("eval_synthetic_nvs")
    net, rcfg = ttasks._net_and_cfg(conf, "cpu")
    assert net.compute_dtype == torch.bfloat16
    assert rcfg == tr.RendererConfig.from_conf(conf["renderer"])
    net32, _ = ttasks._net_and_cfg(dict(conf, bf16=False), "cpu")
    assert net32.compute_dtype == torch.float32
    # no checkpoint: the same seeded initialisation every time
    for a, b in zip(net.parameters(), net32.parameters()):
        assert torch.equal(a, b)


def test_unported_tasks_and_checkpoints_are_refused(tmp_path):
    """What is still refused names itself: an orbax step directory of the
    JAX package. Training with the fine pass (n_fine > 0) runs now (its
    step is held to JAX's in tests/test_torch_train_modes.py), and its
    trainer's checkpoint loads for evaluation. Run and step directories of
    the port's harness and reference `.pt` checkpoints load now (a step
    directory here; tests/test_torch_run_harness.py and
    tests/test_torch_import.py hold them to the JAX package); an unknown
    file still raises, and no checkpoint keeps the net as it is."""
    from behindthescenes_tpu_torch.training.harness import CheckpointManager
    from behindthescenes_tpu_torch.training.trainer import BTSTrainer
    conf = _conf("eval_synthetic")
    net = BTSNet.from_conf(conf["model_conf"])
    (tmp_path / "orbax" / "15" / "default").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="orbax"):
        harness.load_eval_variables(
            {"checkpoint": str(tmp_path / "orbax")}, net)
    trainer = BTSTrainer(dict(conf, renderer=dict(conf["renderer"],
                                                  n_fine=4)), device="cpu")
    trainer.init_state()
    ds = SyntheticBoxDataset(length=1, frame_count=4, height=48, width=64)
    terms = trainer.train_step(collate([ds[0]]))
    assert np.isfinite(float(terms["loss"]))
    assert float(terms["loss_rgb_fine"]) > 0
    CheckpointManager(str(tmp_path / "run" / "checkpoints")).save(
        2, trainer)
    loaded = BTSNet.from_conf(conf["model_conf"])
    harness.load_eval_variables(
        {"checkpoint": str(tmp_path / "run" / "checkpoints" / "2")}, loaded)
    for a, b in zip(loaded.state_dict().values(),
                    trainer.net.state_dict().values()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        harness.load_eval_variables({"checkpoint": "weights.bin"}, net)
    assert harness.load_eval_variables({"checkpoint": None}, net) is net


def test_mean_metric_skips_nan():
    m = harness.MeanMetric()
    assert np.isnan(m.compute())
    for v in (1.0, float("nan"), 3.0):
        m.update(v)
    assert m.compute() == 2.0


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_batches_in_order(workers):
    ds = SyntheticBoxDataset(length=5, height=8, width=12, seed=3)
    batches = list(DataLoader(ds, batch_size=2, num_workers=workers))
    assert len(batches) == 3 == len(DataLoader(ds, batch_size=2))
    assert [b["imgs"].shape[0] for b in batches] == [2, 2, 1]
    np.testing.assert_array_equal(batches[2]["imgs"][0], ds[4]["imgs"])


def test_eval_entry_point_prints_one_json_line(capsys):
    """The acceptance run, at 24x32: `python -m
    behindthescenes_tpu_torch.eval -cn eval_synthetic_nvs --device cpu`."""
    means = teval.main(["-cn", "eval_synthetic_nvs", "--device", "cpu",
                        "data.image_size=[24, 32]"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == means
    assert set(means) == {"psnr", "ssim"}
    assert all(np.isfinite(v) for v in means.values())
    with pytest.raises(ValueError, match="Unknown eval task"):
        teval.main(["-cn", "eval_synthetic", "model=nope", "--device",
                    "cpu"])
