"""The two committed checkpoints that the JAX package gates and that had not
run through the port, held to the JAX gates' own bounds, at the JAX tests'
own sizes, and within the port's bounds of the JAX package's value on
the same inputs (`chip_smoke.JAX_GAP`: the two sides draw their jitter
from different generators, so the gap is sampling noise and rounding):

- media/weights/synthetic_conv_step8400.npz (exp_synthetic's ResNet-18,
  an f16 export): depth on tests/test_accuracy_gate.py's 8 scenes at
  48x64 through the trainer's eval step, in f32 and in bf16 (abs_rel <
  0.21, a1 > 0.63), and NVS on its 4 scenes (PSNR > 19.8, SSIM > 0.80);
- media/weights/fastanneal_conv.npz (the flagship ResNet-50): depth on
  tests/test_train_anneal_gate.py's 4 scenes at 192x640 with 64 samples
  (abs_rel < 0.213, a1 > 0.54), and NVS at 96x320 with 24 + 16 samples
  reusing the coarse ones (PSNR > 17.9, SSIM > 0.70).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behindthescenes_tpu import renderer as jr
from behindthescenes_tpu.datasets.factory import make_datasets as j_datasets
from behindthescenes_tpu.datasets.synthetic import collate as j_collate
from behindthescenes_tpu.evaluation.depth import DepthEvaluator as JDepth
from behindthescenes_tpu.evaluation.nvs import NVSEvaluator as JNVS
from behindthescenes_tpu.models.bts import BTSNet as JBTSNet
from behindthescenes_tpu.parallel.mesh import make_mesh
from behindthescenes_tpu.training.trainer import BTSTrainer as JTrainer
from behindthescenes_tpu.training.trainer import TrainState
from behindthescenes_tpu.utils.io import load_params_npz as j_load
from behindthescenes_tpu_torch import renderer as tr
from behindthescenes_tpu_torch.datasets.factory import make_datasets
from behindthescenes_tpu_torch.datasets.synthetic import collate
from behindthescenes_tpu_torch.evaluation.depth import DepthEvaluator
from behindthescenes_tpu_torch.evaluation.nvs import NVSEvaluator
from behindthescenes_tpu_torch.models.bts import BTSNet
from behindthescenes_tpu_torch.training.trainer import BTSTrainer
from behindthescenes_tpu_torch.weights import load_weights
from test_accuracy_gate import _config as step8400_config
from test_torch_chip_smoke import cs
from test_train_fast_gate import _model_conf as flagship_model_conf

# One intra-op thread: pytest-xdist runs several workers on this CPU,
# and torch's default of a thread per core makes every small op wait
# on threads that the other workers have swapped out.
torch.set_num_threads(1)

WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "media", "weights")
STEP8400 = os.path.join(WEIGHTS, "synthetic_conv_step8400.npz")
FASTANNEAL = os.path.join(WEIGHTS, "fastanneal_conv.npz")


def _within_gap(got: dict, want: dict) -> None:
    for k, w in want.items():
        assert abs(got[k] - w) <= cs.JAX_GAP[k], (k, got[k], w)


def _means(per_scene, keys):
    return {k: float(np.mean([m[k] for m in per_scene])) for k in keys}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_step8400_depth_gate(bf16):
    """tests/test_accuracy_gate.py:57-93 through the port: the trainer's
    eval step (full frames of both views, 24 samples, the depth metrics of
    the first view) on the first 8 test scenes at 48x64, the JAX gate's
    bounds, and within JAX_GAP of the JAX trainer's means on the same
    scenes (each scene's jitter from a generator seeded 0, as JAX's
    default key)."""
    data = {"type": "Synthetic", "image_size": (48, 64), "data_fc": 2,
            "length": 64}
    conf = step8400_config(bf16)
    jtrainer = JTrainer(conf, mesh=make_mesh(jax.devices()[:1]))
    variables = j_load(STEP8400)
    state = TrainState(params=variables["params"],
                       batch_stats=variables["batch_stats"], opt_state=None,
                       step=jnp.asarray(8400))
    _, jds = j_datasets(data)
    want = [jtrainer.eval_step(state, {k: jnp.asarray(v) for k, v in
                                       j_collate([jds[i]]).items()})
            ["metrics"] for i in range(8)]
    want = {k: float(np.mean([float(m[k]) for m in want]))
            for k in ("abs_rel", "a1")}
    trainer = BTSTrainer(conf, device="cpu")
    trainer.init_state(STEP8400)
    assert trainer.net.compute_dtype == (torch.bfloat16 if bf16
                                         else torch.float32)
    _, ds = make_datasets(data)
    got = []
    for i in range(8):
        gen = torch.Generator().manual_seed(0)
        out = trainer.eval_step(collate([ds[i]]), generator=gen)
        got.append({k: float(v) for k, v in out["metrics"].items()})
    got = _means(got, ("abs_rel", "a1"))
    assert got["abs_rel"] < 0.21 and got["a1"] > 0.63, got
    _within_gap(got, want)


def test_step8400_nvs_gate():
    """tests/test_accuracy_gate.py:96-128 through the port's NVSEvaluator:
    view 0 encoded, both views rendered, PSNR and SSIM on the first 4
    test scenes at 48x64 in f32; the JAX gate's bounds, and within
    JAX_GAP of JAX's evaluator on the same scenes."""
    data = {"type": "Synthetic", "image_size": (48, 64), "data_fc": 2,
            "length": 64}
    cfg = step8400_config()
    jev = JNVS(JBTSNet.from_conf(cfg["model_conf"]),
               jr.RendererConfig.from_conf(cfg["renderer"]),
               cfg["model_conf"])
    variables = j_load(STEP8400)
    _, jds = j_datasets(data)
    want = _means([jev.evaluate(variables, j_collate([jds[i]]))
                   for i in range(4)], ("psnr", "ssim"))
    net = load_weights(BTSNet.from_conf(cfg["model_conf"]), STEP8400)
    ev = NVSEvaluator(net, tr.RendererConfig.from_conf(cfg["renderer"]),
                      cfg["model_conf"])
    _, ds = make_datasets(data)
    got = _means([ev.evaluate(collate([ds[i]]),
                              generator=torch.Generator().manual_seed(i))
                  for i in range(4)], ("psnr", "ssim"))
    assert got["psnr"] > 19.8 and got["ssim"] > 0.80, got
    _within_gap(got, want)


@pytest.fixture(scope="module")
def fastanneal():
    """The fastanneal checkpoint on both sides (f32, the flagship model)."""
    mc = flagship_model_conf()
    net = load_weights(BTSNet.from_conf(mc), FASTANNEAL)
    return mc, j_load(FASTANNEAL), net


def test_fastanneal_depth_gate(fastanneal):
    """tests/test_train_anneal_gate.py:37-60 through the port's
    DepthEvaluator (the deterministic self-view ladder, as JAX's): 4
    scenes at 192x640 with 64 samples, abs_rel < 0.213 and a1 > 0.54,
    and within JAX_GAP of JAX's evaluator on the same scenes."""
    mc, variables, net = fastanneal
    rcfg = dict(n_coarse=64, lindisp=True, hard_alpha_cap=True)
    data = {"type": "Synthetic", "image_size": (192, 640), "data_fc": 2,
            "length": 64}
    jev = JDepth(JBTSNet.from_conf(mc), jr.RendererConfig(**rcfg), mc)
    _, jds = j_datasets(data)
    want = _means([jev.evaluate(variables, j_collate([jds[i]]))
                   for i in range(4)], ("abs_rel", "a1"))
    ev = DepthEvaluator(net, tr.RendererConfig(**rcfg), mc)
    _, ds = make_datasets(data)
    got = _means([ev.evaluate(collate([ds[i]])) for i in range(4)],
                 ("abs_rel", "a1"))
    assert got["abs_rel"] < 0.213 and got["a1"] > 0.54, got
    _within_gap(got, want)


def test_fastanneal_nvs_gate(fastanneal):
    """tests/test_train_anneal_gate.py:63-87 through the port's
    NVSEvaluator: 4 scenes at 96x320, 24 coarse + 16 importance-fine
    samples reusing the coarse ones, PSNR > 17.9 and SSIM > 0.70, and
    within JAX_GAP of JAX's evaluator on the same scenes."""
    mc, variables, net = fastanneal
    rcfg = dict(n_coarse=24, n_fine=16, fine_reuse_coarse=True,
                lindisp=True, hard_alpha_cap=True)
    data = {"type": "Synthetic", "image_size": (96, 320), "data_fc": 2,
            "length": 64}
    jev = JNVS(JBTSNet.from_conf(mc), jr.RendererConfig(**rcfg), mc)
    _, jds = j_datasets(data)
    want = _means([jev.evaluate(variables, j_collate([jds[i]]))
                   for i in range(4)], ("psnr", "ssim"))
    ev = NVSEvaluator(net, tr.RendererConfig(**rcfg), mc)
    _, ds = make_datasets(data)
    got = _means([ev.evaluate(collate([ds[i]]),
                              generator=torch.Generator().manual_seed(i))
                  for i in range(4)], ("psnr", "ssim"))
    assert got["psnr"] > 17.9 and got["ssim"] > 0.70, got
    _within_gap(got, want)
