"""chip_smoke.py's step8400 rows of phase 12 and its phase 17, rehearsed on
the CPU (the script itself needs the card; a wrapper call counts as a
launch here):

- eval_synthetic and eval_synthetic_nvs with
  media/weights/synthetic_conv_step8400.npz at the configs' own size (4
  test scenes at 48x64, bf16), held to JAX's means and the JAX gate's bounds
  as on the card; eval_synthetic's shared_z launches at H = 32, each
  held against the plain version;
- phase 17 on the fast configs cut to ResNet-18 at 48x64, 2 items of 256
  rays, from the port's initialiser: the card's step against the host's
  (here the host against itself in float64), the reuse step against the
  re-query step, 6 bf16 steps, and the automasking and patch-processor
  variants.
"""
import pytest
import torch

from test_torch_chip_smoke import (ROOT, _count_calls, _HostClock,  # noqa
                                   cs)

# One intra-op thread: pytest-xdist runs several workers on this CPU,
# and torch's default of a thread per core makes every small op wait
# on threads that the other workers have swapped out.
torch.set_num_threads(1)

STEP8400_RUNS = tuple(r for r in cs.CONFIG_RUNS
                      if r[2] == cs.STEP8400_WEIGHTS)
# Phase 17 cut: the flagship's widths but ResNet-18 at 48x64, 2 items of
# 256 patch rays (the config's 8x8 patches), the samples as configured.
FAST_CUT = ("data.image_size=[48, 64]", "model_conf.encoder.resnet_layers=18",
            "batch_size=2", "model_conf.ray_batch_size=256")


def test_step8400_rows_rehearsed(monkeypatch):
    """Both rows at the configs' own size with the bounds of the card's
    run: within JAX_GAP of the JAX means of tools/step8400_reference.py
    and inside the JAX gate's; eval_synthetic launched shared_z once per
    scene at H = 32 and nothing else (each launch within tolerance of the
    plain version), eval_synthetic_nvs no kernel."""
    _count_calls(monkeypatch, "shared_z")
    monkeypatch.chdir(ROOT)
    assert [r[1] for r in STEP8400_RUNS] == ["eval_synthetic",
                                             "eval_synthetic_nvs"]
    for _, name, ckpt, jax_means in STEP8400_RUNS:
        res = cs.config_phase(name, ckpt, jax_means, "cpu", _HostClock(),
                              frames=1)
        assert len(res["per_scene"]) == 4
        for k in jax_means:
            assert abs(res["gap_" + k]) <= cs.JAX_GAP[k]
        if name == "eval_synthetic":
            assert res["launches"] == {"shared_z": 4, "jitter_density": 0,
                                       "selfview": 0}
            assert len(res["max_abs_err"]) == 4
            assert max(res["max_abs_err"]) <= cs.TOLERANCE["shared_z_bf16"][0]
            args, kwargs = res["launch"]
            assert args[0].dtype == torch.bfloat16
            assert tuple(args[0].shape) == (48 * 64, 32)
            assert cs.shared_z_bf16_piece(32, args[1].shape[0]) == \
                "shared_z_bf16_kernelILi32ELi2E"
        else:
            assert not any(res["launches"].values())
            assert "frame_ms" in res


def test_step8400_gates_fail_the_run(monkeypatch):
    """A depth mean outside the JAX gate fails the row."""
    _count_calls(monkeypatch, "shared_z")
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(cs, "DEPTH_GATES",
                        {"eval_synthetic": {"abs_rel": 0.1, "a1": 0.63}})
    _, name, ckpt, jax_means = STEP8400_RUNS[0]
    with pytest.raises(AssertionError, match="abs_rel"):
        cs.config_phase(name, ckpt, jax_means, "cpu", _HostClock())


@pytest.fixture(scope="module")
def fast_weights(tmp_path_factory):
    """The cut fast model from the port's initialiser, as a checkpoint."""
    from behindthescenes_tpu_torch import train as train_cli
    from behindthescenes_tpu_torch.training.trainer import BTSTrainer
    from behindthescenes_tpu_torch.weights import save_params_npz
    conf = train_cli.config(cs.FAST_CONFIGS[0], overrides=FAST_CUT)
    trainer = BTSTrainer(conf, device="cpu")
    trainer.init_state()
    path = str(tmp_path_factory.mktemp("weights") / "fast.npz")
    save_params_npz(path, trainer.net.state_dict())
    return path


def test_fast_draws_carry_the_fine_pass():
    """numpy_draws gives the fine pass its draws as the renderer takes
    them: 16 importance uniforms for _fast, 8 and 8 normals for _fast2,
    after the coarse draws of the configs without a fine pass."""
    from behindthescenes_tpu_torch import train as train_cli
    conf = train_cli.config(cs.FAST_CONFIGS[0], overrides=FAST_CUT)
    batch = cs.train_batch(conf)
    draws = cs.numpy_draws(conf, batch, cs.TRAIN_SEED)
    assert draws.fine.u.shape == draws.fine.jitter.shape == (2, 256, 16)
    assert draws.fine.normals is None and draws.z_jitter.shape[-1] == 24
    conf2 = train_cli.config(cs.FAST_CONFIGS[1], overrides=FAST_CUT)
    d2 = cs.numpy_draws(conf2, batch, cs.TRAIN_SEED)
    assert d2.fine.u.shape == (2, 256, 8) == d2.fine.normals.shape
    flat = train_cli.config("exp_synthetic_flagship", overrides=FAST_CUT)
    d0 = cs.numpy_draws(flat, batch, cs.TRAIN_SEED)
    assert d0.fine is None
    assert torch.equal(d0.rays.views, draws.rays.views)
    tb, td = cs.on_device(batch, d2, "cpu", torch.float64)
    assert td.fine.normals.dtype == td.z_jitter.dtype == torch.float64


def test_fast_training_phase_rehearsed(fast_weights, capsys):
    """Phase 17 at FAST_CUT with 6 steps: every check of the card's run
    holds with the host in the card's place, losses fall, every stage is
    timed, and the lines the card prints are there."""
    res = cs.fast_training_phase("cpu", "host", _HostClock,
                                 weights=fast_weights, overrides=FAST_CUT,
                                 steps=6, timed_from=2)
    for name in cs.FAST_CONFIGS:
        r = res[name]
        assert r["parity"]["loss_rel"] <= cs.LOSS_RTOL
        assert r["reuse_vs_requery"]["loss_rel"] <= cs.REUSE_LOSS_RTOL
        assert r["bf16"]["losses"][-1] < r["bf16"]["losses"][0]
        assert set(r["bf16"]["median_ms"]) == set(cs.STAGES) | {"step"}
    assert res[cs.FAST_CONFIGS[1]]["renderer"]["n_fine_depth"] == 8
    assert set(res["variants"]) == set(cs.FAST_VARIANTS)
    out = capsys.readouterr().out
    for name in cs.FAST_CONFIGS:
        assert f"{name} train bf16 (host)" in out
    assert "with automasking f32 step" in out
    assert "with patch processor f32 step" in out
