"""chip_smoke.py's phase 16 (the exp_kitti_360 training run) rehearsed on
the CPU at a cut size, and its bookkeeping: the checkpoint steps the JAX
harness's rules give, and the torchvision-keyed ResNet-50 it writes. (The
script itself needs the card; its contract is checked there.)"""
import os

from test_torch_chip_smoke import (CUT_EXTRA, ROOT, _cut, _HostClock,
                                   cs, gate_tree_cut)  # noqa: F401

# The cut gate drive at 32x96, 2 items of 8 views a micro-step, 64 rays of 8
# samples, f32; runs of 6 and 8 micro-steps (accumulate_steps 4 from the
# config), a checkpoint every 2, a validation every 3; no TensorBoard
# writer (importing it here pulls in TensorFlow).
K360_CUT_RUN = {"stops": (6, 8), "checkpoint_every": 2, "validate_every": 3,
                "timed_from": 1}
K360_CUT_EXTRA = CUT_EXTRA + ("batch_size=2", "model_conf.ray_batch_size=64",
                              "renderer.n_coarse=8", "bf16=false",
                              "num_workers=2", "tensorboard=false")


def test_k360_training_phase_rehearsed(gate_tree_cut, monkeypatch, capsys):
    """Phase 16 as main() runs it, at the cut: the encoder from the
    torchvision-keyed `.pth` equal to the checkpoint's, parameters put on
    the micro-steps that emit no update, checkpoints 2, 4, 6 after the
    first run and 4, 6, 8 after the second process resumed at 7, the state
    restored at 6 bit-equal with its half-filled accumulator, the best
    value carried over, no decode kernel, every stage of each micro-step
    timed. JAX's validation means are those of the full size, so their
    bound moves out of the way."""
    _cut(monkeypatch)
    monkeypatch.setattr(cs, "K360_RUN", K360_CUT_RUN)
    monkeypatch.setattr(cs, "K360_VAL_GAP",
                        dict.fromkeys(cs.K360_VAL_GAP, 1e9))
    res = cs.k360_training_phase(gate_tree_cut, "cpu", "host", _HostClock,
                                 extra=K360_CUT_EXTRA)
    assert res["checkpoints"] == [4, 6, 8]
    assert res["restored_mini_step"] == 2
    assert len(res["losses"]) == 6 and len(res["second_losses"]) == 2
    assert set(res["median_stage_ms"]) == set(cs.RUN_POINTS[2:])
    assert len(res["update_ms"]) == 1 and len(res["checkpoint_save_ms"]) == 3
    assert not any(res["launches"].values())
    assert set(cs.K360_VAL_JAX) <= set(res["validation"])
    assert set(res["cached_median_ms"]) == set(cs.STAGES) | {"micro_step"}
    assert res["loader_item_host_ms"] > 0
    assert res["loader_item_no_jitter_host_ms"] > 0
    cs.print_k360_run(res, "host")
    assert "exp_kitti_360 micro-step (host)" in capsys.readouterr().out


def test_expected_run_steps_follow_the_jax_rules():
    """Saves every `every` micro-steps and at each stop, none twice, the
    newest three kept: the phase's own run leaves 10, 20, 30 and then
    20, 30, 40; a stop off the grid is saved too."""
    assert cs.expected_run_steps((30, 40), 10) == ([10, 20, 30],
                                                   [20, 30, 40])
    assert cs.expected_run_steps((25, 40), 10) == ([10, 20, 25],
                                                   [25, 30, 40])


def test_k360_run_writes_loadable_reference_files(tmp_path):
    """The phase's torchvision-keyed ResNet-50 holds every encoder tensor
    of K360_WEIGHTS under torchvision's names, and fc."""
    sd = cs.torchvision_resnet_state_dict(os.path.join(ROOT,
                                                       cs.K360_WEIGHTS))
    assert sd["conv1.weight"].shape == (64, 3, 7, 7)
    assert sd["layer4.2.conv3.weight"].shape == (2048, 512, 1, 1)
    assert sd["fc.weight"].shape == (1000, 2048)
    assert not any(k.startswith("encoder") for k in sd)
