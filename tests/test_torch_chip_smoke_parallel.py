"""chip_smoke.py's phase 24 (two ranks on torch.distributed against one)
rehearsed on the CPU: gloo with both ranks on the host, phase 7's step on
exp_synthetic (ResNet-18 at 48x64, 2 items: one a rank) from the port's
initialiser, the flagship checkpoint's general-path depth on two gate
scenes at 48x64, the flagship NVS config at 24x32, and the LiDAR runs on
a cut gate drive (one keyframe at 32x96). The phase's own bounds hold;
the kernels' launches are not counted (on the CPU a wrapper runs its
plain version)."""
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

# One intra-op thread: pytest-xdist runs several workers on this CPU.
torch.set_num_threads(1)

CUT_FRAMES = 6
CUT_RUNS = tuple((phase, name, split, (2,), overrides, record)
                 for phase, name, split, _, overrides, record
                 in cs.OCC_RUNS[:2])
CUT_EXTRA = ("data.image_size=[32, 96]", "data.is_preprocessed=false")
NVS_CUT = ("data.image_size=[24, 32]", "data.length=2")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    from behindthescenes_tpu_torch import train as train_cli
    from behindthescenes_tpu_torch.datasets.gen_synthetic_kitti_360 import \
        make_gate_tree
    from behindthescenes_tpu_torch.datasets.synthetic import (
        collate, make_test_dataset)
    from behindthescenes_tpu_torch.training.trainer import BTSTrainer
    from behindthescenes_tpu_torch.weights import save_params_npz
    conf = train_cli.config("exp_synthetic", f32=True)
    trainer = BTSTrainer(conf, device="cpu")
    trainer.init_state()
    weights = str(tmp_path_factory.mktemp("weights") / "init.npz")
    save_params_npz(weights, trainer.net.state_dict())
    batch = cs.train_batch(conf)
    ds = make_test_dataset(image_size=(48, 64))
    tree = str(make_gate_tree(tmp_path_factory.mktemp("gate") / "tree",
                              frames=CUT_FRAMES, scale=0.125,
                              keyframes=(2,)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cs, "OCC_RUNS", CUT_RUNS)
        cs.write_occupancy_splits(tree, CUT_FRAMES)
    return (conf, weights, batch, cs.numpy_draws(conf, batch, cs.TRAIN_SEED),
            [collate([ds[i]]) for i in range(2)], tree)


def test_parallel_phase_rehearsed(inputs, capsys, monkeypatch):
    """Phase 24 as main() runs it, at the cut: world 2 within every bound
    of world 1, the ranks' parameters bit-equal, every evaluator sharded,
    and the printed line names the backend, the world and the card
    count."""
    monkeypatch.chdir(ROOT)
    conf, weights, batch, draws, scenes, tree = inputs
    res = cs.parallel_phase(
        "cpu", "host", conf, weights, batch, draws, scenes, tree,
        nvs=(cs.PARALLEL_NVS[0], cs.WEIGHTS, cs.PARALLEL_NVS[1] + NVS_CUT),
        occ_runs=CUT_RUNS, occ_extra=CUT_EXTRA,
        layout=("gloo", ["cpu", "cpu"], "gloo on the host"), timed=4,
        count_launches=False, threads=1)
    print(out := capsys.readouterr().out)
    assert "phase 24 backend gloo, world 2, cuda device count 0" in out
    assert res["world"] == 2 and res["backend"] == "gloo"
    gaps = res["gaps"]
    assert gaps["loss_rel"] <= cs.PARALLEL_LOSS_RTOL
    assert gaps["grad_over_bound"] <= 1.0
    assert gaps["occupancy"] <= cs.PARALLEL_OCC_ATOL
    assert set(res["bf16_step_ms"]) == {"world 1", "world 2 rank 0",
                                        "world 2 rank 1"}
    for split in res["bf16_step_ms"].values():
        assert set(split) == {*cs.STAGES, "step"}
    assert len(res["launches_per_rank"]) == 2


def test_parallel_compare_fails_on_a_sliced_gradient():
    """parallel_compare refuses a rank whose gradient is half the world-1
    gradient (a missing reduction), and one whose parameters differ from
    rank 0's."""
    g = {"w": torch.tensor([1.0, -2.0, 3.0])}
    state = {"w": torch.tensor([0.5, 0.5, 0.5])}
    one = {"step": {"loss": 1.0, "grads": g, "state": state,
                    "launches": {}},
           "nudged": {"grads": g}, "depth": [], "nvs": [], "occupancy": []}

    def rank(grads, st):
        return {"step": {"loss": 1.0, "grads": grads, "state": st,
                         "launches": {}},
                "depth_sharded": True, "nvs_sharded": True, "depth": [],
                "nvs": [], "occupancy": []}
    cs.parallel_compare(one, [rank(g, state), rank(g, state)], 1e-4, True)
    with pytest.raises(AssertionError, match="gradient"):
        cs.parallel_compare(one, [rank({"w": g["w"] / 2}, state)], 1e-4,
                            True)
    with pytest.raises(AssertionError, match="rank 0"):
        cs.parallel_compare(one, [rank(g, state),
                                  rank(g, {"w": state["w"] + 1e-7})],
                            1e-4, True)
