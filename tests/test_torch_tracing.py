"""The port's spans and counters (`behindthescenes_tpu_torch/tracing.py`)
on the CPU: the off path never reaches the profiler, the marks keep
their names and order, the spans tile each micro-step and depth frame
in a profiler trace, the host-to-device copies per micro-step and per
frame are pinned, and the kernel wrappers count into the registry.

The model is the KITTI-360 training configuration's structure (z code,
0-block MLP, lindisp, 8 views an item in the kitti360-mono sampling,
patch rays, flip augmentation, accumulation) at a CPU's size: ResNet-18,
32x96 images, 2 items, 128 rays of 8 samples.
"""
import numpy as np
import pytest
import torch

from behindthescenes_tpu_torch import renderer as renderer_lib
from behindthescenes_tpu_torch import tracing
from behindthescenes_tpu_torch.evaluation.depth import DepthEvaluator
from behindthescenes_tpu_torch.ops import kernels
from behindthescenes_tpu_torch.ops.kernels.shared_z import (
    shared_z_tail, shared_z_tail_plain)
from behindthescenes_tpu_torch.training.trainer import (TRAIN_STAGES,
                                                        BTSTrainer)

# One intra-op thread: pytest-xdist runs several workers on this CPU.
torch.set_num_threads(1)

N, V, H, W = 2, 8, 32, 96
CONF = {
    "seed": 3, "bf16": False, "batch_size": N, "accumulate_steps": 2,
    "learning_rate": 1e-4, "scheduler": {"type": "fix"},
    "model_conf": {
        "arch": "BTSNet", "use_code": True, "prediction_mode": "default",
        "code": {"num_freqs": 6, "freq_factor": 1.5, "include_input": True},
        "encoder": {"type": "monodepth2", "freeze": False,
                    "pretrained": False, "resnet_layers": 18,
                    "num_ch_dec": [32, 32, 64, 128, 256], "d_out": 64,
                    "scales": [0]},
        "mlp_coarse": {"type": "resnet", "n_blocks": 0, "d_hidden": 64},
        "mlp_fine": {"type": "empty"},
        "z_near": 3, "z_far": 80, "inv_z": True, "n_frames_encoder": 1,
        "n_frames_render": 2, "frame_sample_mode": "kitti360-mono",
        "sample_mode": "patch", "patch_size": 8, "ray_batch_size": 128,
        "flip_augmentation": True, "learn_empty": False, "code_mode": "z",
        "depth_scaling": None},
    "loss": {"criterion": "l1+ssim", "invalid_policy": "weight_guided",
             "lambda_edge_aware_smoothness": 0.001},
    "renderer": {"n_coarse": 8, "n_fine": 0, "n_fine_depth": 0,
                 "depth_std": 1.0, "sched": [], "white_bkgd": False,
                 "lindisp": True, "hard_alpha_cap": True},
}
# Host data made into tensors on the model's device (`tracing.to_device`):
# a micro-step after the first, a depth frame. On the card each is one
# pageable host-to-device copy the stream waits for.
H2D_PER_STEP = 6
H2D_PER_FRAME = 10


def _batch(seed):
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (N, V, 1, 1))
    poses[:, :, 0, 3] = rng.uniform(-1, 1, (N, V))
    projs = np.tile(np.array([[0.78, 0, 0], [0, 2.9, 0.27], [0, 0, 1]],
                             dtype=np.float32), (N, V, 1, 1))
    imgs = rng.uniform(-1, 1, (N, V, H, W, 3)).astype(np.float32)
    return {k: torch.from_numpy(v)
            for k, v in (("imgs", imgs), ("poses", poses),
                         ("projs", projs))}


@pytest.fixture(scope="module")
def trainer():
    t = BTSTrainer(CONF, device="cpu")
    t.init_state()
    return t


@pytest.fixture(scope="module")
def evaluator(trainer):
    cfg = renderer_lib.RendererConfig.from_conf(CONF["renderer"])
    return DepthEvaluator(trainer.net.eval(), cfg, CONF["model_conf"])


def _frame(evaluator, mark=None):
    b = _batch(11)
    return evaluator.render(b["imgs"][:1, :1], b["projs"][:1, :1],
                            torch.eye(4)[None, None], mark=mark)


@pytest.fixture()
def no_record_function(monkeypatch):
    """torch.profiler.record_function made to raise, as the port reaches
    it (tracing off must never create one)."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function created with tracing off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not tracing.enabled()


def test_off_path_creates_no_record_function(trainer, evaluator,
                                             no_record_function):
    trainer.net.train()
    trainer.train_step(_batch(1))
    _frame(evaluator)
    seen = []
    trainer.train_step(_batch(2), mark=seen.append)
    _frame(evaluator, mark=seen.append)
    with tracing.span("data_wait"):
        pass
    assert seen == list(TRAIN_STAGES) + ["encode", "render"]


def test_marks_keep_their_names_and_order(trainer, evaluator):
    for on in (False, True):
        tracing.enable(on)
        try:
            seen = []
            trainer.train_step(_batch(3), mark=seen.append)
            assert seen == ["encode", "render", "loss", "backward",
                            "optimizer"]
            seen.clear()
            _frame(evaluator, mark=seen.append)
            assert seen == ["encode", "render"]
        finally:
            tracing.enable(False)


def _annotations(prof):
    """The profiler's record_function events: (name, start, end) in us,
    in order of start (longer first at a tie)."""
    out = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events()
           if e.name in ("train_step", "depth_frame") + TRAIN_STAGES]
    return sorted(out, key=lambda t: (t[1], -t[2]))


def _check_tiled(notes, root, stages, count):
    roots = [n for n in notes if n[0] == root]
    assert len(roots) == count
    for name, r0, r1 in roots:
        kids = [n for n in notes if n[0] != root and r0 <= n[1]
                and n[2] <= r1]
        assert [k[0] for k in kids] == list(stages)
        # Back to back from the root's start to its end: between two
        # stages only the mark's call, a few us.
        assert kids[0][1] - r0 < 200
        for a, b in zip(kids, kids[1:]):
            assert 0 <= b[1] - a[2] < 200
        assert 0 <= r1 - kids[-1][2] < 200


def test_spans_tile_each_step_and_frame(trainer, evaluator):
    from torch.profiler import ProfilerActivity, profile
    tracing.enable(True)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for i in range(2):
                trainer.train_step(_batch(4 + i))
            for _ in range(3):
                _frame(evaluator)
    finally:
        tracing.enable(False)
    notes = _annotations(prof)
    _check_tiled([n for n in notes if n[0] != "depth_frame"], "train_step",
                 TRAIN_STAGES, 2)
    frames = [n for n in notes if n[0] == "depth_frame"]
    t0 = frames[0][1]
    _check_tiled([n for n in notes if n[1] >= t0], "depth_frame",
                 ("encode", "render"), 3)


def test_host_to_device_copies_are_pinned(trainer, evaluator):
    trainer.train_step(_batch(6))
    per_step = []
    for i in range(3):
        tracing.reset()
        trainer.train_step(_batch(7 + i))
        per_step.append(tracing.counters()["h2d_copies"])
    per_frame = []
    for _ in range(3):
        tracing.reset()
        _frame(evaluator)
        per_frame.append(tracing.counters()["h2d_copies"])
    assert per_step == [H2D_PER_STEP] * 3
    assert per_frame == [H2D_PER_FRAME] * 3
    assert tracing.counters()["h2d_bytes"] > 0


def test_launch_counts_read_the_registry():
    """The wrappers count a launch where they launch (on the card); on the
    CPU the plain version runs and nothing is counted, and launch_counts
    reads whatever the registry holds."""
    rng = np.random.default_rng(0)
    hs = torch.from_numpy(rng.normal(size=(5, 16)).astype(np.float32))
    hd = torch.from_numpy(rng.normal(size=(3, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(16, 1)).astype(np.float32))
    b = torch.zeros(1)
    kernels.reset_launch_counts()
    torch.testing.assert_close(shared_z_tail(hs, hd, w, b),
                               shared_z_tail_plain(hs, hd, w, b))
    assert kernels.launch_counts() == {"shared_z": 0, "jitter_density": 0,
                                       "selfview": 0}
    tracing.count("launches.shared_z", 2)
    tracing.count("launches.selfview")
    tracing.count("h2d_copies")
    assert kernels.launch_counts() == {"shared_z": 2, "jitter_density": 0,
                                       "selfview": 1}
    kernels.reset_launch_counts()
    assert kernels.launch_counts()["shared_z"] == 0
    assert tracing.counters()["h2d_copies"] >= 1


def test_off_span_is_shared_and_stages_keep_their_order():
    assert tracing.span("a") is tracing.span("b")
    marks = []
    with tracing.span("encode", marks.append):
        pass
    assert marks == ["encode"]
    with pytest.raises(ValueError, match="out of order"):
        tracing.enable(True)
        try:
            with tracing.stages("train_step", ("encode", "render")) as mark:
                mark("render")
        finally:
            tracing.enable(False)


def test_profiled_run_traces_the_spans_and_logs_the_counters(tmp_path):
    """The run harness with profile_dir: iterations profile_steps[0] to
    profile_steps[1] (left out) run under the profiler with the port's
    spans on, so its trace holds a train_step and a data_wait for each;
    the counters over them are logged at the stop, and the spans are
    off again after."""
    import glob
    import json
    import logging

    from behindthescenes_tpu_torch.training import harness
    from behindthescenes_tpu_torch.training.tasks import bts_get_dataflow
    conf = {
        "name": "tracing_test", "model": "bts", "seed": 0, "bf16": False,
        "output_path": str(tmp_path / "run"), "batch_size": 2,
        "num_workers": 0, "num_epochs": 5, "stop_iteration": 4,
        "validate_every": 1000, "visualize_every": 1000,
        "checkpoint_every": 1000, "log_every_iters": 1000,
        "tensorboard": False, "learning_rate": 1e-3,
        "profile_dir": str(tmp_path / "profile"), "profile_steps": [1, 3],
        "data": {"type": "Synthetic", "image_size": (24, 32), "data_fc": 2,
                 "length": 8},
        "model_conf": {
            "arch": "BTSNet", "z_near": 1.0, "z_far": 40.0, "inv_z": True,
            "learn_empty": False,
            "encoder": {"type": "dummy", "size": (24, 32), "d_out": 16},
            "code": {"num_freqs": 4, "freq_factor": 1.5},
            "mlp_coarse": {"type": "resnet", "n_blocks": 0, "d_hidden": 32},
            "mlp_fine": {"type": "empty"}, "n_frames_render": 2,
            "frame_sample_mode": "default", "sample_mode": "patch",
            "patch_size": 4, "ray_batch_size": 64,
            "prediction_mode": "default", "flip_augmentation": False},
        "loss": {"criterion": "l1+ssim", "invalid_policy": "weight_guided"},
        "renderer": {"n_coarse": 8, "lindisp": True, "hard_alpha_cap": True},
        "scheduler": {"type": "fix"},
    }
    logged = []
    handler = logging.Handler()
    handler.emit = lambda record: logged.append(record.getMessage())
    log = logging.getLogger("bts_torch")
    level = log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        harness.base_training(conf, bts_get_dataflow, device="cpu")
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    assert not tracing.enabled()
    [path] = glob.glob(str(tmp_path / "profile" / "*.json"))
    with open(path) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"]
    assert names.count("train_step") == 2 and names.count("data_wait") == 2
    assert all(names.count(s) == 2 for s in TRAIN_STAGES)
    [stop] = [m for m in logged if "profiler trace written" in m]
    assert "'h2d_copies'" in stop
