"""chip_smoke.py's phases 18-20 (KITTI raw depth, exp_kitti_raw training,
RealEstate10K NVS and exp_re10k training) rehearsed on the CPU at a cut
size: the trees built by the generators' command lines, the benchmarks
through the task runner with their launches counted and held against the
plain version, the frame and loader splits, and the training runs with
their micro-step splits. (The script itself needs the card; its contract
is checked there.)"""
import torch
from test_torch_chip_smoke import ROOT, _count_calls, _HostClock, cs

# One intra-op thread: pytest-xdist runs several workers on this CPU,
# and torch's default of a thread per core makes every small op wait
# on threads that the other workers have swapped out.
torch.set_num_threads(1)

TREE_ARGS = {
    "gen_synthetic_kitti_raw": ("--frames", "6", "--size", "94", "311",
                                "--keyframes", "2", "3", "--workers", "1"),
    "gen_synthetic_re10k": ("--frames", "14", "--size", "36", "64",
                            "--keyframes", "0", "2", "--workers", "1"),
}
EVAL_EXTRA = {"eval_depth": ("data.image_size=[32, 96]", "num_workers=0"),
              "eval_nvs": ("data.image_size=[32, 48]", "renderer.n_coarse=8",
                           "num_workers=0")}
TRAIN_CUT = ("batch_size=2", "model_conf.ray_batch_size=64",
             "renderer.n_coarse=8", "num_workers=1", "tensorboard=false")
TRAIN_EXTRA = {"exp_kitti_raw": ("data.image_size=[32, 96]", *TRAIN_CUT),
               "exp_re10k": ("data.image_size=[32, 48]", *TRAIN_CUT)}
TRAIN_RUNS = (("19", "exp_kitti_raw", cs.K360_WEIGHTS, 2, 0),
              ("20", "exp_re10k", cs.RE10K_WEIGHTS, 2, 0))


def test_disk_phases_rehearsed(monkeypatch, capsys):
    """Phases 18-20 as main() runs them, at the cut: eval_depth launches
    shared_z once per keyframe on a frame's rays at H = 64, each launch
    within tolerance of the plain version; eval_nvs and both training
    runs launch nothing; every split is filled and printed. JAX's means
    and the floors are those of the full size, so they move out of the
    way."""
    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for name in ("jitter_density", "selfview", "shared_z"):
        _count_calls(monkeypatch, name)
    monkeypatch.setattr(cs, "JAX_GAP", dict.fromkeys(cs.JAX_GAP, 1e9))
    monkeypatch.delitem(cs.DEPTH_GATES, "eval_depth")
    monkeypatch.delitem(cs.NVS_FLOORS, "eval_nvs")
    monkeypatch.setattr(cs, "KRAW_LAUNCH_SHAPE", (32 * 96, 64))
    out, (args, kwargs) = cs.disk_phases(
        "cpu", "host", _HostClock, tree_args=TREE_ARGS,
        eval_extra=EVAL_EXTRA, train_extra=TRAIN_EXTRA,
        train_runs=TRAIN_RUNS)
    depth, nvs = out["eval_depth"], out["eval_nvs"]
    assert depth["launches"]["shared_z"] == 2
    assert sum(depth["launches"].values()) == 2
    assert len(depth["max_abs_err"]) == 2
    assert max(depth["max_abs_err"]) <= cs.TOLERANCE["shared_z_bf16"][0]
    assert args[0].shape == (32 * 96, 64) and args[1].shape[0] == 64
    assert args[0].dtype == torch.bfloat16
    assert set(depth["frame_ms"]) == {"encode", "render", "frame"}
    assert depth["loader"]["reads"] == 4
    assert depth["loader"]["velodyne_ms"] > 0
    assert not any(nvs["launches"].values())
    assert "velodyne_ms" not in nvs["loader"]
    for name in ("exp_kitti_raw", "exp_re10k"):
        res = out[name]
        assert len(res["losses"]) == 2 and not any(res["launches"].values())
        assert set(res["median_stage_ms"]) == set(cs.RUN_POINTS[2:])
        assert res["loader"]["item_ms"] > 0
    assert out["exp_kitti_raw"]["loader"]["reads"] == 4
    assert out["exp_re10k"]["loader"]["reads"] == 3
    assert out["gen_synthetic_kitti_raw_tree"]["velodyne"] > 0
    nbytes, flops = cs.work("shared_z_bf16", args, kwargs)
    assert nbytes > 0 and sum(flops.values()) > 0
    printed = capsys.readouterr().out
    for line in ("eval_depth on the synthetic tree (host)",
                 "eval_depth frame (host)", "eval_nvs frame (host)",
                 "exp_kitti_raw micro-step (host)",
                 "exp_re10k micro-step (host)", "phase 18 tree",
                 "phase 20 tree"):
        assert line in printed, line
