"""chip_smoke.py's phases 27 and 28 rehearsed on the CPU at a cut size
(the script itself needs the card; a wrapper call counts as a launch
here), on a small gate drive (the port's `make_gate_tree` at an eighth of
the reference resolution, 8 frames, keyframes 2 and 5, the fisheye
frames at rotation [0, -15]) read at 32x96 from the raw frames:

- phase 27: `-cn eval_kitti_360_depth` and `-cn eval_kitti_360_nvs`
  through `k360_eval_phase` (JAX's means and the gaps are those of the
  full size, so they move out of the way): the depth config's shared_z
  launches, one a keyframe on a frame's rays, each held to the plain
  version; the NVS config's none; both frames split;
- phase 28: the three video scripts through `video_phase`, each AVI read
  back, gen_vid_seq's jitter_density launches held to the plain version,
  each frame's stages timed.
"""
import pytest
import torch

from behindthescenes_tpu_torch.datasets.gen_synthetic_kitti_360 import \
    make_gate_tree
from test_torch_chip_smoke import ROOT, _count_calls, _HostClock, cs

# One intra-op thread: pytest-xdist runs several workers on this CPU,
# and torch's default of a thread per core makes every small op wait
# on threads that the other workers have swapped out.
torch.set_num_threads(1)

CUT = ("data.image_size=[32, 96]", "data.is_preprocessed=false")
KEYFRAMES = (2, 5)


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    return str(make_gate_tree(tmp_path_factory.mktemp("gate") / "tree",
                              frames=8, scale=0.125, keyframes=KEYFRAMES,
                              fisheye_rotation=(0, -15)))


@pytest.fixture
def counted(monkeypatch):
    monkeypatch.chdir(ROOT)
    for name in ("jitter_density", "selfview", "shared_z"):
        _count_calls(monkeypatch, name)


def test_k360_eval_phase_rehearsed(drive, counted, monkeypatch, capsys):
    monkeypatch.setattr(cs, "JAX_GAP", dict.fromkeys(cs.JAX_GAP, 1e9))
    monkeypatch.setattr(cs, "KRAW_LAUNCH_SHAPE", (32 * 96, 64))
    out, launch = cs.k360_eval_phase(drive, "cpu", "host", _HostClock,
                                     extra=CUT)
    depth = out["eval_kitti_360_depth"]
    assert depth["launches"] == {"shared_z": len(KEYFRAMES),
                                 "jitter_density": 0, "selfview": 0}
    assert max(depth["max_abs_err"]) <= cs.TOLERANCE["shared_z_bf16"][0]
    assert set(depth["frame_ms"]) == {"encode", "render", "frame"}
    args, _ = launch
    assert (args[0].shape[0], args[1].shape[0]) == (32 * 96, 64)
    assert args[0].dtype == torch.bfloat16
    nvs = out["eval_kitti_360_nvs"]
    assert not any(nvs["launches"].values())
    assert {"encode", "render", "frame"} <= set(nvs["frame_ms"])
    assert len(nvs["per_scene"]) == len(KEYFRAMES)
    printed = capsys.readouterr().out
    for name in ("eval_kitti_360_depth", "eval_kitti_360_nvs"):
        assert f"{name} on the gate drive (host)" in printed


def test_video_phase_rehearsed(drive, counted, capsys):
    out, launch = cs.video_phase(drive, "cpu", "host", extra=CUT, poses=3)
    assert out["gen_vid_nvs"]["frames"] == 3
    assert out["gen_vid_nvs"]["size"] == [32, 192]
    assert out["gen_vid_transition"]["size"] == [32, 96]
    seq = out["gen_vid_seq"]
    assert seq["frames"] == len(KEYFRAMES) and seq["size"] == [32, 288]
    assert seq["launches"] == {"jitter_density": len(KEYFRAMES),
                               "selfview": 0, "shared_z": 0}
    assert max(seq["max_abs_err"]) <= cs.TOLERANCE["jitter_density"][0]
    assert seq["launch_shapes"] == [[32 * 96, 64]] * len(KEYFRAMES)
    assert launch[0][1].dtype == torch.bfloat16
    for script in ("gen_vid_nvs", "gen_vid_transition", "gen_vid_seq"):
        assert {"encode", "jpeg", "frame"} <= set(out[script]["ms_per_frame"])
    assert "render" in out["gen_vid_nvs"]["ms_per_frame"]
    assert {"render_depth", "render_profile"} <= set(seq["ms_per_frame"])
    printed = capsys.readouterr().out
    for script in ("gen_vid_nvs", "gen_vid_transition", "gen_vid_seq"):
        assert f"{script} -cn exp_kitti_360 (host)" in printed
