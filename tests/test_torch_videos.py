"""The port's video scripts (`python -m behindthescenes_tpu_torch.scripts.
gen_vid_nvs`, `gen_vid_transition`, `gen_vid_seq`) against the JAX
scripts (scripts/videos/*.py), and the port's Motion-JPEG writer
(utils/video.py) against OpenCV's reader.

Both sides run on the converged exp_synthetic checkpoint at 48x64 with
tests/test_media_scripts.py's lengths (3 poses, 3 transition frames,
items 0-1), bf16 as both scripts compute. The JAX scripts run as that
test runs them (load_script and sys.argv); their frames are caught
before encoding by replacing the loaded module's `write_video`. The port
is given JAX's draws (each pose's coarse jitter and fine draws from
PRNGKey(i), each item's depth jitter from PRNGKey(idx)), so only the two
bf16 encoders' rounding (features 2.9e-3 apart at this size,
tests/test_torch_inference_extra.py) separates the frames.
"""
import os
import sys

import cv2
import jax
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation, Slerp

from behindthescenes_tpu import config as jconfig
from behindthescenes_tpu import renderer as jrenderer
from behindthescenes_tpu.utils.io import load_params_npz as j_load_npz
from behindthescenes_tpu_torch import geometry
from behindthescenes_tpu_torch.scripts import (gen_vid_nvs, gen_vid_seq,
                                               gen_vid_transition)
from behindthescenes_tpu_torch.scripts import inference_setup as iset
from behindthescenes_tpu_torch.utils import video
from test_media_scripts import REPO, load_script
from test_torch_fine import jax_render_draws

# One intra-op thread: pytest-xdist runs several workers on this CPU,
# and torch's default of a thread per core makes every small op wait
# on threads that the other workers have swapped out.
torch.set_num_threads(1)

STEP8400 = os.path.join(REPO, "media", "weights",
                        "synthetic_conv_step8400.npz")
H, W = 48, 64
# Frames of the same draws, bf16 encoders on both sides. The RGB and
# depth panels: every channel value within PANEL_ATOL (measured: RGB
# within 4.6e-3, depth within 9.6e-3, one step of the colormap). The BEV
# profile panel, which takes no draws and whose cells may cross the
# visibility cutoff: each value within FRAME_ATOL in at least FRAME_SHARE
# of the panel and none further than FRAME_MAX (measured: 99.79% within
# 1e-2, at most 0.065 apart).
PANEL_ATOL = 1e-2
FRAME_ATOL, FRAME_SHARE, FRAME_MAX = 1e-2, 0.99, 0.25
# The transition's RGB away from the keyframe camera's border pixels
# (measured 4.5e-6): the colour is the source image's, bf16 moves only
# the weights.
TRANSITION_ATOL = 1e-4


def _jax_frames(monkeypatch, rel_path, *args):
    """The JAX script's frames before encoding, on the step8400
    checkpoint."""
    mod = load_script(rel_path)
    caught = {}

    def write_video(path, frames, fps=10):
        caught["frames"] = [np.asarray(f) for f in frames]
        caught["fps"] = fps
    monkeypatch.setattr(mod, "write_video", write_video)
    # For an .npz the JAX harness returns the file's variables and
    # discards the template of its eager net.init.
    monkeypatch.setattr(mod.iset, "load_eval_variables",
                        lambda config, net, batch: j_load_npz(
                            config["checkpoint"]))
    monkeypatch.setattr(sys, "argv", [os.path.basename(rel_path), *args,
                                      "--checkpoint", STEP8400])
    monkeypatch.chdir(REPO)
    mod.main()
    return caught


def _jax_rcfg():
    conf = jconfig.load_config(jconfig.find_config("exp_synthetic"))
    return jrenderer.RendererConfig.from_conf(conf.get("renderer", {})), \
        conf["model_conf"]


def _pose_draws(i):
    """The draws of the JAX script's render_poses under PRNGKey(i): one
    chunk of H x W rays (render_rays_chunked's default chunk holds it)."""
    z, fine = jax_render_draws(jax.random.PRNGKey(i), 1, H * W,
                               _jax_rcfg()[0])
    return {"z_jitter": z, "fine_draws": fine}


def _profile_close(got, want, label):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    diff = np.abs(got - want)
    share = float(np.mean(diff <= FRAME_ATOL))
    assert share >= FRAME_SHARE and diff.max() <= FRAME_MAX, (
        label, share, float(diff.max()))


def _port_args(module, *args):
    return module.parse_args([*args, "--checkpoint", STEP8400,
                              "--device", "cpu"])


def _check_avi(module, args, frames, tmp_path):
    """The port's writer on the frames: the AVI reads back through
    OpenCV's own MJPEG reader and through read_video, the same count,
    size and pixels, each frame within JPEG's loss of the written
    pixels."""
    args.out = str(tmp_path / "out" / f"{module.__name__.split('.')[-1]}.avi")
    iset.save(args, frames)
    ours = video.read_video(args.out)
    cap = cv2.VideoCapture(args.out, cv2.CAP_OPENCV_MJPEG)
    theirs = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        theirs.append(frame[..., ::-1])
    cap.release()
    assert ours.shape == (len(frames), *frames[0].shape[:2], 3)
    np.testing.assert_array_equal(np.stack(theirs), ours)
    written = np.stack([video.quantise(f) for f in frames]).astype(float)
    assert np.mean(np.abs(ours - written)) <= 4.0


def test_gen_vid_nvs_matches_jax(monkeypatch, tmp_path):
    """Three trajectory poses: RGB beside colormapped depth, each within
    PANEL_ATOL."""
    traj = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    traj[:, 2, 3] = [0.0, 0.5, 1.0]
    path = str(tmp_path / "traj.npy")
    np.save(path, traj)
    args = ("-cn", "exp_synthetic", "--index", "0", "--trajectory", path,
            "--out", str(tmp_path / "jax.mp4"))
    want = _jax_frames(monkeypatch, "scripts/videos/gen_vid_nvs.py", *args)
    port_args = _port_args(gen_vid_nvs, *args[:-2])
    got = gen_vid_nvs.render_frames(port_args, draws=_pose_draws)
    assert len(got) == len(want["frames"]) == 3
    for i, (g, w) in enumerate(zip(got, want["frames"])):
        assert g.shape == (H, 2 * W, 3)
        np.testing.assert_allclose(g[:, :W], w[:, :W], atol=PANEL_ATOL,
                                   err_msg=f"pose {i} rgb")
        np.testing.assert_allclose(g[:, W:], w[:, W:], atol=PANEL_ATOL,
                                   err_msg=f"pose {i} depth")
    _check_avi(gen_vid_nvs, port_args, got, tmp_path)


def test_gen_vid_transition_matches_jax(monkeypatch, tmp_path):
    """Three poses from the keyframe to the top-down view, invalid rays
    greyed out: within TRANSITION_ATOL, except on the border pixels of
    pose 0, the encoder's own camera, whose samples project onto the
    image's edge where rounding decides validity (as in
    tests/test_torch_inference_extra.py::test_render_poses_matches_jax);
    those hold a value in [0, 1]."""
    args = ("-cn", "exp_synthetic", "--index", "0", "--n-frames", "3",
            "--out", str(tmp_path / "jax.mp4"))
    want = _jax_frames(monkeypatch, "scripts/videos/gen_vid_transition.py",
                       *args)
    port_args = _port_args(gen_vid_transition, *args[:-2])
    got = gen_vid_transition.render_frames(port_args, draws=_pose_draws)
    assert len(got) == len(want["frames"]) == 3
    for i, (g, w) in enumerate(zip(got, want["frames"])):
        assert g.shape == (H, W, 3)
        inner = np.ones((H, W), bool)
        if i == 0:
            inner[[0, -1]] = inner[:, [0, -1]] = False
        np.testing.assert_allclose(g[inner], w[inner], atol=TRANSITION_ATOL,
                                   err_msg=f"pose {i}")
        assert 0 <= g.min() and g.max() <= 1
    _check_avi(gen_vid_transition, port_args, got, tmp_path)


def test_gen_vid_seq_matches_jax(monkeypatch, tmp_path):
    """Items 0 and 1: the input equal, the depth (JAX's jitter replayed
    into the jitter_density route) within PANEL_ATOL, and the BEV profile
    resized as cv2.resize does within the profile's bounds."""
    args = ("-cn", "exp_synthetic", "--from-idx", "0", "--to-idx", "2",
            "--out", str(tmp_path / "jax.mp4"))
    want = _jax_frames(monkeypatch, "scripts/videos/gen_vid_seq.py", *args)
    rcfg, mc = _jax_rcfg()

    def z_samp(idx):
        stub = np.concatenate([np.zeros((H * W, 6)),
                               np.full((H * W, 1), mc["z_near"]),
                               np.full((H * W, 1), mc["z_far"])], -1)
        return torch.as_tensor(np.array(jrenderer.sample_coarse(
            jax.random.PRNGKey(idx), stub, rcfg.n_coarse, rcfg.lindisp)))
    port_args = _port_args(gen_vid_seq, *args[:-2])
    got = gen_vid_seq.render_frames(port_args, z_samp=z_samp)
    assert len(got) == len(want["frames"]) == 2
    for i, (g, w) in enumerate(zip(got, want["frames"])):
        assert g.shape == (H, 3 * W, 3)
        np.testing.assert_array_equal(g[:, :W], w[:, :W])
        np.testing.assert_allclose(g[:, W:2 * W], w[:, W:2 * W],
                                   atol=PANEL_ATOL, err_msg=f"item {i} depth")
        _profile_close(g[:, 2 * W:], w[:, 2 * W:], f"item {i} profile")
    _check_avi(gen_vid_seq, port_args, got, tmp_path)


def test_slerp_matches_scipy():
    """geometry.slerp_rotations against scipy's Slerp within 1e-6, on
    random pairs, equal ends, and the transition's own pair (identity to
    the top-down pose)."""
    ts = np.linspace(0, 1, 9)
    pairs = [(Rotation.random(random_state=s).as_matrix(),
              Rotation.random(random_state=100 + s).as_matrix())
             for s in range(20)]
    pairs.append((pairs[0][0], pairs[0][0]))
    pairs.append((np.eye(3), gen_vid_transition.topdown_pose(8.0, 10.0)
                  [:3, :3].astype(np.float64)))
    for a, b in pairs:
        want = Slerp([0, 1], Rotation.from_matrix(np.stack([a, b])))(ts) \
            .as_matrix()
        np.testing.assert_allclose(geometry.slerp_rotations(a, b, ts), want,
                                   atol=1e-6)


def test_interpolate_poses_matches_jax_script():
    """The port's pose interpolation against the JAX script's
    interpolate_poses (scipy), float32 poses within 1e-6."""
    mod = load_script("scripts/videos/gen_vid_transition.py")
    top = gen_vid_transition.topdown_pose(8.0, 10.0)
    want = mod.interpolate_poses(np.eye(4, dtype=np.float32), top, 40)
    got = gen_vid_transition.interpolate_poses(np.eye(4, dtype=np.float32),
                                               top, 40)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_default_trajectory_matches_jax_script():
    mod = load_script("scripts/videos/gen_vid_nvs.py")
    np.testing.assert_array_equal(gen_vid_nvs.default_trajectory(),
                                  mod.default_trajectory())


@pytest.mark.parametrize("shape", [(48, 64), (37, 53)])
def test_avi_reads_back_through_opencv(shape, tmp_path):
    """A Motion-JPEG AVI of random frames (values outside [0, 1] too, odd
    sizes) reads back through cv2.VideoCapture(CAP_OPENCV_MJPEG) with its
    frame count, size and frame rate, and with the pixels read_video
    decodes; the quantisation is the JAX writer's."""
    rng = np.random.default_rng(shape[0])
    frames = [rng.uniform(-0.2, 1.2, shape + (3,)) for _ in range(4)]
    path = str(tmp_path / "v.avi")
    video.write_video(path, frames, fps=7)
    cap = cv2.VideoCapture(path, cv2.CAP_OPENCV_MJPEG)
    assert cap.get(cv2.CAP_PROP_FRAME_COUNT) == 4
    assert cap.get(cv2.CAP_PROP_FPS) == 7
    assert (cap.get(cv2.CAP_PROP_FRAME_HEIGHT),
            cap.get(cv2.CAP_PROP_FRAME_WIDTH)) == shape
    theirs = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        theirs.append(frame[..., ::-1])
    cap.release()
    np.testing.assert_array_equal(np.stack(theirs), video.read_video(path))
    for f in frames:
        np.testing.assert_array_equal(
            video.quantise(f), (np.clip(f, 0, 1) * 255).astype(np.uint8))


def test_video_refuses_what_it_cannot_write(tmp_path):
    with pytest.raises(ValueError, match="at least one frame"):
        video.encode_avi([])
    with pytest.raises(ValueError, match="RGB"):
        video.encode_avi([np.zeros((4, 4))])
    with pytest.raises(ValueError, match="RIFF"):
        video.read_avi(b"not a video")
