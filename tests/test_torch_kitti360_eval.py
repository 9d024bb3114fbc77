"""`python -m behindthescenes_tpu_torch.eval -cn eval_kitti_360_depth` and
`-cn eval_kitti_360_nvs` against the JAX package's task runner on the same
command, live on the CPU: a small gate drive (the port's `make_gate_tree`
at an eighth of the reference resolution, 8 frames, keyframes 2 and 5,
the fisheye frames at rotation [0, -15]) read at 64x192 from the raw
frames, media/weights/k360_synth_conv.npz, bf16 on both sides as the
tasks default. Depth over both keyframes (the deterministic shared-z
ladder: only rounding separates the sides); NVS over keyframe 2 (the two
sides draw different jitter). Each mean within chip_smoke.py's JAX_GAP
of JAX's. Full size runs on the card (chip_smoke.py phase 27).
"""
import importlib.util
import os

import pytest
import torch

from behindthescenes_tpu import config as jconfig
from behindthescenes_tpu.evaluation import tasks as jtasks
from behindthescenes_tpu.utils.io import load_params_npz as j_load_npz
from behindthescenes_tpu_torch import eval as teval
from behindthescenes_tpu_torch.datasets import gen_synthetic_kitti_360 as gen

# One intra-op thread: pytest-xdist runs several workers on this CPU,
# and torch's default of a thread per core makes every small op wait
# on threads that the other workers have swapped out.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

WEIGHTS = os.path.join(ROOT, "media", "weights", "k360_synth_conv.npz")
FRAMES, KEYFRAMES, NVS_KEYFRAMES = 8, (2, 5), (2,)
SIZE = "[64, 192]"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("k360_eval") / "tree"
    gen.make_gate_tree(root, frames=FRAMES, scale=0.125, keyframes=KEYFRAMES,
                       fisheye_rotation=(0, -15))
    gen.write_splits(root, gen.GATE_SEQ, list(NVS_KEYFRAMES), FRAMES,
                     "splits_nvs")
    return root


def _args(tree, split):
    return [f"data.data_path={tree}",
            f"data.pose_path={tree / 'data_poses'}",
            f"data.split_path={tree / split}", f"data.image_size={SIZE}",
            "data.is_preprocessed=false", "num_workers=0",
            f"checkpoint={WEIGHTS}"]


@pytest.mark.parametrize("name,task,split,metrics", [
    ("eval_kitti_360_depth", "evaluate_depth", "splits", ("abs_rel", "a1")),
    ("eval_kitti_360_nvs", "evaluate_nvs", "splits_nvs", ("psnr", "ssim")),
])
def test_kitti360_eval_config_matches_jax(tree, monkeypatch, name, task,
                                          split, metrics):
    args = _args(tree, split)
    # The JAX harness inits the net eagerly before it reads an .npz; the
    # file's variables are what it returns.
    monkeypatch.setattr(jtasks, "load_eval_variables",
                        lambda config, net, batch: j_load_npz(
                            config["checkpoint"]))
    want = getattr(jtasks, task)(jconfig.load_config(
        jconfig.find_config(name), jconfig.parse_cli_overrides(args)))
    got = teval.main(["-cn", name, *args, "--device", "cpu"])
    for m in metrics:
        assert abs(float(got[m]) - float(want[m])) <= cs.JAX_GAP[m], (
            m, float(got[m]), float(want[m]))
