"""chip_smoke.py's phases 25 and 26 rehearsed on the CPU at a cut size
(the script itself needs the card; a wrapper call counts as a launch
here):

- phase 25: the KITTI odometry and Waymo trees built by the generators'
  command lines at a cut size (hashed, and built twice: the reference's
  trees here, the phase's own in its temporary directory), the loaders'
  first items hashed and held to the JAX loaders' hashes of the same
  trees, eval_depth on the NYU fixture and on the Waymo tree (JAX's means
  and the gaps are those of the full size, so they move out of the way),
  and two micro-steps of each training run;
- phase 26: the spatial encoder served in the four modes on cut scenes,
  two bf16 train steps at the flagship's widths cut to 48x64, and the
  mesh at 64^3 at the demo's full size, held to the JAX package's volume
  and triangle count (media/reference/mesh_k360.npz) as on the card.
"""
import importlib.util
import os

import pytest
import torch

from test_torch_chip_smoke import ROOT, _count_calls, _HostClock, cs

# One intra-op thread: pytest-xdist runs several workers on this CPU,
# and torch's default of a thread per core makes every small op wait
# on threads that the other workers have swapped out.
torch.set_num_threads(1)

# Frames cut to sizes the loaders shrink to the cut target (32x96).
TREE_ARGS = {
    "gen_synthetic_kitti_odom": ("--frames", "4", "--size", "47", "155",
                                 "--workers", "1"),
    "gen_synthetic_waymo": ("--frames", "8", "--size", "48", "128",
                            "--keyframes", "2", "5", "--workers", "1"),
}
LOADER_EXTRA = ("data.image_size=[32, 96]",)
EVAL_EXTRA = ("data.image_size=[32, 96]", "num_workers=0")
TRAIN_EXTRA = ("data.image_size=[32, 96]", "batch_size=2",
               "model_conf.ray_batch_size=64", "renderer.n_coarse=8",
               "num_workers=1", "tensorboard=false")


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cut_reference(tmp_path_factory):
    """The reference of the cut trees as tools/extra_data_reference.py
    takes it (the trees' hashes and the JAX loaders' item hashes); the
    means are left at 0 (JAX_GAP moves out of the way)."""
    tool = _tool("extra_data_reference")
    base = tmp_path_factory.mktemp("extra_ref")
    trees, tree_over = {}, {}
    for key, module in cs.EXTRA_TREES.items():
        tree = str(base / key)
        cs.build_tree(module, tree, TREE_ARGS[module])
        trees[key] = cs.tree_digest(tree)
        tree_over[key] = cs._generator(module).overrides(tree)
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        loaders = tool.jax_loader_digests(tree_over, LOADER_EXTRA)
    finally:
        os.chdir(cwd)
    return {"trees": trees, "loaders": loaders,
            "means": {run: {"abs_rel": 0.0, "a1": 0.0}
                      for run, _, _ in cs.EXTRA_EVALS}}


def test_extra_data_phase_rehearsed(monkeypatch, capsys, cut_reference):
    """Phase 25 as main() runs it, at the cut: the trees hash as the
    reference's, the port's loaders' items hash as the JAX loaders',
    eval_depth launches shared_z once per item on a frame's rays at
    H = 64 (NYU's 4 items, the Waymo tree's 2 keyframes), each within
    tolerance of the plain version, and both training runs take their
    micro-steps with no decode kernel."""
    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for name in ("jitter_density", "selfview", "shared_z"):
        _count_calls(monkeypatch, name)
    monkeypatch.setattr(cs, "JAX_GAP", dict.fromkeys(cs.JAX_GAP, 1e9))
    monkeypatch.setattr(cs, "KRAW_LAUNCH_SHAPE", (32 * 96, 64))
    out = cs.extra_data_phase("cpu", "host", _HostClock, tree_args=TREE_ARGS,
                              loader_extra=LOADER_EXTRA,
                              eval_extra=EVAL_EXTRA, train_extra=TRAIN_EXTRA,
                              reference=cut_reference, steps=2, timed_from=0)
    assert out["loader_digests"] == cut_reference["loaders"]
    for key in cs.EXTRA_TREES:
        assert out[f"{key}_tree"]["digest"] == cut_reference["trees"][key]
    for run, items in (("nyu", 4), ("waymo", 2)):
        res = out[f"eval_depth {run}"]
        assert res["launches"] == {"shared_z": items, "jitter_density": 0,
                                   "selfview": 0}
        assert max(res["max_abs_err"]) <= cs.TOLERANCE["shared_z_bf16"][0]
        assert set(res["frame_ms"]) == {"encode", "render", "frame"}
    assert out["eval_depth waymo"]["loader"]["reads"] == 10
    assert out["eval_depth nyu"]["loader"]["reads"] == 2   # image, depth
    for run, reads in (("kitti_odom", 4), ("waymo", 10)):
        res = out[f"exp_kitti_raw {run}"]
        assert len(res["losses"]) == 2 and not any(res["launches"].values())
        assert res["loader"]["reads"] == reads
    printed = capsys.readouterr().out
    for line in ("phase 25 tree", "phase 25 loaders",
                 "eval_depth nyu on the synthetic tree (host)",
                 "eval_depth waymo frame (host)",
                 "exp_kitti_raw kitti_odom micro-step (host)",
                 "exp_kitti_raw waymo micro-step (host)"):
        assert line in printed, line


def test_extra_data_phase_refuses_another_tree(monkeypatch, cut_reference):
    """A tree that hashes otherwise than the reference's fails the phase
    before any loader runs."""
    monkeypatch.chdir(ROOT)
    wrong = dict(cut_reference, trees=dict(cut_reference["trees"],
                                           kitti_odom="0" * 64))
    with pytest.raises(AssertionError, match="tree differs"):
        cs.extra_data_phase("cpu", "host", _HostClock, tree_args=TREE_ARGS,
                            reference=wrong)


def test_spatial_phase_rehearsed(monkeypatch, capsys):
    """Phase 26 at a cut: the spatial encoder's four serving modes on two
    48x64 scenes, each mode's kernel launched once a scene (a call of the
    wrapper) and held to its plain version; two bf16 train steps; the
    mesh at 64^3 at the demo's own size against JAX's."""
    from behindthescenes_tpu_torch import eval_depth
    from behindthescenes_tpu_torch import train as train_cli
    monkeypatch.chdir(ROOT)
    for name in ("jitter_density", "selfview", "shared_z"):
        _count_calls(monkeypatch, name)
    monkeypatch.setattr(eval_depth, "IMAGE_SIZE", (48, 64))
    batches = eval_depth.scenes(2)
    conf = train_cli.config(cs.TRAIN_CONFIG, overrides=(
        "data.image_size=[48, 64]", "batch_size=2",
        "model_conf.ray_batch_size=256"))
    batch = cs.train_batch(conf)
    draws = cs.numpy_draws(conf, batch, cs.TRAIN_SEED)
    out = cs.spatial_phase("cpu", "host", _HostClock, batches, conf, batch,
                           draws, steps=3, timed_from=1, resolutions=(64,))
    assert out["launches"] == {mode: 2 for mode, *_ in cs.MODES}
    assert set(out["max_abs_err"]) == {"shared_z", "shared_z_bf16",
                                       "selfview", "jitter_density"}
    assert out["launch_shape"] == [48 * 64, 64]
    assert out["encode_vs_host"]["shape"] == [1, 1, 24, 32, 512]
    assert out["encode_vs_host"]["max_abs"] == 0.0
    losses = out["training"]["losses"]
    assert len(losses) == 3 and losses[-1] < losses[0]
    mesh = out["mesh"][64]
    assert mesh["sigma_rel"] <= cs.MESH_SIGMA_RTOL
    assert mesh["triangles_rel"] <= cs.MESH_FACES_RTOL
    printed = capsys.readouterr().out
    for line in ("spatial encoder serving (host)",
                 "spatial encoder train bf16 (host)", "mesh of "):
        assert line in printed, line
