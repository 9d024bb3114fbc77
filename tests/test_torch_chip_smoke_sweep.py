"""chip_smoke.py's phases 21-23 (sweep-mode NVS serving, the tile fetch in
patch-mode training, the image demos) rehearsed on the CPU at a cut size:
the sweep configs through the task runner with every frame counted
through render_frame_sweep, the profiles timed and the exact sweep held to
the general path; the tile step's fit share, per-point check, parity with
the gathers and step split; the demos with their jitter_density calls
counted (a wrapper call counts as a launch here) and held against the
plain version and a reference. (The script itself needs the card; its
contract is checked there.)"""
import numpy as np
import pytest
import torch
from test_torch_chip_smoke import ROOT, _count_calls, _HostClock, cs

# One intra-op thread: pytest-xdist runs several workers on this CPU,
# and torch's default of a thread per core makes every small op wait
# on threads that the other workers have swapped out.
torch.set_num_threads(1)

SWEEP_CUT = ("data.image_size=[24, 32]", "data.length=8", "bf16=false")
TRAIN_CUT = ("data.image_size=[48, 64]", "batch_size=2",
             "model_conf.ray_batch_size=128", "renderer.n_coarse=16")
DEMO = ("synthetic", cs.STEP8400_WEIGHTS)


def test_sweep_phase_rehearsed(monkeypatch, capsys):
    """Phase 21 at SWEEP_CUT (f32): both configs swept (2 views an item,
    4 items), no decode kernel, the three profiles timed beside the
    general path's frame, the exact sweep equal to the general path. JAX's
    means and the floors are those of the full size, so they move out of
    the way."""
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(cs, "JAX_GAP", dict.fromkeys(cs.JAX_GAP, 1e9))
    monkeypatch.setattr(cs, "NVS_FLOORS", {})
    out = cs.sweep_phase("cpu", "host", _HostClock,
                         {"eval_synthetic_flagship_nvs": {"frame": 1.0}},
                         overrides=SWEEP_CUT, frames=1)
    flagship, re10k = out["runs"]
    assert flagship["frames_swept"] >= 8 and re10k["frames_swept"] >= 8
    for res in out["runs"]:
        assert len(res["per_scene"]) >= 1
        assert not any(res["launches"].values())
        assert set(res["frame_ms"]) == {"encode", "render", "frame"}
    assert set(flagship["profiles"]) == set(cs.SWEEP_PROFILES)
    assert "profiles" not in re10k
    ex = out["exactness"]
    assert ex["invalid_equal"] and ex["shape"] == [24, 32, 64]
    assert all(ex["max_abs"][k] <= t for k, t in cs.SWEEP_EXACT_TOL.items())
    printed = capsys.readouterr().out
    assert "eval_synthetic_flagship_nvs frame by sweep profile (host)" \
        in printed
    assert "the general path (phase 10, 24 + 16 reuse) 1.000 ms" in printed


def test_tile_phase_rehearsed(capsys):
    """Phase 22 at TRAIN_CUT (ResNet-50 at 48x64, 2 items, 128 rays x 16
    samples, 3 steps): the fit share and the fitting points within
    TILE_POINT_ATOL of grid_sample_2d; where every tile fits, the tile
    step held to the gather step; each path timed in both dtypes."""
    out = cs.tile_phase("cpu", "host", _HostClock, overrides=TRAIN_CUT,
                        steps=3, timed_from=1)
    fit = out["fit"]
    assert fit["calls"] == 2 and fit["tiles"] == 2 * 128 // 64
    assert fit["point_max_abs"] <= cs.TILE_POINT_ATOL
    assert fit["points"] == fit["fit"] * 64 * 16
    assert 0 <= fit["past_edge"] < fit["points"]
    assert fit["dtype"] == "torch.float32"
    assert ("vs_gather" in out) == (fit["fit"] == fit["tiles"])
    if "vs_gather" in out:
        assert out["vs_gather"]["loss_rel"] <= cs.LOSS_RTOL
    for key in ("tile bf16", "gather bf16", "tile f32", "gather f32"):
        assert len(out[key]["losses"]) == 3
        assert set(out[key]["median_ms"]) == set(cs.STAGES) | {"step"}
    assert "tiles fit" in capsys.readouterr().out


@pytest.fixture(scope="module")
def demo_reference(tmp_path_factory):
    """The port's own demo grids for DEMO on the CPU with another seed of
    the depth jitter, as the reference of the rehearsal (the JAX demo's
    are held in tests/test_torch_demos.py)."""
    from behindthescenes_tpu_torch.scripts import gen_img_custom
    tmp = tmp_path_factory.mktemp("demo_ref")
    res = gen_img_custom.main([
        "--img", f"{ROOT}/{cs.DEMO_IMAGE}", "--model", DEMO[0],
        "--checkpoint", f"{ROOT}/{DEMO[1]}", "--device", "cpu", "--out",
        str(tmp), "--seed", "1"])
    path = str(tmp / "ref.npz")
    np.savez(path, profile=res["profile"], sigma=res["sigma"],
             depth=res["depth"].astype(np.float16))
    return path


def test_demo_phase_rehearsed(monkeypatch, capsys, demo_reference):
    """Phase 23 with the synthetic family: gen_img_custom calls
    jitter_density once (48x64 rays, H = 32), gen_imgs once an index,
    each call within tolerance of the plain version; the grids agree with
    the reference; the timing is "not measured" on the host."""
    monkeypatch.chdir(ROOT)
    _count_calls(monkeypatch, "jitter_density")
    out, launches = cs.demo_phase(
        "cpu", "host", image_model=DEMO, reference=demo_reference)
    args, kwargs = launches["gen_img_custom"]
    assert launches["gen_imgs"][0][1].shape[1] == 32
    assert out["launches"]["gen_img_custom"]["jitter_density"] == 1
    assert out["launches"]["gen_imgs"]["jitter_density"] == \
        len(cs.DEMO_IMGS_INDICES)
    assert out["launch_shapes"][0] == [48 * 64, 24]
    assert max(out["max_abs_err"]) == 0.0
    assert out["vs_jax"]["profile_cells_equal"] == 1.0
    assert 0 < out["vs_jax"]["depth_median_rel"] <= cs.DEMO_DEPTH_MEDIAN_REL
    assert out["depth_ms"] is None
    assert args[0].shape == (48 * 64, 24) and kwargs["n_freqs"] == 6
    nbytes, flops = cs.work("jitter_density", args, kwargs)
    assert nbytes > 0 and sum(flops.values()) > 0
    assert "gen_img_custom frame (host)" in capsys.readouterr().out


def test_demo_phase_fails_on_a_far_reference(monkeypatch, tmp_path,
                                             demo_reference):
    """A reference whose sigma is 5% off fails the phase."""
    monkeypatch.chdir(ROOT)
    _count_calls(monkeypatch, "jitter_density")
    ref = dict(np.load(demo_reference))
    ref["sigma"] = ref["sigma"] * 1.05
    path = str(tmp_path / "far.npz")
    np.savez(path, **ref)
    with pytest.raises(AssertionError, match="JAX demo"):
        cs.demo_phase("cpu", "host", image_model=DEMO, reference=path)
