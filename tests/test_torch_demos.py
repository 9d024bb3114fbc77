"""The port's image IO (utils/io.py, no OpenCV) against the JAX package's
(utils/io.py, through cv2), and the headline demo
`python -m behindthescenes_tpu_torch.scripts.gen_img_custom` against the
JAX script's functions (scripts/inference_setup.py) at the synthetic
family's 48x64 on the converged exp_synthetic checkpoint, bf16 as both
demos compute.
"""
import os
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behindthescenes_tpu import renderer as jrenderer
from behindthescenes_tpu.utils import io as jio
from behindthescenes_tpu.utils.io import load_params_npz as j_load_npz
from behindthescenes_tpu_torch.scripts import gen_img_custom, gen_imgs
from behindthescenes_tpu_torch.scripts import inference_setup as iset
from behindthescenes_tpu_torch.utils import io as tio
from test_torch_inference_extra import (PROFILE_ATOL, PROFILE_CELLS_EQUAL,
                                        SIGMA_RTOL)

# One intra-op thread: pytest-xdist runs several workers on this CPU,
# and torch's default of a thread per core makes every small op wait
# on threads that the other workers have swapped out.
torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
EXAMPLE = os.path.join(ROOT, "media", "example", "0000.png")
STEP8400 = os.path.join(ROOT, "media", "weights",
                        "synthetic_conv_step8400.npz")
# The depth of two runs that draw different jitter (chip_smoke.py phase
# 23's bound): their median relative difference.
DEPTH_MEDIAN_REL = 0.02


def _image(kind, seed=0):
    rng = np.random.default_rng(seed)
    shape = (13, 17, 3) if kind.startswith("rgb") else (13, 17)
    if kind.endswith("16"):
        return rng.integers(0, 65536, shape).astype(np.uint16)
    return rng.integers(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("kind", ["rgb8", "grey8", "rgb16", "grey16"])
def test_read_image_matches_cv2(kind, tmp_path):
    """A PNG written by OpenCV (its own row filters) reads the same
    through the port as through the JAX package's cv2 reader."""
    arr = _image(kind)
    path = str(tmp_path / f"{kind}.png")
    cv2.imwrite(path, arr[..., ::-1] if arr.ndim == 3 else arr)
    got, want = tio.read_image(path), jio.read_image(path)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_read_jpeg_matches_cv2(tmp_path):
    """A baseline JPEG written by OpenCV reads the same (the port's JPEG
    decoder is bit-equal to cv2.imread)."""
    rgb = np.clip(_image("rgb8", 3).astype(np.float32) * 0.5 + 60, 0, 255)
    path = str(tmp_path / "photo.jpg")
    cv2.imwrite(path, rgb.astype(np.uint8)[..., ::-1])
    np.testing.assert_array_equal(tio.read_image(path), jio.read_image(path))


@pytest.mark.parametrize("bit16", [False, True])
@pytest.mark.parametrize("channels", [3, 1])
def test_write_image_pixels_match_cv2(bit16, channels, tmp_path):
    """write_image's file reads back through cv2 to the pixels of the JAX
    package's cv2-written file (values out of [0, 1] clipped, then
    truncated); the compressed bytes may differ."""
    rng = np.random.default_rng(4)
    img = rng.uniform(-0.1, 1.1, (9, 11, 3) if channels == 3 else (9, 11))
    ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "theirs.png")
    tio.write_image(ours, img, bit16=bit16)
    jio.write_image(theirs, img, bit16=bit16)
    a = cv2.imread(ours, cv2.IMREAD_UNCHANGED)
    b = cv2.imread(theirs, cv2.IMREAD_UNCHANGED)
    assert a.dtype == b.dtype == (np.uint16 if bit16 else np.uint8)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tio.read_image(ours), jio.read_image(ours))


def test_io_refuses_what_it_cannot_do(tmp_path):
    with pytest.raises(FileNotFoundError):
        tio.read_image(str(tmp_path / "missing.png"))
    (tmp_path / "x.bmp").write_bytes(b"BM" + bytes(60))
    with pytest.raises(ValueError, match="neither"):
        tio.read_image(str(tmp_path / "x.bmp"))
    with pytest.raises(ValueError, match="PNG"):
        tio.write_image(str(tmp_path / "x.jpg"), np.zeros((2, 2, 3)))


@pytest.fixture(scope="module")
def jax_demo():
    """The JAX script's setup and functions (scripts/inference_setup.py)
    on the example image at 48x64: input, depth (from PRNGKey(0)'s
    jitter, with that jitter), profile and sigma."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import inference_setup as jiset
    finally:
        sys.path.remove(os.path.join(ROOT, "scripts"))
    with pytest.MonkeyPatch.context() as mp:
        # For an .npz the JAX harness returns the file's variables and
        # discards the template that its eager net.init (about a minute
        # on a CPU) makes.
        mp.setattr(jiset, "load_eval_variables",
                   lambda config, net, batch: j_load_npz(
                       config["checkpoint"]))
        net, variables, rcfg, config = jiset.setup_model("synthetic",
                                                         STEP8400)
    h, w = jiset.DEFAULT_RESOLUTION["synthetic"]
    fx, fy = jiset.DEFAULT_INTRINSICS["synthetic"]
    img = cv2.resize(jio.read_image(EXAMPLE), (w, h),
                     interpolation=cv2.INTER_LINEAR)
    grid, _, _ = jiset.encode_image(net, variables, img, fx, fy)
    mc = config["model_conf"]
    depth = jiset.render_depth(net, variables, grid, rcfg, h, w,
                               mc["z_near"], mc["z_far"])
    profile, sigma = jiset.render_profile(net, variables, grid)
    stub = jnp.concatenate([jnp.zeros((h * w, 6)),
                            jnp.full((h * w, 1), mc["z_near"]),
                            jnp.full((h * w, 1), mc["z_far"])], -1)
    z_samp = jrenderer.sample_coarse(jax.random.PRNGKey(0), stub,
                                     rcfg.n_coarse, rcfg.lindisp)
    return {"img": img, "depth": depth, "profile": profile, "sigma": sigma,
            "z_samp": np.asarray(z_samp), "mc": mc}


def test_gen_img_custom_matches_jax(jax_demo, tmp_path, capsys):
    """The port's demo (read, INTER_LINEAR resize, bf16 encode, jittered
    self-view depth through the jitter_density route, BEV profile) on the
    CPU against the JAX script's functions: the resized input equal; the
    profile and sigma within tests/test_torch_inference_extra.py's bf16
    bounds; the depth within 2% median relative difference of JAX's
    (different jitter); with JAX's jitter replayed, within 1% median and
    5% at the 99th percentile. Its three PNGs are written and read
    back."""
    out = gen_img_custom.main(["--img", EXAMPLE, "--model", "synthetic",
                               "--checkpoint", STEP8400, "--device", "cpu",
                               "--out", str(tmp_path)])
    np.testing.assert_array_equal(out["img"], jax_demo["img"])
    js, jp = jax_demo["sigma"], jax_demo["profile"]
    assert np.linalg.norm(out["sigma"] - js) <= SIGMA_RTOL * np.linalg.norm(js)
    assert np.mean(np.abs(out["profile"] - jp) <= PROFILE_ATOL) \
        >= PROFILE_CELLS_EQUAL
    rel = np.abs(out["depth"] - jax_demo["depth"]) / jax_demo["depth"]
    assert out["depth"].shape == (48, 64)
    assert np.median(rel) <= DEPTH_MEDIAN_REL, np.median(rel)
    net, rcfg, _ = iset.setup_model("synthetic", STEP8400, device="cpu")
    grid = iset.encode_image(net, out["img"], *iset.DEFAULT_INTRINSICS[
        "synthetic"])
    mc = jax_demo["mc"]
    replayed = iset.render_depth(net, grid, rcfg, 48, 64, mc["z_near"],
                                 mc["z_far"],
                                 z_samp=torch.as_tensor(jax_demo["z_samp"]))
    rel = np.abs(replayed - jax_demo["depth"]) / jax_demo["depth"]
    assert np.median(rel) <= 0.01 and np.quantile(rel, 0.99) <= 0.05, (
        np.median(rel), np.quantile(rel, 0.99))
    for part, shape in (("in", (48, 64, 3)), ("depth", (48, 64, 3)),
                        ("profile", (180, 180, 3))):
        img = tio.read_image(str(tmp_path / f"0000_{part}.png"))
        assert img.shape == shape
    assert "depth range" in capsys.readouterr().out


def test_gen_imgs_writes_each_index(tmp_path):
    """gen_imgs over two test items of exp_synthetic on the CPU: finite
    z-depth within the config's bounds (the z of a far-edge pixel's
    nearest sample lies a little under z_near) and three PNGs an
    index."""
    out = gen_imgs.main(["-cn", "exp_synthetic", "--checkpoint", STEP8400,
                         "--indices", "0", "3", "--device", "cpu",
                         "--out", str(tmp_path)])
    assert len(out) == 2
    for depth, profile in out:
        assert depth.shape == (48, 64) and np.isfinite(depth).all()
        assert 0.9 <= depth.min() and depth.max() <= 40.0
        assert profile.shape == (180, 180)
    names = sorted(os.listdir(tmp_path))
    assert names == sorted(f"{i:06d}_{p}.png" for i in (0, 3)
                           for p in ("in", "depth", "profile"))
