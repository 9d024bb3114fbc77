"""The port's KITTI-360 occupancy evaluators against the JAX package's:
every host ground-truth function bit-equal on seeded inputs; both
evaluators end to end on a small generated drive with a random-init
ResNet-18 model (the occupancy configs' model at resnet_layers 18, its
weights drawn from a numpy generator), JAX's
stratified jitter replayed into the port through `z_samp`; and both tasks
through the config loader, the task runner and the harness. The JAX
evaluators run on one device (BTS_EVAL_SHARD=0).
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(ROOT, "scripts", "datasets"))

import gen_synthetic_kitti_360 as jgen  # noqa: E402

from behindthescenes_tpu import renderer as jr  # noqa: E402
from behindthescenes_tpu import config as jconfig  # noqa: E402
from behindthescenes_tpu.datasets.kitti_360 import \
    Kitti360Dataset as JDataset  # noqa: E402
from behindthescenes_tpu.datasets.synthetic import collate  # noqa: E402
from behindthescenes_tpu.evaluation import bbox_occ as jb  # noqa: E402
from behindthescenes_tpu.evaluation import lidar_occ as jl  # noqa: E402
from behindthescenes_tpu.evaluation import tasks as jtasks  # noqa: E402
from behindthescenes_tpu.models.bts import BTSNet as JBTSNet  # noqa: E402
from behindthescenes_tpu.utils.io import load_params_npz  # noqa: E402
from behindthescenes_tpu_torch import eval as teval  # noqa: E402
from behindthescenes_tpu_torch import renderer as tr  # noqa: E402
from behindthescenes_tpu_torch.config import (find_config,  # noqa: E402
                                              load_config,
                                              parse_cli_overrides)
from behindthescenes_tpu_torch.datasets.kitti_360 import \
    Kitti360Dataset  # noqa: E402
from behindthescenes_tpu_torch.evaluation import bbox_occ as tb  # noqa
from behindthescenes_tpu_torch.evaluation import lidar_occ as tl  # noqa
from behindthescenes_tpu_torch.models.bts import BTSNet  # noqa: E402
from behindthescenes_tpu_torch.weights import (load_weights,  # noqa: E402
                                               save_params_npz)

DRIVE = dict(n_frames=26, hp=48, wp=176, hf=64, wf=64, seed=3, n_az=360,
             test_keyframes=[2, 5])
HW = (32, 96)
RKW = dict(n_coarse=64, lindisp=True, hard_alpha_cap=True)
R18 = ("model_conf.encoder.resnet_layers=18",)
# bf16 against bf16: the share of slab points whose occupancy (density >
# 0.5) flips, and the gap of each metric.
FLIP_MAX, BF16_METRIC_TOL = 2e-3, 5e-3
# bf16 on JAX's encoding: the share of the slab's densities that may
# differ from JAX's (measured: at most 0.04%, a gather's last bit).
SAME_FEATURES_SHARE = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_device_jax():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BTS_EVAL_SHARD", "0")
        yield


# ----------------------------------------------------- host ground truth
def _cloud(rng, n=3000):
    pts = np.concatenate([rng.uniform(-30, 30, (n, 2)),
                          rng.uniform(-2, 1, (n, 1)), np.ones((n, 1))], 1)
    return pts.astype(np.float32)


def _poses(rng, n):
    out = []
    for i in range(n):
        p = np.eye(4, dtype=np.float32)
        p[:3, 3] = rng.uniform(-1, 1, 3) + [0, 0, i]
        out.append(p)
    return np.stack(out)


@pytest.mark.parametrize("y_res", [1, 3])
def test_lidar_ground_truth_is_jax_bit_for_bit(y_res):
    rng = np.random.default_rng(y_res)
    np.testing.assert_array_equal(tl.CAM_INCL_ADJUST, jl.CAM_INCL_ADJUST)
    args = ((-4, 4), (0, 0.75), (20, 4), 10, 4, y_res)
    (q, res), (jq, jres) = tl.get_pts(*args), jl.get_pts(*args)
    assert res == jres and q.dtype == jq.dtype
    np.testing.assert_array_equal(q, jq)
    q = q.reshape(-1, 3)
    clouds, poses = [_cloud(rng) for _ in range(5)], _poses(rng, 5)
    slices = tl.get_lidar_slices(clouds, poses, (0, 0.75), y_res, 20.4)
    jslices = jl.get_lidar_slices(clouds, poses, (0, 0.75), y_res, 20.4)
    for a, b in zip(slices, jslices):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for got, want in zip(tl.check_occupancy(q, slices, poses),
                         jl.check_occupancy(q, jslices, poses)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    proj = np.array([[1.1, 0, 0.02], [0, 3.4, -0.1], [0, 0, 1]], np.float32)
    for got, want in zip(tl.project_into_cam(q, proj, poses[1]),
                         jl.project_into_cam(q, proj, poses[1])):
        np.testing.assert_array_equal(got, want)
    img = rng.uniform(0, 9, (7, 11)).astype(np.float32)
    # halves included: np.round rounds them to even
    xy = np.concatenate([rng.uniform(-1.3, 1.3, (200, 2)),
                         np.array([[-0.9, 0.5], [0.1, -1 / 3]])])
    np.testing.assert_array_equal(tl._grid_sample_nearest_ac_true(img, xy),
                                  jl._grid_sample_nearest_ac_true(img, xy))


def _box(rng, center, size):
    verts = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                      for z in (-1, 1)]) * size / 2 + center
    rot = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    return {"vertices": (verts - center) @ rot.T + center,
            "faces": jgen._CUBE_FACES.copy(), "semanticId": 26,
            "instanceId": 1}


def test_bbox_ground_truth_is_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    (q, res), (jq, jres) = (tb.get_pts((-4, 4), (0, 1), (20, 3), 5, 4),
                            jb.get_pts((-4, 4), (0, 1), (20, 3), 5, 4))
    assert res == jres == (40, 4, 85)
    np.testing.assert_array_equal(q, jq)
    q = q.reshape(-1, 3)
    pose = np.linalg.inv(_poses(rng, 1)[0])
    proj = np.array([[1.1, 0, 0.02], [0, 3.4, -0.1], [0, 0, 1]], np.float32)
    boxes = [_box(rng, c, s) for c, s in (((1.5, 0.4, 10.0), 2.0),
                                          ((-2.0, 0.4, 6.0), 2.5),
                                          ((0.5, 0.0, 90.0), 3.0))]
    for b in boxes:
        got, want = tb.verts_to_cam(b, pose), jb.verts_to_cam(b, pose)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        assert tb.bbox_in_frustum(got, proj, 20) == \
            jb.bbox_in_frustum(want, proj, 20)
        fnb = tb.compute_bounds(got)
        np.testing.assert_array_equal(fnb, jb.compute_bounds(want))
        np.testing.assert_array_equal(tb.in_bbox(q, fnb),
                                      jb.in_bbox(q, fnb))
        dirs = rng.normal(size=(300, 3)) + [0, 0, 3]
        dirs[:5, 2] = 0.0           # rays parallel to some faces: inf
        labels = rng.choice([7, 26], 300)
        np.testing.assert_array_equal(
            tb.bbox_intercept_labeled(dirs, labels, fnb, 26),
            jb.bbox_intercept_labeled(dirs, labels, fnb, 26))
    for got, want in zip(tb.project_into_cam(q, proj),
                         jb.project_into_cam(q, proj)):
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- the evaluators
def lecun_init(net, seed=0):
    """Every weight of `net` drawn from a numpy generator as Flax's default
    (lecun-normal: std 1 / sqrt(fan in)); torch's default init leaves the
    density head's outputs within 0.1 of one value, so that the occupancy
    threshold would decide nothing. Returns `net`."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in net.parameters():
            if p.ndim > 1:
                p.copy_(torch.as_tensor(rng.normal(0, p[0].numel() ** -0.5,
                                                   p.shape)))
    return net


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    """The small drive (JAX generator), the occupancy configs' model at
    resnet_layers 18 with `lecun_init`'s weights written as a checkpoint
    that both sides load (about three quarters of the slab occupied, the
    densities 0.29-1.26), and the model config."""
    base = tmp_path_factory.mktemp("occ")
    root = base / "drive"
    jgen.generate_tree(root, **DRIVE)
    mc = load_config(find_config("eval_lidar_occ"),
                     parse_cli_overrides(list(R18)))["model_conf"]
    torch.manual_seed(0)
    path = str(base / "r18_init.npz")
    save_params_npz(path, lecun_init(BTSNet.from_conf(mc)).state_dict(),
                    dispconv_scales=tuple(mc["encoder"]["scales"]))
    return root, mc, path


def _datasets(root, **kw):
    args = dict(data_path=str(root), pose_path=str(root / "data_poses"),
                split_path=str(root / "splits" / "test_files.txt"),
                target_image_size=HW, return_stereo=False,
                return_fisheye=False, frame_count=1, return_depth=True,
                return_3d_bboxes=True, return_segmentation=True)
    args.update(kw)
    return JDataset(**args), Kitti360Dataset(**args)


def _jax_jitter(key, hw, mc):
    n = hw[0] * hw[1]
    stub = jnp.concatenate([jnp.zeros((n, 6)),
                            jnp.full((n, 1), mc["z_near"]),
                            jnp.full((n, 1), mc["z_far"])], -1)
    return torch.as_tensor(np.asarray(jr.sample_coarse(key, stub, 64,
                                                       True)))


def _close(got, want, tol):
    """Equal keys; each value within tol (relative above 1), nan where
    JAX's is nan."""
    assert set(got) == set(want)
    for k in want:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            assert abs(got[k] - want[k]) <= tol * max(1.0, abs(want[k])), \
                (k, got[k], want[k])


EVALUATORS = {"lidar": (jl.LidarOccEvaluator, tl.LidarOccEvaluator, HW),
              "bbox": (jb.BBoxOccEvaluator, tb.BBoxOccEvaluator,
                       (HW[0] // 2, HW[1] // 2))}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", list(EVALUATORS))
def test_evaluator_matches_jax(drive, kind, bf16):
    """Metrics of each test keyframe with JAX's jitter, and the densities
    of the query slab from both sides' encodings: f32 within 1e-6 and
    1e-4; bf16 within BF16_METRIC_TOL, and at most FLIP_MAX of the slab's
    points on the other side of the occupancy threshold (measured: gaps
    up to 4.3e-3, flips 0.10-0.19%; the two encoders' bf16 convolutions
    sum in different orders, tests/test_torch_slice.py bounds their
    features). On JAX's own encoding the port's bf16 densities differ in
    at most SAME_FEATURES_SHARE of the points (14-16% before the bias
    rounding of tests/test_torch_bf16_bias.py)."""
    root, mc, path = drive
    jcls, tcls, out_hw = EVALUATORS[kind]
    jnet = JBTSNet.from_conf(mc, compute_dtype=jnp.bfloat16 if bf16
                             else jnp.float32)
    net = load_weights(BTSNet.from_conf(
        mc, compute_dtype=torch.bfloat16 if bf16 else torch.float32), path)
    variables = load_params_npz(path)
    jds, ds = _datasets(root)
    jev = jcls(jnet, jr.RendererConfig(**RKW), mc, jds)
    ev = tcls(net, tr.RendererConfig(**RKW), mc, ds)
    tol = BF16_METRIC_TOL if bf16 else 1e-6
    for i in range(len(ds)):
        batch = collate([ds[i]])
        key = jax.random.PRNGKey(10 + i)
        want = jev.evaluate(variables, batch, key=key)
        z = _jax_jitter(key, out_hw, mc)
        got = ev.evaluate(batch, z_samp=z)
        _close(got, want, tol)

        # The slab's densities from the same encoding on both sides.
        poses = batch["poses"]
        to_kf = np.linalg.inv(poses[0, 0])
        if kind == "lidar":
            to_kf = tl.CAM_INCL_ADJUST @ to_kf
            q = tl.get_pts(ev.x_range, ev.y_range, ev.z_range, ev.ppm,
                           ev.ppm_y, ev.y_res)[0].reshape(-1, 3)
        else:
            q = tb.get_pts(ev.x_range, ev.y_range, ev.z_range, ev.ppm,
                           ev.ppm_y)[0].reshape(-1, 3)
        poses_w = (to_kf[None, None] @ poses).astype(np.float32)
        grid, _ = jev._encode(variables, jnp.asarray(batch["imgs"]),
                              jnp.asarray(batch["projs"]),
                              jnp.asarray(poses_w), key)
        want_d = np.asarray(jev._query(variables, grid, jnp.asarray(q)),
                            dtype=np.float32)
        images = torch.as_tensor(batch["imgs"])
        tgrid, _ = ev.encode_and_depth(
            images, torch.as_tensor(batch["projs"]),
            torch.as_tensor(poses_w), images[:, :1] * 0.5 + 0.5, out_hw,
            z_samp=z)
        got_d = ev.query_density(tgrid, q)
        assert got_d.shape == want_d.shape == (q.shape[0],)
        if bf16:
            flips = np.mean((got_d > 0.5) != (want_d > 0.5))
            assert flips <= FLIP_MAX, flips
            feats = torch.as_tensor(np.array(
                grid.features[0].astype(jnp.float32))).to(torch.bfloat16)
            same = ev.query_density(
                dataclasses.replace(tgrid, features=(feats,)), q)
            assert np.mean(same != want_d) <= SAME_FEATURES_SHARE
        else:
            assert np.abs(got_d - want_d).max() <= 1e-4


def _cli(root, split="splits"):
    return [f"data.data_path={root}",
            f"data.pose_path={root / 'data_poses'}",
            f"data.split_path={root / split}",
            f"data.image_size=[{HW[0]}, {HW[1]}]", "num_workers=0",
            "bf16=false", *R18]


@pytest.mark.parametrize("name,task", [("eval_lidar_occ", "lidar_occ"),
                                       ("eval_3dbb", "3dbb")])
def test_occupancy_task_matches_jax(drive, monkeypatch, capsys, name,
                                    task):
    """`python -m behindthescenes_tpu_torch.eval -cn <config>` over both
    test keyframes against the JAX task runner on the same checkpoint, in
    f32, with JAX's per-item keys (PRNGKey(i)) replayed into the port's
    evaluator as z_samp: the printed means within 1e-6."""
    root, mc, path = drive
    args = _cli(root) + [f"checkpoint={path}"]
    want = getattr(jtasks, f"evaluate_{task}")(jconfig.load_config(
        jconfig.find_config(name), jconfig.parse_cli_overrides(args)))
    cls = tl.LidarOccEvaluator if task == "lidar_occ" \
        else tb.BBoxOccEvaluator
    evaluate, seen = cls.evaluate, []
    out_hw = HW if task == "lidar_occ" else (HW[0] // 2, HW[1] // 2)

    def with_jax_jitter(self, batch, generator=None):
        seen.append(generator.initial_seed())
        z = _jax_jitter(jax.random.PRNGKey(len(seen) - 1), out_hw, mc)
        return evaluate(self, batch, z_samp=z)
    monkeypatch.setattr(cls, "evaluate", with_jax_jitter)
    got = teval.main(["-cn", name, *args, "--device", "cpu"])
    assert seen == [0, 1]
    assert capsys.readouterr().out.strip().startswith('{"o_acc"')
    _close(got, want, 1e-6)
