"""How closely the port's KITTI-360 path agrees with OpenCV and with the JAX
package, measured on the CPU.

    JAX_PLATFORMS=cpu python3 tools/k360_agreement.py   # from the repo root

Prints one JSON line per measurement:
- `resize`: over the perspective frames of a 4-frame drive at the
  occupancy gate's resolution (188x704 -> 192x640, the JAX generator),
  the share of float32 values where the port's `resize_linear` differs
  from cv2.resize(INTER_LINEAR), and the share of uint8 values that the
  preprocessor's truncation then changes; the same for the two-product
  form w0 a + w1 b, which OpenCV 5 does not use.
- `resnetfc`: a bf16 ResnetFC of the flagship width (0 and 1 blocks) on
  random weights and inputs: the share of outputs that differ from the
  JAX package's, with the bias added after the rounded product (as the
  port does) and fused into it (as the port did).
- `occupancy`: the drive and the numpy-initialised ResNet-18 model of
  tests/test_torch_occupancy.py, per evaluator and keyframe, JAX's jitter
  replayed: the f32 metric gap and density deviation; in bf16, each side
  from its own encoder, the metric gap and the share of the slab whose
  occupancy flips; in bf16 on JAX's encoding, the share of the slab's
  densities that differ, with the bias rounded as now and fused.
Needs JAX, OpenCV and PyYAML beside the port (the test environment).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts", "datasets")]
os.environ.setdefault("BTS_EVAL_SHARD", "0")

import cv2  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import gen_synthetic_kitti_360 as jgen  # noqa: E402
from behindthescenes_tpu import renderer as jr  # noqa: E402
from behindthescenes_tpu.datasets.kitti_360 import \
    Kitti360Dataset as JDataset  # noqa: E402
from behindthescenes_tpu.datasets.synthetic import collate  # noqa: E402
from behindthescenes_tpu.evaluation import bbox_occ as jb  # noqa: E402
from behindthescenes_tpu.evaluation import lidar_occ as jl  # noqa: E402
from behindthescenes_tpu.models.bts import BTSNet as JBTSNet  # noqa: E402
from behindthescenes_tpu.models.mlp import make_mlp as j_make_mlp  # noqa
from behindthescenes_tpu.utils.io import load_params_npz  # noqa: E402
from behindthescenes_tpu_torch import renderer as tr  # noqa: E402
from behindthescenes_tpu_torch.config import (find_config,  # noqa: E402
                                              load_config,
                                              parse_cli_overrides)
from behindthescenes_tpu_torch.datasets import png  # noqa: E402
from behindthescenes_tpu_torch.datasets.kitti_360 import \
    Kitti360Dataset  # noqa: E402
from behindthescenes_tpu_torch.evaluation import bbox_occ as tb  # noqa
from behindthescenes_tpu_torch.evaluation import lidar_occ as tl  # noqa
from behindthescenes_tpu_torch.models import encoder as tenc  # noqa: E402
from behindthescenes_tpu_torch.models import mlp as tmlp  # noqa: E402
from behindthescenes_tpu_torch.models.bts import BTSNet  # noqa: E402
from behindthescenes_tpu_torch.weights import (load_weights,  # noqa: E402
                                               save_params_npz)

# tests/test_torch_occupancy.py's drive, image size and renderer.
DRIVE = dict(n_frames=26, hp=48, wp=176, hf=64, wf=64, seed=3, n_az=360,
             test_keyframes=[2, 5])
HW = (32, 96)
RKW = dict(n_coarse=64, lindisp=True, hard_alpha_cap=True)


def emit(kind: str, **fields) -> None:
    print(json.dumps({"kind": kind, **fields}), flush=True)


# -------------------------------------------------------------- fused bias
def _dense_fused(lin, x, dtype=None):
    dt = dtype or torch.promote_types(x.dtype, lin.weight.dtype)
    bias = None if lin.bias is None else lin.bias.to(dt)
    return F.linear(x.to(dt), lin.weight.to(dt), bias)


def _conv_fused(conv, x, dtype):
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), bias, conv.stride,
                    conv.padding)


@contextlib.contextmanager
def bias_rounding(fused: bool):
    """The port's bf16 layers as they are, or with the bias fused into the
    product and rounded once."""
    saved = tmlp._dense, tenc._conv
    if fused:
        tmlp._dense, tenc._conv = _dense_fused, _conv_fused
    try:
        yield
    finally:
        tmlp._dense, tenc._conv = saved


# ------------------------------------------------------------------ resize
def measure_resize(tmp: Path) -> None:
    root = tmp / "gate_res"
    jgen.generate_tree(root, n_frames=4, hp=188, wp=704, hf=350, wf=350,
                       seed=1, splits="none")
    ulps = {"lerp": 0, "two_products": 0}
    levels = dict(ulps)
    total = 0
    for path in sorted(root.glob("data_2d_raw/*/image_0[01]/data_rect/*.png")):
        img = png.read_png(path).astype(np.float32) / 255.0
        want = cv2.resize(img, (640, 192), interpolation=cv2.INTER_LINEAR)
        x0, x1, wx = png._linear_taps(640, img.shape[1])
        y0, y1, wy = png._linear_taps(192, img.shape[0])
        rows = img[:, x0] * (1 - wx)[None, :, None] \
            + img[:, x1] * wx[None, :, None]
        forms = {"lerp": png.resize_linear(img, (192, 640)),
                 "two_products": rows[y0] * (1 - wy)[:, None, None]
                 + rows[y1] * wy[:, None, None]}

        def to_uint8(a):
            return (((a * 2.0 - 1.0) * 0.5 + 0.5) * 255.0).astype(np.uint8)
        for name, got in forms.items():
            ulps[name] += int((got != want).sum())
            levels[name] += int((to_uint8(got) != to_uint8(want)).sum())
        total += want.size
    for name in ulps:
        emit("resize", form=name, values=total,
             float_share=ulps[name] / total, uint8_share=levels[name] / total)


# ---------------------------------------------------------------- resnetfc
def _torch_name(path):
    *mods, leaf = path
    mods = [f"blocks.{m.split('_')[1]}" if m.startswith("block_") else m
            for m in mods]
    return ".".join(mods + ["weight" if leaf == "kernel" else "bias"])


def measure_resnetfc() -> None:
    for n_blocks in (0, 1):
        conf = {"type": "resnet", "n_blocks": n_blocks, "d_hidden": 64}
        jm = j_make_mlp(conf, d_out=1, dtype=jnp.bfloat16)
        rng = np.random.default_rng(0)
        params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 103)))["params"]
        params = jax.tree_util.tree_map(
            lambda a: a + 0.1 * rng.standard_normal(a.shape)
            .astype(np.float32), params)
        x = rng.standard_normal((4096, 103)).astype(np.float32)
        want = np.asarray(jm.apply({"params": params},
                                   jnp.asarray(x, jnp.bfloat16))
                          .astype(jnp.float32))
        net = tmlp.make_mlp(conf, 103, 1, dtype=torch.bfloat16)
        net.load_state_dict({
            _torch_name([k.key for k in path]):
                torch.as_tensor(np.array(v).T if path[-1].key == "kernel"
                                else np.array(v))
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]})
        out = {}
        for fused in (False, True):
            with bias_rounding(fused), torch.no_grad():
                got = net(torch.as_tensor(x).bfloat16()).float().numpy()
            out["fused" if fused else "rounded"] = float(np.mean(got != want))
        emit("resnetfc", n_blocks=n_blocks, outputs=len(x),
             differing_share=out)


# --------------------------------------------------------------- occupancy
def lecun_init(net, seed=0):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in net.parameters():
            if p.ndim > 1:
                p.copy_(torch.as_tensor(rng.normal(0, p[0].numel() ** -0.5,
                                                   p.shape)))
    return net


def _jitter(key, hw, mc):
    n = hw[0] * hw[1]
    stub = jnp.concatenate([jnp.zeros((n, 6)), jnp.full((n, 1), mc["z_near"]),
                            jnp.full((n, 1), mc["z_far"])], -1)
    return torch.as_tensor(np.array(jr.sample_coarse(key, stub, 64, True)))


def _gap(got, want):
    return max(abs(got[k] - want[k]) for k in want if np.isfinite(want[k]))


def measure_occupancy(tmp: Path) -> None:
    root = tmp / "drive"
    jgen.generate_tree(root, **DRIVE)
    mc = load_config(find_config("eval_lidar_occ"), parse_cli_overrides(
        ["model_conf.encoder.resnet_layers=18"]))["model_conf"]
    torch.manual_seed(0)
    path = str(tmp / "r18_init.npz")
    save_params_npz(path, lecun_init(BTSNet.from_conf(mc)).state_dict(),
                    dispconv_scales=tuple(mc["encoder"]["scales"]))
    variables = load_params_npz(path)
    kw = dict(data_path=str(root), pose_path=str(root / "data_poses"),
              split_path=str(root / "splits" / "test_files.txt"),
              target_image_size=HW, return_stereo=False,
              return_fisheye=False, frame_count=1, return_depth=True,
              return_3d_bboxes=True, return_segmentation=True)
    jds, ds = JDataset(**kw), Kitti360Dataset(**kw)
    kinds = {"lidar": (jl.LidarOccEvaluator, tl.LidarOccEvaluator, HW),
             "bbox": (jb.BBoxOccEvaluator, tb.BBoxOccEvaluator,
                      (HW[0] // 2, HW[1] // 2))}
    for kind, (jcls, tcls, out_hw) in kinds.items():
        for bf16 in (False, True):
            jnet = JBTSNet.from_conf(mc, compute_dtype=jnp.bfloat16 if bf16
                                     else jnp.float32)
            net = load_weights(BTSNet.from_conf(
                mc, compute_dtype=torch.bfloat16 if bf16 else torch.float32),
                path)
            jev = jcls(jnet, jr.RendererConfig(**RKW), mc, jds)
            ev = tcls(net, tr.RendererConfig(**RKW), mc, ds)
            for i in range(len(ds)):
                batch = collate([ds[i]])
                key = jax.random.PRNGKey(10 + i)
                want = jev.evaluate(variables, batch, key=key)
                z = _jitter(key, out_hw, mc)
                got = ev.evaluate(batch, z_samp=z)
                poses = batch["poses"]
                to_kf = np.linalg.inv(poses[0, 0])
                if kind == "lidar":
                    to_kf = tl.CAM_INCL_ADJUST @ to_kf
                    q = tl.get_pts(ev.x_range, ev.y_range, ev.z_range,
                                   ev.ppm, ev.ppm_y, ev.y_res)[0]
                else:
                    q = tb.get_pts(ev.x_range, ev.y_range, ev.z_range,
                                   ev.ppm, ev.ppm_y)[0]
                q = q.reshape(-1, 3)
                poses_w = (to_kf[None, None] @ poses).astype(np.float32)
                grid, _ = jev._encode(variables, jnp.asarray(batch["imgs"]),
                                      jnp.asarray(batch["projs"]),
                                      jnp.asarray(poses_w), key)
                want_d = np.asarray(jev._query(variables, grid,
                                               jnp.asarray(q)), np.float32)
                images = torch.as_tensor(batch["imgs"])
                tgrid, _ = ev.encode_and_depth(
                    images, torch.as_tensor(batch["projs"]),
                    torch.as_tensor(poses_w), images[:, :1] * 0.5 + 0.5,
                    out_hw, z_samp=z)
                got_d = ev.query_density(tgrid, q)
                rec = {"evaluator": kind, "dtype": "bf16" if bf16 else "f32",
                       "keyframe": int(ds._datapoints[i][1]),
                       "metric_gap": _gap(got, want),
                       "density_max_dev": float(np.abs(got_d - want_d).max()),
                       "flip_share": float(np.mean((got_d > 0.5)
                                                   != (want_d > 0.5))),
                       "occupied_share": float(np.mean(want_d > 0.5))}
                if bf16:
                    feats = torch.as_tensor(np.array(
                        grid.features[0].astype(jnp.float32))) \
                        .to(torch.bfloat16)
                    same = dataclasses.replace(tgrid, features=(feats,))
                    for fused in (False, True):
                        with bias_rounding(fused):
                            d = ev.query_density(same, q)
                        rec["same_features_differing_share_" + (
                            "fused" if fused else "rounded")] = \
                            float(np.mean(d != want_d))
                emit("occupancy", **rec)


def main() -> None:
    with tempfile.TemporaryDirectory(prefix="k360_agreement_") as tmp:
        measure_resize(Path(tmp))
        measure_resnetfc()
        measure_occupancy(Path(tmp))


if __name__ == "__main__":
    main()
