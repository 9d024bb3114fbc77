"""Generate a geometry-consistent synthetic KITTI-360 drive: the port's own
copy of scripts/datasets/gen_synthetic_kitti_360.py, with the same scene,
the same draws in the same order and the same files, written without
OpenCV or PyYAML (PNGs by `datasets/png.py`, the fisheye calibration by
`dump_yaml`), so that the GPU machine can build its own tree.
`make_gate_tree` builds the tree of the JAX package's occupancy gate
(tests/test_occupancy_gate.py:28-63), preprocessed, with both split files.

Unlike tests/kitti360_fixture.py (random pixels/points, used only to
exercise loader file plumbing), every asset written here is rendered from
ONE analytic box-world street scene:

  * rectified stereo pairs (pinhole, reference P_rect intrinsics layout),
  * side-facing fisheye frames rendered through the MEI mirror model —
    the exact inverse of the loader's fisheye->pinhole resampler math
    (behindthescenes_tpu/datasets/kitti_360.py:28-70, reference
    kitti_360_dataset.py:21-69),
  * velodyne scans ray-cast HDL-64-style (64 inclination rings, level
    with the street), written as reference .bin files,
  * per-frame semantic maps and data_3d_bboxes annotation XML whose box
    vertices are the true scene geometry.

Cameras carry the ~5 degree inclination that the LiDAR-occupancy
evaluator's CAM_INCL_ADJUST undoes (reference evaluator_lidar.py:27-34),
so the evaluator's street-aligned query slab lines up with this world's
ground plane exactly as it does on real KITTI-360.

Training on this tree and running `eval.py -cn eval_lidar_occ /
eval_3dbb / eval depth` therefore measures real occupancy and depth
ACCURACY end-to-end (real KITTI-360 cannot ship in this environment).

Usage:
  python -m behindthescenes_tpu_torch.datasets.gen_synthetic_kitti_360 \
      --out <dir> [--frames 60] [--seed 0]
  python -c "from behindthescenes_tpu_torch.datasets.gen_synthetic_kitti_360 \
      import make_gate_tree; make_gate_tree('<dir>')"   # the gate's tree

The tree mirrors the reference layout (reference kitti_360_dataset.py:
91-150): data_2d_raw/<seq>/image_XX, data_3d_raw/<seq>/velodyne_points,
data_2d_semantics/train/<seq>/image_00, data_3d_bboxes/train_full,
data_poses/<seq>/poses.txt, splits/{train,test}_files.txt.
"""
from __future__ import annotations

import argparse
import math
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

from behindthescenes_tpu_torch.datasets.png import write_png as _write_png
from behindthescenes_tpu_torch.datasets.raycast import raycast_boxes
from behindthescenes_tpu_torch.evaluation.lidar_occ import CAM_INCL_ADJUST

SEQ = "2013_05_28_drive_0000_sync"

# Reference-resolution intrinsics (scaled when generating smaller trees).
HP_REF, WP_REF = 376, 1408
HF_REF, WF_REF = 700, 700
F_REF = 552.554
CX_REF, CY_REF = 682.05, 238.77
GAMMA_REF = 655.4

GROUND_Y = 1.55          # street plane in the body frame (y down)
STEREO_BASELINE = 0.6
GROUND_COLORS = (0.8, 0.3)
# 3m ground squares: the side-facing fisheyes minify the ground heavily;
# a 1m checker aliases below the fisheye pixel pitch (view-INconsistent
# texture, bad for both the resample parity tests and photometric
# training supervision).
CHECKER_PERIOD = 3.0
# Smooth world-space surface texture (see raycast_boxes): flat-colored
# faces starve the photometric loss of depth signal; measured on-chip,
# the textureless variant stalled at val abs_rel ~1.3 while the RGB loss
# sat at 0.006 (any depth reprojects flat color to flat color).
TEXTURE_AMP = 0.45

# The occupancy gate's drive (tests/test_occupancy_gate.py:28-63): its
# sequence, frames (4 keyframes with the full 20-step LiDAR window), seed,
# resolution scale and keyframes.
GATE_SEQ = "drive_0001_sync"
GATE_FRAMES = 34
GATE_SEED = 1
GATE_SCALE = 0.5
GATE_KEYFRAMES = (2, 5, 8, 11)

# Semantic ids (KITTI-360 devkit): road, building, sky, car.
SEM_ROAD, SEM_BUILDING, SEM_SKY, SEM_CAR = 7, 11, 23, 26

_CUBE_FACES = np.array(
    [[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
     [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]],
    dtype=np.int64)


# --------------------------------------------------------------------- MEI
def normalize_fisheye(calib):
    """NDC-normalize a raw fisheye calib exactly like
    Kitti360Dataset._load_calibs (kitti_360.py:317-322)."""
    h, w = calib["image_height"], calib["image_width"]
    pp = calib["projection_parameters"]
    return {
        "xi": calib["mirror_parameters"]["xi"],
        "k1": calib["distortion_parameters"]["k1"],
        "k2": calib["distortion_parameters"]["k2"],
        "g1": pp["gamma1"] / w * 2.0, "g2": pp["gamma2"] / h * 2.0,
        "u0": pp["u0"] / w * 2.0 - 1.0, "v0": pp["v0"] / h * 2.0 - 1.0,
        "h": h, "w": w,
    }


def mei_project(xyz, calib):
    """Unit dirs (N, 3) in the native fisheye frame -> float pixel coords
    (N, 2), mirroring FisheyeToPinholeSampler (kitti_360.py:46-66)."""
    n = normalize_fisheye(calib)
    xs = xyz[:, 0] / (xyz[:, 2] + n["xi"])
    ys = xyz[:, 1] / (xyz[:, 2] + n["xi"])
    r = xs * xs + ys * ys
    factor = 1 + n["k1"] * r + n["k2"] * r * r
    xs = xs * factor * n["g1"] + n["u0"]
    ys = ys * factor * n["g2"] + n["v0"]
    px = (xs + 1) * 0.5 * (n["w"] - 1)
    py = (ys + 1) * 0.5 * (n["h"] - 1)
    return np.stack([px, py], axis=-1)


def mei_backproject(calib):
    """Per-pixel unit ray directions of the full fisheye image.

    Inverts the loader's projection chain: align-corners pixel -> NDC ->
    radial undistortion (fixed point) -> MEI sphere backprojection.
    Returns (dirs (h, w, 3) unit, valid (h, w) bool). Pixels outside the
    model's valid image circle (xi > 1 limits the distorted radius) are
    invalid."""
    n = normalize_fisheye(calib)
    h, w = n["h"], n["w"]
    cols = np.arange(w, dtype=np.float64)
    rows = np.arange(h, dtype=np.float64)
    xs_n = (cols * 2.0 / (w - 1) - 1.0)[None, :].repeat(h, 0)
    ys_n = (rows * 2.0 / (h - 1) - 1.0)[:, None].repeat(w, 1)
    m1 = (xs_n - n["u0"]) / n["g1"]
    m2 = (ys_n - n["v0"]) / n["g2"]

    x, y = m1.copy(), m2.copy()
    for _ in range(25):
        r = x * x + y * y
        factor = 1 + n["k1"] * r + n["k2"] * r * r
        x, y = m1 / factor, m2 / factor

    rho2 = x * x + y * y
    disc = 1 + rho2 * (1 - n["xi"] ** 2)
    valid = disc >= 0
    s = (n["xi"] + np.sqrt(np.maximum(disc, 0.0))) / (rho2 + 1.0)
    dirs = np.stack([x * s, y * s, s - n["xi"]], axis=-1)
    # Keep a margin away from the valid-circle rim, where the radial
    # fixed point converges slowly.
    valid &= rho2 <= 0.92 / max(n["xi"] ** 2 - 1, 1e-6)
    return dirs, valid


# ------------------------------------------------------------------- scene
def build_scene(rng, length_m):
    """Procedural street: cars inside the occupancy slab (|x| < 4) and
    buildings outside it. Returns a list of (lo, hi, color, semantic)."""
    boxes = []
    z = 6.0
    side = 1
    while z < length_m + 26:
        w = rng.uniform(1.6, 2.1)
        h = rng.uniform(1.4, 1.9)
        d = rng.uniform(3.4, 4.4)
        cx = side * rng.uniform(2.0, 3.1)
        side = -side
        color = rng.uniform(0.15, 0.95, 3)
        boxes.append((np.array([cx - w / 2, GROUND_Y - h, z]),
                      np.array([cx + w / 2, GROUND_Y, z + d]),
                      color, SEM_CAR))
        z += rng.uniform(7.0, 12.0)
    z = -4.0
    while z < length_m + 30:
        for sx in (-1, 1):
            if rng.uniform() < 0.85:
                bw = rng.uniform(3.0, 6.0)
                bh = rng.uniform(3.5, 7.0)
                bd = rng.uniform(6.0, 10.0)
                bx = sx * rng.uniform(6.5, 9.5)
                color = rng.uniform(0.2, 0.9, 3)
                boxes.append((np.array([bx - bw / 2, GROUND_Y - bh, z]),
                              np.array([bx + bw / 2, GROUND_Y, z + bd]),
                              color, SEM_BUILDING))
        z += 10.0
    return boxes


def semantic_of_hit(hit_id, boxes):
    """Map raycast hit ids to KITTI-360 semantic ids."""
    table = np.array([SEM_SKY, SEM_ROAD]
                     + [b[3] for b in boxes], dtype=np.uint8)
    return table[hit_id + 1]


# ------------------------------------------------------------------- calib
def make_calibs(hp, wp, hf, wf):
    """All rig transforms. Returns a dict of raw calib data (written to
    disk) plus derived matrices used for rendering."""
    # fx/cx scale with width, fy/cy with height (equal for the reference
    # aspect ratio).
    sx, sy = wp / WP_REF, hp / HP_REF
    k_px = np.array([[F_REF * sx, 0, CX_REF * sx, 0],
                     [0, F_REF * sy, CY_REF * sy, 0],
                     [0, 0, 1, 0]], dtype=np.float64)

    # The LiDAR evaluator maps everything into
    # eval_world = CAM_INCL_ADJUST @ inv(keyframe_cam_pose); with the
    # camera c2w rotation equal to A := CAM_INCL_ADJUST[:3,:3] that
    # composition is A @ A^-1 = I up to translation, i.e. the eval world
    # IS this generator's street frame and the query slab is
    # street-aligned, exactly as on real KITTI-360.
    a_rot = np.asarray(CAM_INCL_ADJUST[:3, :3], dtype=np.float64)
    r_cam = a_rot.copy()                 # cameras pitch ~5 deg vs street

    def rt(r, t):
        m = np.eye(4)
        m[:3, :3] = r
        m[:3, 3] = t
        return m

    r_left = np.array([[0.0, 0, -1], [0, 1, 0], [1, 0, 0]])   # z -> -x
    r_right = np.array([[0.0, 0, 1], [0, 1, 0], [-1, 0, 0]])  # z -> +x

    cam_to_pose = {
        "image_00": rt(r_cam, (0.0, 0.0, 0.0)),
        "image_01": rt(r_cam, (STEREO_BASELINE, 0.0, 0.0)),
        "image_02": rt(r_left, (-0.4, -0.3, 0.5)),
        "image_03": rt(r_right, (0.4, -0.3, 0.5)),
    }

    # cam00 -> velodyne. R_base maps cam (x right, y down, z fwd) axes to
    # velodyne (x fwd, y left, z up); the extra a_rot keeps the velodyne
    # level with the STREET (velo->street = r_cam @ (r_base @ a_rot)^T =
    # r_base^T; real rigs mount it level, not with the cameras'
    # inclination).
    r_base = np.array([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]])
    cam_to_velo = rt(r_base @ a_rot, (-0.25, 0.0, 0.35))

    sf = wf / WF_REF
    fish = {}
    for name, (u0, v0) in (("image_02", (349.1 * sf, 351.3 * sf)),
                           ("image_03", (350.6 * sf, 348.2 * sf))):
        fish[name] = {
            "mirror_parameters": {"xi": 2.1918},
            "distortion_parameters": {"k1": 0.04, "k2": -0.011},
            "projection_parameters": {"gamma1": GAMMA_REF * sf,
                                      "gamma2": (GAMMA_REF + 1.2) * sf,
                                      "u0": u0, "v0": v0},
            "image_height": hf, "image_width": wf,
        }
    return {"k_px": k_px, "cam_to_pose": cam_to_pose,
            "cam_to_velo": cam_to_velo, "fisheye": fish}


def write_calibration(root, calibs, hp, wp):
    calib = root / "calibration"
    calib.mkdir(parents=True, exist_ok=True)
    k = calibs["k_px"].copy()
    k_right = k.copy()
    # Rectified stereo: P_rect_01 carries the baseline as -fx*b.
    k_right[0, 3] = -k[0, 0] * STEREO_BASELINE
    with open(calib / "perspective.txt", "w") as f:
        f.write(f"S_rect_00: {wp} {hp}\n")
        f.write("P_rect_00: " + " ".join(map(str, k.ravel())) + "\n")
        f.write("R_rect_00: " + " ".join(map(str, np.eye(3).ravel())) + "\n")
        f.write(f"S_rect_01: {wp} {hp}\n")
        f.write("P_rect_01: " + " ".join(map(str, k_right.ravel())) + "\n")
        f.write("R_rect_01: " + " ".join(map(str, np.eye(3).ravel())) + "\n")
    with open(calib / "calib_cam_to_pose.txt", "w") as f:
        for cam in ("image_00", "image_01", "image_02", "image_03"):
            f.write(f"{cam}: " + " ".join(
                map(str, calibs["cam_to_pose"][cam][:3].ravel())) + "\n")
    with open(calib / "calib_cam_to_velo.txt", "w") as f:
        f.write(" ".join(map(str, calibs["cam_to_velo"][:3].ravel())) + "\n")
    for name in ("image_02", "image_03"):
        with open(calib / f"{name}.yaml", "w") as f:
            f.write("%YAML:1.0\n")
            f.write(dump_yaml(fisheye_yaml_dict(calibs["fisheye"][name])))


def _yaml_scalar(value) -> str:
    """A number as yaml.safe_dump writes it."""
    if isinstance(value, (bool, np.bool_)) or \
            not isinstance(value, (int, float)):
        raise TypeError(f"dump_yaml writes numbers, not {value!r}")
    if isinstance(value, int):
        return str(value)
    if math.isnan(value):
        return ".nan"
    if math.isinf(value):
        return ".inf" if value > 0 else "-.inf"
    text = repr(value).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


def dump_yaml(data: dict, indent: int = 0) -> str:
    """Nested dicts of numbers as yaml.safe_dump writes them (keys sorted,
    two spaces per level); the port's YAML parser reads them back."""
    out = []
    for key in sorted(data):
        value = data[key]
        if isinstance(value, dict):
            out.append(" " * indent + f"{key}:\n"
                       + dump_yaml(value, indent + 2))
        else:
            out.append(" " * indent + f"{key}: {_yaml_scalar(value)}\n")
    return "".join(out)


def fisheye_yaml_dict(c):
    return {
        "mirror_parameters": {"xi": float(c["mirror_parameters"]["xi"])},
        "distortion_parameters": {
            "k1": float(c["distortion_parameters"]["k1"]),
            "k2": float(c["distortion_parameters"]["k2"])},
        "projection_parameters": {
            k: float(v) for k, v in c["projection_parameters"].items()},
        "image_height": int(c["image_height"]),
        "image_width": int(c["image_width"]),
    }


# ----------------------------------------------------------------- render
def pinhole_dirs(k_px, h, w):
    """Align-corners NDC pixel grid -> camera-frame ray dirs (h, w, 3),
    matching the loader's NDC convention (kitti_360.py:311-315). k_px must
    be the pixel intrinsics AT (h, w)."""
    k_ndc = k_px[:3, :3].copy()
    k_ndc[0, 0] = k_px[0, 0] / w * 2.0
    k_ndc[1, 1] = k_px[1, 1] / h * 2.0
    k_ndc[0, 2] = k_px[0, 2] / w * 2.0 - 1
    k_ndc[1, 2] = k_px[1, 2] / h * 2.0 - 1
    return pinhole_dirs_ndc(k_ndc, h, w)


def pinhole_dirs_ndc(k_ndc, h, w):
    """Ray dirs for a size-free NDC intrinsics matrix (any resolution)."""
    x = np.linspace(-1, 1, w)[None, :].repeat(h, 0)
    y = np.linspace(-1, 1, h)[:, None].repeat(w, 1)
    xyz = np.stack([x, y, np.ones_like(x)], -1)
    dirs = xyz @ np.linalg.inv(np.asarray(k_ndc, dtype=np.float64)).T
    return dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)


def render_image(c2w, dirs_cam, boxes):
    dirs_world = dirs_cam @ c2w[:3, :3].T
    rgb, t, hid = raycast_boxes(c2w[:3, 3], dirs_world,
                                [(b[0], b[1], b[2]) for b in boxes],
                                ground_y=GROUND_Y,
                                ground_colors=GROUND_COLORS,
                                checker_period=CHECKER_PERIOD,
                                texture_amp=TEXTURE_AMP)
    return rgb, t, hid


def write_png(path, rgb):
    _write_png(path, np.clip(rgb * 255.0, 0, 255).astype(np.uint8))


def velodyne_scan(velo_c2w, boxes, n_rings=64, n_az=1024):
    """HDL-64-style scan: points in the velodyne frame (x fwd, y left,
    z up), float32 (N, 4) with intensity 1."""
    phi = np.deg2rad(np.linspace(2.0, -24.4, n_rings))
    theta = np.linspace(-np.pi, np.pi, n_az, endpoint=False)
    ph, th = np.meshgrid(phi, theta, indexing="ij")
    dirs_velo = np.stack([np.cos(ph) * np.cos(th),
                          np.cos(ph) * np.sin(th),
                          np.sin(ph)], axis=-1).reshape(-1, 3)
    dirs_world = dirs_velo @ velo_c2w[:3, :3].T
    _, t, _ = raycast_boxes(velo_c2w[:3, 3], dirs_world,
                            [(b[0], b[1], b[2]) for b in boxes],
                            ground_y=GROUND_Y,
                            checker_period=CHECKER_PERIOD)
    keep = np.isfinite(t) & (t < 120.0)
    pts = dirs_velo[keep] * t[keep][:, None]
    return np.concatenate([pts, np.ones_like(pts[:, :1])],
                          axis=-1).astype(np.float32)


def write_bboxes(root, boxes, seq=SEQ):
    xroot = ET.Element("opencv_storage")
    inst = 0
    for lo, hi, _, sem in boxes:
        if sem not in (SEM_CAR, SEM_BUILDING):
            continue
        inst += 1
        verts = np.array([[x, y, z] for x in (lo[0], hi[0])
                          for y in (lo[1], hi[1]) for z in (lo[2], hi[2])],
                         dtype=np.float64)
        obj = ET.SubElement(xroot, "object")
        ET.SubElement(obj, "semanticId").text = str(sem)
        ET.SubElement(obj, "instanceId").text = str(inst)
        ET.SubElement(obj, "timestamp").text = "-1"
        ET.SubElement(obj, "label").text = \
            "car" if sem == SEM_CAR else "building"
        tr = ET.SubElement(obj, "transform")
        ET.SubElement(tr, "data").text = " ".join(map(str, np.eye(4).ravel()))
        vt = ET.SubElement(obj, "vertices")
        ET.SubElement(vt, "data").text = " ".join(map(str, verts.ravel()))
        fc = ET.SubElement(obj, "faces")
        ET.SubElement(fc, "data").text = " ".join(
            map(str, _CUBE_FACES.astype(np.float64).ravel()))
    bdir = root / "data_3d_bboxes" / "train_full"
    bdir.mkdir(parents=True, exist_ok=True)
    ET.ElementTree(xroot).write(bdir / f"{seq}.xml")


# ------------------------------------------------------------------- tree
def generate_tree(out, n_frames=60, hp=HP_REF, wp=WP_REF, hf=HF_REF,
                  wf=WF_REF, seed=0, dz=1.0, n_az=1024,
                  test_keyframes=None, seq=SEQ, splits="write"):
    """Write the full tree. Returns (calibs, poses, boxes) for tests.

    Multi-sequence trees: call repeatedly with distinct (seq, seed) into
    the same `out` (the shared rig calibration is identical and simply
    rewritten). splits: "write" creates splits/ for this sequence alone,
    "append" adds this sequence's lines to existing split files,
    "train-only"/"test-only" route every keyframe of the sequence to one
    split (held-out-sequence benchmarks), "none" skips split writing."""
    out = Path(out)
    root = out
    rng = np.random.default_rng(seed)
    boxes = build_scene(rng, n_frames * dz)
    calibs = make_calibs(hp, wp, hf, wf)
    write_calibration(root, calibs, hp, wp)
    write_bboxes(root, boxes, seq)

    # Body poses: gentle lateral sway along a straight street-aligned
    # drive; all rotation lives in calib_cam_to_pose.
    poses = []
    for i in range(n_frames):
        p = np.eye(4)
        p[0, 3] = 0.3 * np.sin(i * 0.15)
        p[2, 3] = i * dz
        poses.append(p)
    poses = np.stack(poses)
    pose_dir = out / "data_poses" / seq
    pose_dir.mkdir(parents=True, exist_ok=True)
    with open(pose_dir / "poses.txt", "w") as f:
        for i, p in enumerate(poses):
            f.write(f"{i} " + " ".join(map(str, p[:3].ravel())) + "\n")

    seq_dir = root / "data_2d_raw" / seq
    dirs_p = pinhole_dirs(calibs["k_px"], hp, wp)
    fish_dirs = {}
    for cam in ("image_02", "image_03"):
        d, valid = mei_backproject(calibs["fisheye"][cam])
        fish_dirs[cam] = (d, valid)

    sem_dir = (root / "data_2d_semantics" / "train" / seq
               / "image_00")
    (sem_dir / "semantic").mkdir(parents=True, exist_ok=True)
    (sem_dir / "semantic_rgb").mkdir(parents=True, exist_ok=True)
    velo_dir = root / "data_3d_raw" / seq / "velodyne_points" / "data"
    velo_dir.mkdir(parents=True, exist_ok=True)
    for cam, sub in (("image_00", "data_rect"), ("image_01", "data_rect"),
                     ("image_02", "data_rgb"), ("image_03", "data_rgb")):
        (seq_dir / cam / sub).mkdir(parents=True, exist_ok=True)

    t_velo_to_pose = (calibs["cam_to_pose"]["image_00"]
                      @ np.linalg.inv(calibs["cam_to_velo"]))
    for i in range(n_frames):
        for cam, sub in (("image_00", "data_rect"),
                         ("image_01", "data_rect")):
            c2w = poses[i] @ calibs["cam_to_pose"][cam]
            rgb, _, hid = render_image(c2w, dirs_p, boxes)
            write_png(seq_dir / cam / sub / f"{i:010d}.png", rgb)
            if cam == "image_00":
                sem = semantic_of_hit(hid, boxes)
                _write_png(sem_dir / "semantic" / f"{i:010d}.png", sem)
                _write_png(sem_dir / "semantic_rgb" / f"{i:010d}.png",
                           np.stack([sem] * 3, -1))
        for cam in ("image_02", "image_03"):
            c2w = poses[i] @ calibs["cam_to_pose"][cam]
            d, valid = fish_dirs[cam]
            rgb, _, _ = render_image(c2w, d, boxes)
            rgb = np.where(valid[..., None], rgb, 0.0)
            write_png(seq_dir / cam / "data_rgb" / f"{i:010d}.png", rgb)
        scan = velodyne_scan(poses[i] @ t_velo_to_pose, boxes, n_az=n_az)
        scan.tofile(str(velo_dir / f"{i:010d}.bin"))

    if splits != "none":
        split = root / "splits"
        split.mkdir(exist_ok=True)
        if test_keyframes is None:
            test_keyframes = list(range(2, max(3, n_frames - 22), 6))
        if splits == "train-only":
            test_keyframes = []
        train_keyframes = [i for i in range(1, n_frames - 1)
                           if i not in test_keyframes]
        if splits == "test-only":
            # Every keyframe with a full 20-step LiDAR window ahead.
            test_keyframes = list(range(2, max(3, n_frames - 22), 3))
            train_keyframes = []
        # Single-sequence "write" truncates; the multi-sequence modes
        # (append / train-only / test-only) compose into existing files.
        mode = "w" if splits == "write" else "a"
        with open(split / "test_files.txt", mode) as f:
            for i in test_keyframes:
                f.write(f"{seq} {i} l\n")
        with open(split / "train_files.txt", mode) as f:
            for i in train_keyframes:
                f.write(f"{seq} {i} l\n")
                f.write(f"{seq} {i} r\n")
    return calibs, poses, boxes


def write_splits(out, seq, test_keyframes, n_frames, name="splits"):
    """<out>/<name>/test_files.txt with the left view of each test
    keyframe, and train_files.txt with both views of every other frame
    with a neighbour on each side (as generate_tree's "write" mode)."""
    split = Path(out) / name
    split.mkdir(parents=True, exist_ok=True)
    with open(split / "test_files.txt", "w") as f:
        f.writelines(f"{seq} {i} l\n" for i in test_keyframes)
    with open(split / "train_files.txt", "w") as f:
        for i in range(1, n_frames - 1):
            if i not in test_keyframes:
                f.write(f"{seq} {i} l\n{seq} {i} r\n")


def make_gate_tree(out, frames=GATE_FRAMES, scale=GATE_SCALE,
                   seed=GATE_SEED, keyframes=GATE_KEYFRAMES):
    """The JAX package's occupancy gate tree (tests/test_occupancy_gate.py:
    28-63): `frames` frames of GATE_SEQ from `seed` at `scale` of the
    reference resolution, the perspective frames preprocessed to 192x640
    (`preprocess_kitti_360.preprocess`), the test split of `keyframes`
    and a training split of the other frames in splits/. Returns `out`."""
    from behindthescenes_tpu_torch.datasets.preprocess_kitti_360 import \
        preprocess
    generate_tree(out, n_frames=frames, seed=seed, seq=GATE_SEQ,
                  splits="none", hp=int(round(HP_REF * scale)),
                  wp=int(round(WP_REF * scale)),
                  hf=int(round(HF_REF * scale)),
                  wf=int(round(WF_REF * scale)))
    preprocess(out)
    write_splits(out, GATE_SEQ, list(keyframes), frames)
    return out


def main():
    ap = argparse.ArgumentParser("synthetic KITTI-360 drive generator")
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seq", default=SEQ,
                    help="sequence directory name (vary for multi-sequence"
                         " trees)")
    ap.add_argument("--splits", default="write",
                    choices=["write", "append", "train-only", "test-only",
                             "none"],
                    help="split handling; 'append'/'train-only'/'test-only'"
                         " compose multi-sequence held-out benchmarks")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="resolution scale for the rendered assets (0.5 = "
                         "half the reference resolution, ~4x faster "
                         "raycasting; intrinsics scale with it and "
                         "preprocess_kitti_360 still resizes to the "
                         "training resolution, so the pipeline semantics "
                         "are unchanged)")
    args = ap.parse_args()
    s = args.scale
    generate_tree(args.out, n_frames=args.frames, seed=args.seed,
                  seq=args.seq, splits=args.splits,
                  hp=int(round(HP_REF * s)), wp=int(round(WP_REF * s)),
                  hf=int(round(HF_REF * s)), wf=int(round(WF_REF * s)))
    print(f"wrote {args.frames}-frame drive {args.seq} to {args.out}"
          f" at scale {s}")


if __name__ == "__main__":
    main()
