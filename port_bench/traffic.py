"""The benchmark's one generator: it reads a traffic mix
(`traffic/<mix>.json`) and a configuration's data block
(`configs/<config>.json`, key "data") and makes every input of a run on
the device from the seed: camera images, the rig's calibration and poses,
and the draws of each training step.

A mix is parameters only. "loop" says how the cell drives the program:
"train" (closed loop of training micro-steps over a pool of batches),
"depth_stream" (one client that keeps `in_flight` frames in flight) or
"train_dp" (the training loop on `ranks` data-parallel ranks, each with
a pool of its own).
"""
from __future__ import annotations

import json
import math
import os

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
# A rank's pool is seeded with seed + 1 + rank * RANK_STRIDE, a prime near
# 2**32 / golden ratio: the CPU's generator keeps a seed's low 32 bits
# only, in which the ranks' seeds still differ from each other's and
# from the run's other seeds.
RANK_STRIDE = 0x9E3779B1


def load_json(kind: str, name: str) -> dict:
    """`<kind>/<name>.json` under the benchmark's folder."""
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def _rot(yaw_deg: float, pitch_deg: float, device) -> torch.Tensor:
    """Camera-to-car rotation: yaw about the down axis (y), then pitch
    about x; the camera looks along +z, x right, y down."""
    y, p = math.radians(yaw_deg), math.radians(pitch_deg)
    r_y = torch.tensor([[math.cos(y), 0.0, math.sin(y)], [0.0, 1.0, 0.0],
                        [-math.sin(y), 0.0, math.cos(y)]])
    r_x = torch.tensor([[1.0, 0.0, 0.0], [0.0, math.cos(p), -math.sin(p)],
                        [0.0, math.sin(p), math.cos(p)]])
    return (r_y @ r_x).to(device)


def rig_to_car(data: dict, device) -> tuple:
    """(camera-to-car poses (c, 4, 4), NDC intrinsics (c, 3, 3)) of the
    rig's cameras."""
    poses, projs = [], []
    for cam in data["cameras"]:
        t = torch.eye(4, device=device)
        t[:3, :3] = _rot(cam.get("yaw_deg", 0.0), cam.get("pitch_deg", 0.0),
                         device)
        t[:3, 3] = torch.tensor(cam.get("t", [0.0, 0.0, 0.0]), device=device)
        poses.append(t)
        projs.append(torch.tensor(cam["proj"], device=device))
    return torch.stack(poses), torch.stack(projs)


def smooth_images(n: int, h: int, w: int, gen, device) -> torch.Tensor:
    """(n, h, w, 3) in [-1, 1]: coarse noise at an eighth of the size,
    upsampled bilinearly, with a little fine noise on top, so that patches
    have structure for SSIM and flat stretches for the smoothness term."""
    coarse = torch.randn((n, 3, max(h // 8, 2), max(w // 8, 2)),
                         generator=gen, device=device)
    img = torch.nn.functional.interpolate(coarse, size=(h, w),
                                          mode="bilinear",
                                          align_corners=False)
    img = img + 0.1 * torch.randn((n, 3, h, w), generator=gen, device=device)
    return torch.tanh(img).permute(0, 2, 3, 1).contiguous()


def _uniform(shape, lo: float, hi: float, gen, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def car_poses(data: dict, n: int, steps: int, gen, device) -> torch.Tensor:
    """(n, steps, 4, 4) car-to-world poses at frames 0..steps-1: each item
    drives forward by a drawn step each frame and turns by a drawn yaw."""
    m = data["motion"]
    fwd = _uniform((n, steps), *m["forward_m"], gen, device)
    side = _uniform((n, steps), *m.get("side_m", [0.0, 0.0]), gen, device)
    yaw = _uniform((n, steps), *m["yaw_deg"], gen, device).cpu()
    out = torch.eye(4, device=device).repeat(n, steps, 1, 1)
    for i in range(n):
        pose = torch.eye(4, device=device)
        for f in range(steps):
            out[i, f] = pose
            step = torch.eye(4, device=device)
            step[:3, :3] = _rot(float(yaw[i, f]), 0.0, device)
            step[0, 3], step[2, 3] = side[i, f], fwd[i, f]
            pose = pose @ step
    return out


def make_batch(data: dict, n: int, gen, device) -> dict:
    """One training batch of n items: imgs (n, v, h, w, 3) in [-1, 1],
    poses (n, v, 4, 4) camera-to-world, projs (n, v, 3, 3), the views in
    the loader's order (every frame of the first camera, then the next
    camera's). A camera's "frame_offset" takes its frames that many
    frames later, as the rig's fisheyes are."""
    h, w = data["image_size"]
    to_car, projs = rig_to_car(data, device)
    frames = data["frames"]
    offsets = [c.get("frame_offset", 0) for c in data["cameras"]]
    car = car_poses(data, n, max(offsets) + frames, gen, device)
    poses = torch.stack([car[:, o:o + frames] @ to_car[c]
                         for c, o in enumerate(offsets)], 1)
    cams = len(offsets)
    v = cams * frames
    return {"imgs": smooth_images(n * v, h, w, gen, device)
            .reshape(n, v, h, w, 3),
            "poses": poses.reshape(n, v, 4, 4),
            "projs": projs[:, None].expand(cams, frames, 3, 3)
            .reshape(1, v, 3, 3).expand(n, v, 3, 3).contiguous()}


def make_draws(conf: dict, n: int, n_loss: int, gen, device) -> dict:
    """The random choices of one training micro-step: "flip" (bool),
    patch "views" (among the loss views), "ys", "xs" (n, pc) int64, the
    coarse "z_jitter" (n, R, K) in [0, 1) and, after them where the
    renderer has a fine pass, its "fine_u" and "fine_jitter" (n, R,
    n_fine - n_fine_depth) in [0, 1) and "fine_normals" (n, R,
    n_fine_depth) standard normal."""
    mc, rc = conf["model_conf"], conf["renderer"]
    h, w = conf["data"]["image_size"]
    p, rays = mc["patch_size"], mc["ray_batch_size"]
    pc = rays // (p * p)

    def randint(high):
        return torch.randint(0, high, (n, pc), generator=gen, device=device)
    draws = {"flip": bool(torch.rand((), generator=gen, device=device) > 0.5)
             if mc.get("flip_augmentation", False) else False,
             "views": randint(n_loss), "ys": randint(h - p),
             "xs": randint(w - p),
             "z_jitter": torch.rand((n, rays, rc["n_coarse"]),
                                    generator=gen, device=device)}
    n_fine, n_depth = rc.get("n_fine", 0), rc.get("n_fine_depth", 0)
    if n_fine > 0:
        for key in ("fine_u", "fine_jitter"):
            draws[key] = torch.rand((n, rays, n_fine - n_depth),
                                    generator=gen, device=device)
        draws["fine_normals"] = torch.randn((n, rays, n_depth),
                                            generator=gen, device=device)
    return draws


def n_loss_views(conf: dict) -> int:
    """How many loss views every step of this configuration has."""
    mode = conf["model_conf"]["frame_sample_mode"]
    v = len(conf["data"]["cameras"]) * conf["data"]["frames"]
    if mode == "kitti360-mono":
        return 4 * ((v // 4) // 2)
    if mode == "default":
        return v - len([i for i in range(conf["model_conf"]
                                         ["n_frames_render"]) if i < v])
    raise NotImplementedError(mode)


def train_pool(conf: dict, mix: dict, seed: int, device,
               rank: int = 0) -> list:
    """`mix["pool"]` (batch, draws) pairs, all different, from the seed
    and the data-parallel rank whose rows they are (rank 0's are the
    one-card cells' own)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1 + rank * RANK_STRIDE)
    n = conf["batch_size"]
    nl = n_loss_views(conf)
    return [(make_batch(conf["data"], n, gen, device),
             make_draws(conf, n, nl, gen, device))
            for _ in range(mix["pool"])]


def frame_pool(conf: dict, mix: dict, seed: int, device) -> dict:
    """A stream's distinct frames: imgs (pool, h, w, 3) in [-1, 1] of the
    rig's camera `mix["camera"]` and its intrinsics (3, 3)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    h, w = conf["data"]["image_size"]
    _, projs = rig_to_car(conf["data"], device)
    return {"imgs": smooth_images(mix["pool"], h, w, gen, device),
            "proj": projs[mix.get("camera", 0)]}
