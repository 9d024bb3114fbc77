"""Shared setup of the image demos and the video scripts (counterpart of
the repository's scripts/inference_setup.py; reference
scripts/inference_setup.py:100-229): a model family's config and
checkpoint, the encode of one image, its depth map and its top-down
(BEV) density profile; a video script's model and test items, its
per-pose draws and its writer. The model computes in bf16, as the JAX
demos' does."""
from __future__ import annotations

import os

import numpy as np
import torch

from behindthescenes_tpu_torch import inference
from behindthescenes_tpu_torch.config import (find_config, load_config,
                                              parse_cli_overrides)
from behindthescenes_tpu_torch.datasets.factory import make_test_dataset
from behindthescenes_tpu_torch.evaluation.tasks import _net_and_cfg
from behindthescenes_tpu_torch.models.bts import BTSNet
from behindthescenes_tpu_torch.utils.plotting import color_tensor
from behindthescenes_tpu_torch.utils.video import write_video

# NDC intrinsics (fx, fy) and resolution (h, w) of each model family
# (reference gen_img_custom.py:54-95).
DEFAULT_INTRINSICS = {
    "kitti_raw": (0.9185, 2.9477),     # the 192x640 KITTI crop
    "kitti_360": (0.7849, 2.9477),
    "re10k": (1.5, 2.25),
    "synthetic": (1.2, 1.6),           # datasets/synthetic.py
}
DEFAULT_RESOLUTION = {
    "kitti_raw": (192, 640),
    "kitti_360": (192, 640),
    "re10k": (256, 384),
    "synthetic": (48, 64),
}


def setup_model(model_name: str, checkpoint: str | None = None,
                config_name: str | None = None, device=None, overrides=()):
    """configs/<config_name or exp_<model_name>>.yaml's model in bf16 with
    the checkpoint (a committed `.npz`, a run or step directory, a
    reference `.pt`; None keeps the eval tasks' seeded random init) on
    `device` (default: the card), the config read with the `key=value`
    overrides. Returns (net, renderer config, config)."""
    config = load_config(find_config(config_name or f"exp_{model_name}"),
                         parse_cli_overrides(list(overrides)))
    if checkpoint:
        config["checkpoint"] = checkpoint
    config["bf16"] = True
    net, rcfg = _net_and_cfg(config, device)
    return net, rcfg, config


def setup_video(args):
    """A video script's model and data from its arguments (config_name,
    checkpoint, device, overrides): (net, renderer config, the config's
    test dataset, z_near, z_far, the net's device)."""
    net, rcfg, config = setup_model(
        args.config_name.replace("exp_", ""), args.checkpoint,
        config_name=args.config_name, device=args.device,
        overrides=args.overrides)
    mc = config["model_conf"]
    return (net, rcfg, make_test_dataset(config["data"]), mc["z_near"],
            mc["z_far"], next(net.parameters()).device)


def load_item(ds, index: int, device):
    """A test item's images, poses and projections as batch-1 tensors."""
    item = ds[index]
    return item, tuple(torch.as_tensor(item[k][None], device=device)
                       for k in ("imgs", "poses", "projs"))


def pose_draws(draws, i: int, device) -> dict:
    """render_poses' keywords for pose i: `draws(i)` (a dict of z_jitter
    and fine_draws) where given, else a generator seeded with i (the
    JAX scripts' PRNGKey(i))."""
    if draws is not None:
        return draws(i)
    gen = torch.Generator(device=device)
    gen.manual_seed(i)
    return {"generator": gen}


def save(args, frames: list) -> None:
    """Write a video script's frames to args.out as a Motion-JPEG AVI."""
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    write_video(args.out, frames, fps=args.fps)
    print(f"wrote {args.out} ({len(frames)} frames)")


def encode_image(net: BTSNet, img: np.ndarray, fx: float, fy: float):
    """img (h, w, 3) in [0, 1] -> the feature grid of it as view 0 at the
    identity pose with intrinsics diag(fx, fy, 1)."""
    dev = next(net.parameters()).device
    images = torch.as_tensor(img[None, None] * 2.0 - 1.0,
                             dtype=torch.float32, device=dev)
    poses = torch.eye(4, device=dev)[None, None]
    projs = torch.tensor([[fx, 0, 0], [0, fy, 0], [0, 0, 1.0]],
                         device=dev)[None, None]
    return net.encode(images, projs, poses, ids_encoder=[0], ids_render=[0])


@torch.no_grad()
def render_depth(net: BTSNet, grid, rcfg, h: int, w: int, z_near: float,
                 z_far: float, seed: int = 0, z_samp=None) -> np.ndarray:
    """The (h, w) expected z-depth of the encoded view through the
    jittered self-view path, the jitter from a generator seeded with
    `seed` unless z_samp (h*w, K) is given."""
    gen = torch.Generator(device=grid.f_ks.device)
    gen.manual_seed(seed)
    depth, _, _ = inference.render_depth_selfview(
        net, grid, h, w, rcfg, z_near, z_far, generator=gen, z_samp=z_samp)
    return depth[0].float().cpu().numpy()


@torch.no_grad()
def render_profile(net: BTSNet, grid, **kwargs):
    """inference.render_profile as float32 numpy (profile, sigma)."""
    profile, sigma = inference.render_profile(net, grid, **kwargs)
    return (profile.float().cpu().numpy(), sigma.float().cpu().numpy())


def depth_to_colormap(depth, z_near: float, z_far: float,
                      cmap: str = "magma") -> np.ndarray:
    """Inverse depth normalised to [near, far], through the colormap."""
    inv = (1 / np.clip(depth, 1e-6, None) - 1 / z_far) \
        / (1 / z_near - 1 / z_far)
    return color_tensor(np.clip(inv, 0, 1), cmap)
