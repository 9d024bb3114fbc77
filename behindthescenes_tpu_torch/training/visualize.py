"""Training visualisation grids (counterpart of
behindthescenes_tpu/training/visualize.py:17-94; reference
models/bts/trainer.py:430-506): input images, reconstructions, depth
maps, density profiles, ray entropy, alpha sums and invalid masks, written
to TensorBoard. The grids are numpy, on the host."""
from __future__ import annotations

import math

import numpy as np
import torch

from behindthescenes_tpu_torch.utils.plotting import color_tensor, make_grid


def _np(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if torch.is_tensor(x) \
        else np.asarray(x)


def build_visualization_images(data: dict, z_near: float,
                               z_far: float) -> dict:
    """data: a reconstructed eval render dict (coarse / fine lists of
    (n, v, h, w, ...) tensors) with "imgs". Returns {name: (h', w', 3)
    numpy image}."""
    images = _np(data["imgs"])[0]                        # (v, h, w, 3)
    fine_0, coarse_0 = data["fine"][0], data["coarse"][0]
    recon_imgs = _np(fine_0["rgb"])[0]                   # (v, h, w, vr, 3)
    recon_depths = [_np(f["depth"])[0] for f in data["fine"]]
    alphas = _np(coarse_0["alphas"])[0]                  # (v, h, w, K)
    invalids = _np(coarse_0["invalid"])[0]               # (v, h, w, K, vr)

    take_n = min(images.shape[0], 6)
    nrow = int(take_n ** 0.5)
    imgs01 = images[:take_n] * 0.5 + 0.5
    recon = recon_imgs[:take_n].mean(-2)
    recon_mse = np.clip(((imgs01 - np.clip(recon, 0, 1)) ** 2 / 2)
                        .mean(-1), 0, 1)
    out = {
        "input_im": make_grid(imgs01, nrow),
        "recon_im": make_grid(np.clip(recon, 0, 1), nrow),
        "recon_mse": make_grid(color_tensor(recon_mse, "plasma"), nrow),
    }
    for i, d in enumerate(recon_depths):
        dn = (1 / np.clip(d[:take_n], 1e-6, None) - 1 / z_far) \
            / (1 / z_near - 1 / z_far)
        out[f"recon_depth_{i}"] = make_grid(
            color_tensor(np.clip(dn, 0, 1), "plasma"), nrow)

    # Horizontal density-profile slices at 1/4, 1/2 and 3/4 of the height.
    h = alphas.shape[1]
    prof = alphas[:take_n][:, [h // 4, h // 2, 3 * h // 4]]
    prof = prof.reshape(take_n * 3, prof.shape[2], -1).transpose(0, 2, 1)
    prof = np.clip(prof, 0, None) / max(prof.max(), 1e-6)
    out["depth_profile"] = make_grid(color_tensor(prof, "plasma"), nrow)

    al = alphas[:take_n] + 1e-5
    ray_density = al / al.sum(-1, keepdims=True)
    ray_entropy = -(ray_density * np.log(ray_density)).sum(-1) \
        / math.log2(al.shape[-1])
    out["ray_entropy"] = make_grid(color_tensor(ray_entropy, "plasma"), nrow)
    alpha_sum = np.clip(al.sum(-1) / al.shape[-1], 0, 1)
    out["alpha_sum"] = make_grid(color_tensor(alpha_sum, "plasma"), nrow)
    inv = invalids[:take_n].mean(-1).mean(-1)
    out["invalids"] = make_grid(color_tensor(inv, "plasma"), nrow)
    return out


def make_tb_visualizer(writer):
    """A visualize(trainer, vis_loader, step) hook for the run harness that
    renders the loader's first batch in eval mode (the draws from a
    generator seeded with the step, as JAX's PRNGKey(step)) and writes
    the grids to the TensorBoard writer."""

    @torch.no_grad()
    def visualize(trainer, vis_loader, step):
        batch = next(iter(vis_loader))
        batch = {k: torch.as_tensor(v, device=trainer.device)
                 for k, v in batch.items() if v is not None}
        gen = torch.Generator(device=trainer.device)
        gen.manual_seed(step)
        ids = trainer.wrapper.select_views(
            trainer.np_rng, batch["imgs"].shape[1], training=False)
        data = trainer.wrapper.forward(batch, ids, train=False,
                                       generator=gen)
        data["imgs"] = batch["imgs"]
        grids = build_visualization_images(
            data, trainer.wrapper.z_near, trainer.wrapper.z_far)
        for name, img in grids.items():
            writer.add_image(f"vis/{name}", img, global_step=step,
                             dataformats="HWC")
        writer.flush()

    return visualize
