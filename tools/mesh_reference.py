"""The JAX package's mesh of the example image, measured on the CPU:
media/reference/mesh_k360.npz, which `chip_smoke.py` phase 26 holds the
port's `utils/recon.py` to.

    JAX_PLATFORMS=cpu python3 tools/mesh_reference.py

The KITTI raw demo model (configs/exp_kitti_raw.yaml) with
media/weights/k360_synth_conv.npz in f32, media/example/0000.png resized
to 192x640 (OpenCV's INTER_LINEAR) and encoded at the demo's intrinsics
(scripts/inference_setup.py), then the density on the 64^3 grid of the
JAX package's `utils/recon.extract_mesh_from_density` (its ranges, its
chunks of 50,000 points) and that function's mesh. Writes the volume
(float32) and the mesh's triangle and vertex counts; prints one JSON
line. Needs JAX beside the port (the test environment).
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "media", "reference", "mesh_k360.npz")
RESOLUTION = 64
QUERY_BATCH = 50000


def main():
    import cv2
    import jax.numpy as jnp
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import inference_setup as jiset
    from behindthescenes_tpu.config import find_config, load_config
    from behindthescenes_tpu.models.bts import BTSNet
    from behindthescenes_tpu.utils import recon
    from behindthescenes_tpu.utils.io import load_params_npz, read_image
    t0 = time.perf_counter()
    config = load_config(find_config("exp_kitti_raw"))
    net = BTSNet.from_conf(config["model_conf"], compute_dtype=jnp.float32)
    variables = load_params_npz(os.path.join(ROOT, "media", "weights",
                                             "k360_synth_conv.npz"))
    h, w = jiset.DEFAULT_RESOLUTION["kitti_raw"]
    img = cv2.resize(read_image(os.path.join(ROOT, "media", "example",
                                             "0000.png")), (w, h),
                     interpolation=cv2.INTER_LINEAR)
    grid, _, _ = jiset.encode_image(net, variables, img,
                                    *jiset.DEFAULT_INTRINSICS["kitti_raw"])
    axes = [np.linspace(*r, RESOLUTION)
            for r in ((-10, 10), (-5, 2), (3, 40))]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1) \
        .reshape(-1, 3).astype(np.float32)
    sigma = np.concatenate([np.asarray(net.apply(
        variables, grid, jnp.asarray(pts[i:i + QUERY_BATCH])[None],
        only_density=True, method=BTSNet.query)[2][0, :, 0])
        for i in range(0, len(pts), QUERY_BATCH)]).reshape((RESOLUTION,) * 3)
    verts, faces = recon.extract_mesh_from_density(
        net, variables, grid, resolution=RESOLUTION, query_batch=QUERY_BATCH)
    np.savez_compressed(OUT, sigma=sigma.astype(np.float32),
                        triangles=np.int64(len(faces)),
                        vertices=np.int64(len(verts)))
    print(json.dumps({"out": os.path.relpath(OUT, ROOT),
                      "triangles": int(len(faces)),
                      "vertices": int(len(verts)),
                      "sigma_max": float(sigma.max()),
                      "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
