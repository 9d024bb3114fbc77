"""The port's and the JAX package's keyframe depth of `-cn
eval_kitti_360_depth` on the CPU, keyframe by keyframe, in the config's
bf16 and in float32: each side's abs_rel and a1 and how far the two
depth maps lie apart. It tells bf16's share of the gap between the
port's means and JAX's (`chip_smoke.py` phase 27) from the rest.

    JAX_PLATFORMS=cpu python3 tools/k360_depth_vs_jax.py [--tree DIR]

Builds the gate drive of phase 27 (`make_gate_tree`, the fisheye frames
at rotation [0, -15]) unless --tree names one. Each test keyframe goes
through both evaluators' self-view depth (the deterministic shared-z
ladder, so nothing is drawn) with media/weights/k360_synth_conv.npz at
192x640 and 64 samples, once with the config's `bf16: true` and once
with `bf16=false`. Prints one JSON line. Needs JAX beside the port (the
test environment).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from k360_eval_reference import FISHEYE_ROTATION, WEIGHTS, tree_overrides

CONFIG = "eval_kitti_360_depth"


def depth_maps(tree: str, bf16: bool) -> dict:
    """{keyframe: (JAX's depth, the port's depth, the batch, JAX's
    evaluator, the port's)}, the depths (h, w) float64, both evaluators
    built from the config as their task runners build them."""
    import jax
    import jax.numpy as jnp
    import torch
    from behindthescenes_tpu import config as jconfig
    from behindthescenes_tpu.datasets.factory import make_test_dataset
    from behindthescenes_tpu.evaluation import tasks as jtasks
    from behindthescenes_tpu.evaluation.depth import DepthEvaluator as JDE
    from behindthescenes_tpu.utils.io import load_params_npz
    from behindthescenes_tpu_torch import config as tconfig
    from behindthescenes_tpu_torch.evaluation import tasks as ttasks
    from behindthescenes_tpu_torch.evaluation.depth import \
        DepthEvaluator as TDE
    args = [f"checkpoint={WEIGHTS}", f"bf16={str(bf16).lower()}",
            *tree_overrides(tree)]
    jconf = jconfig.load_config(jconfig.find_config(CONFIG),
                                jconfig.parse_cli_overrides(args))
    tconf = tconfig.load_config(tconfig.find_config(CONFIG),
                                tconfig.parse_cli_overrides(args))
    ds = make_test_dataset(jconf["data"])
    ds.return_depth = True
    jnet, jrcfg = jtasks._net_and_cfg(jconf)
    jev = JDE(jnet, jrcfg, jconf["model_conf"])
    variables = load_params_npz(WEIGHTS)
    tnet, trcfg = ttasks._net_and_cfg(tconf, "cpu")
    tev = TDE(tnet, trcfg, tconf["model_conf"])
    out = {}
    for i in range(len(ds)):
        batch = {k: np.asarray(v)[None] for k, v in ds[i].items()
                 if k in ("imgs", "poses", "projs", "depths")}
        h, w = batch["imgs"].shape[2:4]
        render = jev._build_render_selfview(h, w)
        want = render(variables, *(jnp.asarray(batch[k]) for k in
                                   ("imgs", "projs", "poses")),
                      jax.random.PRNGKey(i))
        got = tev.render(*(torch.as_tensor(batch[k]) for k in
                           ("imgs", "projs", "poses")))
        out[i] = (np.asarray(want, np.float64)[0],
                  got.float().numpy().astype(np.float64)[0], batch, jev,
                  tev)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None)
    args = ap.parse_args()
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="k360_depth_") as tmp:
        tree = args.tree
        if tree is None:
            from behindthescenes_tpu_torch.datasets.gen_synthetic_kitti_360 \
                import make_gate_tree
            tree = make_gate_tree(os.path.join(tmp, "tree"),
                                  fisheye_rotation=FISHEYE_ROTATION)
        out["tree_seconds"] = time.perf_counter() - t0
        for bf16 in (True, False):
            t = time.perf_counter()
            rows = []
            for i, (want, got, batch, jev, tev) in depth_maps(
                    str(tree), bf16).items():
                rel = np.abs(got - want) / want
                mj = jev.compute_depth_metrics(want[None, None],
                                               batch["depths"])
                mt = tev.compute_depth_metrics(got[None, None],
                                               batch["depths"])
                rows.append({
                    "keyframe": i, "jax": {k: mj[k] for k in ("abs_rel",
                                                              "a1")},
                    "port": {k: mt[k] for k in ("abs_rel", "a1")},
                    "depth_max_rel": float(rel.max()),
                    "depth_mean_rel": float(rel.mean()),
                    "depth_share_over_1e-2": float(np.mean(rel > 1e-2))})
            out["bf16" if bf16 else "f32"] = {
                "per_keyframe": rows, "seconds": time.perf_counter() - t}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
