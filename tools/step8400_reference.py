"""The JAX package's means of the converged synthetic checkpoint
(media/weights/synthetic_conv_step8400.npz) through its config-driven
evaluation on the CPU: the reference that `chip_smoke.py` phase 12 holds
the port's `eval_synthetic` and `eval_synthetic_nvs` rows to.

    JAX_PLATFORMS=cpu python3 tools/step8400_reference.py

Runs the JAX package's `evaluation.tasks.evaluate_depth` on
configs/eval_synthetic.yaml and `evaluate_nvs` on
configs/eval_synthetic_nvs.yaml with that checkpoint and the configs' own
settings (4 scenes at 48x64, 24 samples, bf16), as `python eval.py -cn
<config> checkpoint=<npz>` does, and prints one JSON line with each
config's means and the seconds it took. Needs JAX beside the port (the
test environment).
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

WEIGHTS = os.path.join(ROOT, "media", "weights",
                       "synthetic_conv_step8400.npz")
CONFIGS = (("eval_synthetic", "evaluate_depth", ("abs_rel", "a1")),
           ("eval_synthetic_nvs", "evaluate_nvs", ("psnr", "ssim")))


def jax_means(name: str, task: str) -> dict:
    """configs/NAME.yaml with WEIGHTS through the JAX package's task."""
    from behindthescenes_tpu.config import (find_config, load_config,
                                            parse_cli_overrides)
    from behindthescenes_tpu.evaluation import tasks
    conf = load_config(find_config(name),
                       parse_cli_overrides([f"checkpoint={WEIGHTS}"]))
    return {k: float(v) for k, v in getattr(tasks, task)(conf).items()}


def main() -> None:
    out = {}
    for name, task, keys in CONFIGS:
        t = time.perf_counter()
        means = jax_means(name, task)
        out[name] = {**{k: means[k] for k in keys},
                     "seconds": time.perf_counter() - t}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
