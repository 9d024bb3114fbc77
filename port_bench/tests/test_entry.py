"""The command's contract on a machine without a card, and the look for
JAX in a run's process."""
import os
import subprocess
import sys

from port_bench import harness
from port_bench.tests import tiny

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_no_card_exits_nonzero_without_a_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "kitti360.depth", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


RUN_AND_LIST = """
import json, sys, torch
torch.set_num_threads(1)
from port_bench import harness
from port_bench.tests import tiny
for w in ("kitti360.train", "kitti360.depth"):
    over, mix = tiny.cut(w, bf16=False)
    harness.run(w, tiny.SEED, 0.2, True, device="cpu", overrides=over,
                mix_overrides=mix)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_run_loads_no_jax():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", RUN_AND_LIST], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    tops = set(__import__("json").loads(proc.stdout.splitlines()[-1]))
    assert "behindthescenes_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_forbidden_names_compare_the_whole_top_level():
    saved = dict(sys.modules)
    try:
        sys.modules["behindthescenes_tpu_torch_fake"] = sys
        assert harness.forbidden_modules() == [] or all(
            m.split(".")[0] in harness.FORBIDDEN
            for m in harness.forbidden_modules())
        sys.modules["jaxlib.fake"] = sys
        assert "jaxlib.fake" in harness.forbidden_modules()
        assert "behindthescenes_tpu_torch_fake" not in \
            harness.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_tiny_cut_keeps_the_widths():
    over, _ = tiny.cut("kitti360.train")
    assert "encoder" not in over.get("model_conf", {})
    assert "mlp_coarse" not in over.get("model_conf", {})
