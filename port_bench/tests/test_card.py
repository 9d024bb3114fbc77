"""On the card: each cell's command end to end, a short window. Skips
where no card is found (the look happens inside the test)."""
import json
import os
import subprocess
import sys

import pytest
import torch

from port_bench.tests.test_cells import BENCH, CELLS, ROOT


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(workload):
    chips = next(w["chips"] for w in BENCH["workloads"]
                 if w["name"] == workload)
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    if torch.cuda.device_count() < chips:
        pytest.skip(f"{workload} needs {chips} CUDA cards")
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", workload,
         "--seed", "2147483999", "--seconds", "3", "--trace", "1"],
        cwd=ROOT, env=dict(os.environ), capture_output=True, text=True,
        timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["check"]
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    wanted = {m["name"] for m in BENCH["per_layer"]
              if "workloads" not in m or workload in m["workloads"]}
    assert set(line["metrics"]) <= wanted and line["metrics"]
