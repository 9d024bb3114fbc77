"""Each cell end to end on the CPU at a tiny size, through the kernels'
plain versions, with the program in float32 (the check then holds it to
the reference well inside every limit); and the shape of the result."""
import json
import os

import pytest

from port_bench import harness
from port_bench.tests import tiny

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_is_correct(workload, trace):
    over, mix = tiny.cut(workload, bf16=False)
    result, split = harness.run(workload, tiny.SEED, 1.0, bool(trace),
                                device="cpu", overrides=over,
                                mix_overrides=mix)
    assert list(result)[:5] == KEYS
    assert list(result)[-1] == "check"
    assert result["correct"] is True, result["check"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    for name, c in result["check"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    assert set(split) == {"imports", "cuda_init", "kernel_library",
                          "weights", "program", "inputs", "warm_up"}
    line = json.loads(json.dumps(result))
    assert line["device"]["count"] == mix.get("ranks", 1)
    if not trace:
        wanted = {m["name"] for m in BENCH["end_to_end"]
                  if harness.applies(m, workload)}
        assert set(result["metrics"]) == wanted
        assert all(m["value"] > 0 for n, m in result["metrics"].items()
                   if n != "peak_mem_gib")


def test_every_metric_has_a_reader():
    for m in BENCH["per_layer"]:
        assert callable(harness.load_reader(m["name"]))
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_every_cell_has_its_files():
    for w in BENCH["workloads"]:
        _, cell, config, mix = harness.load_spec(w["name"])
        assert mix["loop"] in ("train", "depth_stream") or os.path.exists(
            os.path.join(ROOT, "port_bench", "loops", mix["loop"] + ".py"))
        assert config["name"] == cell["config"]
        assert os.path.exists(os.path.join(
            ROOT, "port_bench", "limits", w["name"] + ".json"))
