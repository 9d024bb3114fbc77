"""The reduction of a profiler trace to busy time, launches and gaps."""
import pytest

from port_bench import trace


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_busy_is_the_union_and_gaps_are_named():
    events = [ev("kernel", "a", 0, 10), ev("gpu_memcpy", "copy", 5, 10),
              ev("kernel", "b", 30, 10), ev("kernel", "a", 60, 5),
              ev("cpu_op", "aten::item", 14, 20),
              ev("cpu_op", "outer", 0, 100),
              ev("cpu_op", "aten::copy_", 40, 30)]
    out = trace.reduce_events(events)
    assert out["busy_s"] == pytest.approx(30e-6)
    assert out["launches"] == 3
    assert out["kernels"]["a"] == [pytest.approx(15e-6), 2]
    assert dict(out["idle_gaps"]) == {"aten::item": pytest.approx(15e-6),
                                      "aten::copy_": pytest.approx(20e-6)}
    assert out["device_ops"][0] == ["a", pytest.approx(15e-6)]
