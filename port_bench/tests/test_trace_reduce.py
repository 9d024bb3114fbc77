"""The reduction of a profiler trace to busy time, launches and gaps, and
by the program's spans (`trace.reduce_spans`): synthetic traces with the
answer worked out by hand, and the spans stretch of each kind of cell
on the CPU at a tiny size."""
import copy

import pytest

from port_bench import harness, spans, trace
from port_bench.tests import tiny

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


def span_ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1 if cat in ("user_annotation", "cuda_runtime") else 0,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic():
    """Two micro-steps (10-40 and 60-80 us), each tiled by encode and
    render; kernels launched in encode (both steps) and, from a second
    thread, in render; a pageable copy launched in render that runs after
    the step; a sync in render and one outside; a gap outside the roots."""
    note = "user_annotation"
    return [
        span_ev(note, "window", 0, 100),
        span_ev(note, "train_step", 10, 30),
        span_ev(note, "encode", 10, 9),
        span_ev(note, "Optimizer.zero_grad#Adam.zero_grad", 12, 2),
        span_ev(note, "render", 20, 19),
        span_ev(note, "train_step", 60, 20),
        span_ev(note, "encode", 60, 10),
        span_ev(note, "render", 70, 8),
        span_ev("gpu_user_annotation", "encode", 10, 9),
        span_ev("cuda_runtime", "cudaLaunchKernel", 11, 1, corr=1),
        span_ev("kernel", "k1", 12, 4, corr=1),
        span_ev("cuda_runtime", "cudaLaunchKernel", 21, 1, tid=2, corr=2),
        span_ev("kernel", "k2", 25, 10, corr=2),
        span_ev("cuda_runtime", "cudaMemcpyAsync", 22, 1, corr=3),
        span_ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 45, 5,
                corr=3),
        span_ev("cuda_runtime", "cudaStreamSynchronize", 23, 1),
        span_ev("cuda_runtime", "cudaLaunchKernel", 61, 1, corr=4),
        span_ev("kernel", "k3", 62, 2, corr=4),
        span_ev("cuda_runtime", "cudaLaunchKernel", 82, 1, corr=5),
        span_ev("kernel", "k4", 85, 5, corr=5),
        span_ev("cuda_runtime", "cudaEventSynchronize", 90, 1),
    ]


def test_idle_launches_syncs_and_copies_per_span():
    out = trace.reduce_spans(synthetic(), "train_step", "window")
    us = pytest.approx
    assert out["roots"] == 2
    assert out["window_s"] == us(100e-6) and out["busy_s"] == us(26e-6)
    assert out["idle_s"] == us(74e-6)
    s = out["spans"]
    # encode tiles 10-19 and 60-70, render 19-40 and 70-80.
    assert s["encode"]["idle_s"] == us((5 + 8) * 1e-6)
    assert s["render"]["idle_s"] == us((11 + 10) * 1e-6)
    assert s["train_step"]["idle_s"] == us((16 + 18) * 1e-6)
    assert out["outside_idle_s"] == us(40e-6)
    assert (s["encode"]["launches"], s["render"]["launches"],
            s["train_step"]["launches"]) == (2, 1, 3)
    assert (s["encode"]["syncs"], s["render"]["syncs"],
            s["train_step"]["syncs"]) == (0, 1, 1)
    assert (s["render"]["h2d_pageable"], s["train_step"]["h2d_pageable"],
            s["encode"]["h2d_pageable"]) == (1, 1, 0)
    assert set(s) == {"train_step", "encode", "render"}
    stages = s["encode"]["idle_s"] + s["render"]["idle_s"]
    assert stages + out["outside_idle_s"] == us(out["idle_s"])


def test_default_window_is_the_roots():
    out = trace.reduce_spans(synthetic(), "train_step")
    assert out["window_s"] == pytest.approx(70e-6)
    assert out["outside_idle_s"] == pytest.approx(70e-6 - 21e-6 - 34e-6)


@pytest.mark.parametrize("workload", ["kitti360.train", "kitti360.depth"])
def test_stretch_on_the_cpu(workload):
    """The spans stretch of a cell at a tiny size: one root per step or
    frame, each tiled by the program's stages; the host-to-device counter
    the same on every step or frame."""
    _, _, config, mix = harness.load_spec(workload)
    over, mix_over = tiny.cut(workload, bf16=False)
    conf = copy.deepcopy(config["port"])
    conf["data"] = copy.deepcopy(config["data"])
    harness._merge(conf, over)
    conf["seed"] = tiny.SEED
    mix = dict(mix, **mix_over)
    train = mix["loop"] == "train"
    mix["trace_steps" if train else "trace_frames"] = 2
    out = spans.stretch(conf, mix, tiny.SEED, 0, device="cpu")
    assert out["count"] == 2 and out["roots"] == 2
    stages = (("encode", "render", "loss", "backward", "optimizer")
              if train else ("encode", "render"))
    assert set(out["spans"]) == {spans.ROOTS[mix["loop"]], *stages}
    assert out["busy_s"] == 0 and out["wall_s"] > 0
    assert out["counters"]["h2d_copies"] % 2 == 0
