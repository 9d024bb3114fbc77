"""The profiler's trace of a traced stretch, reduced to numbers.

The stretch runs under `torch.profiler` with CPU and CUDA activities; its
Chrome trace is read back once. Device busy time is the union of the
intervals of kernels, memory copies and memory sets (a copy overlapping a
kernel counts once); launches are the kernels; each gap between busy
intervals is named by the innermost host operation running when it
began, which says what the host was doing while the device waited.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")


def merge(spans):
    """Sorted, merged (start, end) intervals of spans."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _host_names(host, gaps):
    """For each gap (start, length) the name of the innermost host event
    whose interval holds the gap's start (None when none does)."""
    host = sorted(host, key=lambda e: e["ts"])
    starts = [e["ts"] for e in host]
    names = []
    for start, _ in gaps:
        i = bisect.bisect_right(starts, start)
        best, best_dur = None, None
        for e in host[max(0, i - 400):i]:
            if e["ts"] + e["dur"] >= start and (best_dur is None
                                                or e["dur"] < best_dur):
                best, best_dur = e["name"], e["dur"]
        names.append(best)
    return names


def reduce_events(events: list) -> dict:
    """busy_s, launches, kernel seconds and counts by name, the ten
    device operations that took longest in all, and the ten largest idle
    gap totals by the host's activity."""
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in HOST_CATS]
    kernels = {}
    for e in dev:
        if e["cat"] != "kernel":
            continue
        k = kernels.setdefault(e["name"], [0.0, 0])
        k[0] += e["dur"] / 1e6
        k[1] += 1
    ops = {}
    for e in dev:
        ops[e["name"]] = ops.get(e["name"], 0.0) + e["dur"] / 1e6
    spans = merge((e["ts"], e["ts"] + e["dur"]) for e in dev)
    gaps = [(spans[i][1], spans[i + 1][0] - spans[i][1])
            for i in range(len(spans) - 1)]
    by_host = {}
    for (_, length), name in zip(gaps, _host_names(host, gaps)):
        key = name or "(no host event)"
        by_host[key] = by_host.get(key, 0.0) + length / 1e6
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": sum(b - a for a, b in spans) / 1e6,
            "launches": sum(k[1] for k in kernels.values()),
            "kernels": kernels,
            "device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in idle]}


def profile(fn) -> tuple:
    """Run fn() under the profiler (CPU and CUDA), return (fn's result,
    the reduced trace). The trace file goes to the temporary directory
    and is removed once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return out, reduce_events(events)
