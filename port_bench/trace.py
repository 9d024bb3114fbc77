"""The profiler's trace of a traced stretch, reduced to numbers.

The stretch runs under `torch.profiler` with CPU and CUDA activities; its
Chrome trace is read back once. Device busy time is the union of the
intervals of kernels, memory copies and memory sets (a copy overlapping a
kernel counts once); launches are the kernels; each gap between busy
intervals is named by the innermost host operation running when it
began, which says what the host was doing while the device waited. Per
name, "alone" is the time in which operations of that name ran and no
other device operation did (what of a collective no other work hides).

`reduce_spans` reads a stretch by the program's own spans (`spans.py`),
on the profiler's clock. Each root span (a micro-step's `train_step`, a
frame's `depth_frame`) is tiled by its stage spans: a stage runs from
the previous stage's end, or the root's start, to its own end (the last
to the root's end). Per span name:
- idle: the interval less the part the union of kernel, copy and set
  intervals covers;
- launches: kernels whose launching runtime call (joined by
  `args.correlation`, on any thread, so that the autograd thread's
  launches fall in "backward") starts inside it;
- syncs: cudaStreamSynchronize, cudaDeviceSynchronize,
  cudaEventSynchronize and blocking cudaMemcpy calls that start inside;
- h2d_pageable: pageable host-to-device copies launched inside.
Outside idle is the idle of the stretch outside every root, so the
stages' idle and the outside idle add up to the stretch's idle.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
# The categories of the trace's CUDA API calls.
API_CATS = tuple(c for c in HOST_CATS if c.startswith("cuda"))


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


def alone(dev) -> dict:
    """{name: seconds in which device operations of that name, and of no
    other, ran} over the device events `dev`."""
    edges = sorted([(e["ts"], 1, e["name"]) for e in dev]
                   + [(e["ts"] + e["dur"], -1, e["name"]) for e in dev],
                   key=lambda x: (x[0], x[1]))
    active, out, prev = {}, {}, None
    for t, step, name in edges:
        if len(active) == 1 and prev is not None:
            (only,) = active
            out[only] = out.get(only, 0.0) + (t - prev) / 1e6
        active[name] = active.get(name, 0) + step
        if not active[name]:
            del active[name]
        prev = t
    return out


def reduce_events(events: list) -> dict:
    """busy_s, launches, kernel seconds and counts by name, the seconds
    each name ran alone, the ten device operations that took longest in
    all, and the ten largest idle gap totals by the host's activity."""
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
            "kernels": kernels, "alone": alone(dev),
            "device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in idle]}


class _Intervals:
    """Sorted, disjoint (start, end, name) intervals; `find(t)` gives the
    name of the one holding t, or None."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [s[0] for s in self.spans]

    def find(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.spans[i][1]:
            return self.spans[i][2]
        return None


def _covered(busy, starts, a, b) -> float:
    """The length of [a, b] that the merged intervals `busy` cover."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    total = 0.0
    while i < len(busy) and busy[i][0] < b:
        total += max(0.0, min(b, busy[i][1]) - max(a, busy[i][0]))
        i += 1
    return total


def _stages(root, notes):
    """The top-level annotations inside `root` on its thread, in order."""
    r0, r1 = root["ts"], root["ts"] + root["dur"]
    kids = sorted((e for e in notes if e is not root
                   and e.get("tid") == root.get("tid")
                   and e.get("pid") == root.get("pid")
                   and r0 <= e["ts"] and e["ts"] + e["dur"] <= r1),
                  key=lambda e: (e["ts"], -e["dur"]))
    top, end = [], r0
    for e in kids:
        if e["ts"] >= end:
            top.append(e)
            end = e["ts"] + e["dur"]
    return top


def reduce_spans(events: list, root: str, window=None) -> dict:
    """Idle seconds, launches, syncs and pageable host-to-device copies
    per span name, over the roots named `root` and the stage spans that
    tile them, and the idle outside every root, within `window` (the
    annotation of that name; default: the first root's start to the last
    root's end). Times in seconds."""
    xs = [e for e in events if e.get("ph") == "X"]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    busy = merge((e["ts"], e["ts"] + e["dur"]) for e in dev)
    starts = [b[0] for b in busy]
    notes = [e for e in xs if e.get("cat") == "user_annotation"]
    roots = sorted((e for e in notes if e["name"] == root),
                   key=lambda e: e["ts"])
    if window is not None:
        win = next(e for e in notes if e["name"] == window)
        w0, w1 = win["ts"], win["ts"] + win["dur"]
    elif roots:
        w0, w1 = roots[0]["ts"], max(e["ts"] + e["dur"] for e in roots)
    else:
        w0 = w1 = 0.0
    out = {"roots": len(roots), "window_s": (w1 - w0) / 1e6,
           "busy_s": _covered(busy, starts, w0, w1) / 1e6, "spans": {}}
    out["idle_s"] = out["window_s"] - out["busy_s"]

    def entry(name):
        return out["spans"].setdefault(name, {
            "idle_s": 0.0, "launches": 0, "syncs": 0, "h2d_pageable": 0})

    tiles, whole = [], []
    root_idle = 0.0
    for r in roots:
        r0, r1 = r["ts"], r["ts"] + r["dur"]
        whole.append((r0, r1, root))
        idle = (r1 - r0) - _covered(busy, starts, r0, r1)
        entry(root)["idle_s"] += idle / 1e6
        root_idle += idle
        kids = _stages(r, notes)
        prev = r0
        for k, e in enumerate(kids):
            end = r1 if k == len(kids) - 1 else e["ts"] + e["dur"]
            tiles.append((prev, end, e["name"]))
            entry(e["name"])["idle_s"] += \
                ((end - prev) - _covered(busy, starts, prev, end)) / 1e6
            prev = end
    out["outside_idle_s"] = out["idle_s"] - root_idle / 1e6
    tiles, whole = _Intervals(tiles), _Intervals(whole)

    calls = {}
    for e in xs:
        if e.get("cat") in API_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                calls[corr] = e["ts"]
            if e["name"] in SYNC_CALLS:
                for spans in (tiles, whole):
                    name = spans.find(e["ts"])
                    if name is not None:
                        entry(name)["syncs"] += 1
    for e in dev:
        corr = (e.get("args") or {}).get("correlation")
        if corr not in calls:
            continue
        if e["cat"] == "kernel":
            key = "launches"
        elif e["cat"] == "gpu_memcpy" and "HtoD" in e["name"] \
                and "Pageable" in e["name"]:
            key = "h2d_pageable"
        else:
            continue
        for spans in (tiles, whole):
            name = spans.find(calls[corr])
            if name is not None:
                entry(name)[key] += 1
    return out


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
