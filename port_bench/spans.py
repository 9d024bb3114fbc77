"""The spans stretch: where the card waits, named by the program's own
spans (`behindthescenes_tpu_torch.tracing`).

A `--trace 1` run's window and its traced stretch (`trace.py`) run with
the port's spans off, so every metric read there reads as before. The
span metrics (`metrics/train.*_idle_ms`, `*_launches`, `*_h2d_copies_*`,
`*_syncs_*`, `depth.*` alike) read a second stretch instead: the first
of their readers in a run builds the cell's program again from the run's
seed (the harness's own set-up, after the check), warms it up, and runs
`trace_steps` micro-steps or `trace_frames` frames under the profiler
with the port's spans on and its counters reset before; the reduction is
kept on the run for the other readers. It costs a traced run the
set-up again, the stretch and reading one more trace (4.6-7.0 s in all
on one H100), and a `--trace 0` run nothing. Where the program
has no spans, or the run traced nothing (the CPU), the readers read None.

`reduce_spans` works on the profiler's clock. Each root span (a
micro-step's `train_step`, a frame's `depth_frame`) is tiled by its
stage spans: a stage runs from the previous stage's end, or the root's
start, to its own end (the last to the root's end). Per span name:
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
import time

import torch

from port_bench import harness, port_tracing
from port_bench import port_api as port
from port_bench import trace as trace_lib

WINDOW = "port_bench.spans_stretch"
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
ROOTS = {"train": "train_step", "depth_stream": "depth_frame"}
# The categories of the trace's CUDA API calls.
API_CATS = tuple(c for c in trace_lib.HOST_CATS if c.startswith("cuda"))


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
    dev = [e for e in xs if e.get("cat") in trace_lib.DEVICE_CATS]
    busy = trace_lib.merge((e["ts"], e["ts"] + e["dur"]) for e in dev)
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


def profile_events(fn, device) -> tuple:
    """fn() under the profiler (the host's activity and, on the card, the
    card's), inside an annotation WINDOW: (fn's result, its host seconds,
    the trace's events)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            got = fn()
            harness.sync(device)
            wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return got, wall, events


def stretch(conf: dict, mix: dict, seed: int, start: int,
            device="cuda") -> dict:
    """The spans stretch of a cell: the program built and warmed up as
    the harness builds it, then `trace_steps` micro-steps from the pool's
    batch `start` (or `trace_frames` frames) profiled with the port's
    spans on. Returns reduce_spans' result with the counters over the
    stretch ("counters"), its count of steps or frames ("count") and its
    host seconds ("wall_s")."""
    device = torch.device(device)

    def quiet(_name):
        pass

    if mix["loop"] == "train":
        trainer, pool, _ = harness.train_setup(conf, mix, seed, device,
                                               quiet)
        n = mix["trace_steps"]

        def body():
            for k in range(n):
                batch, draws = harness.feed(pool, start + k)
                trainer.train_step(batch, port.port_draws(draws))
    else:
        stream = harness.depth_setup(conf, mix, seed, device, quiet)
        n = mix["trace_frames"]

        def body():
            stream.run(frames=n, start=start)
    harness.sync(device)
    port_tracing.reset_counters()
    port_tracing.set_tracing(True)
    try:
        _, wall, events = profile_events(body, device)
    finally:
        port_tracing.set_tracing(False)
    out = reduce_spans(events, ROOTS[mix["loop"]], WINDOW)
    out.update(counters=port_tracing.counters(), count=n, wall_s=wall)
    return out


def of(run):
    """The run's spans stretch (made at the first call, kept on the run),
    or None where the run traced nothing or the program has no spans."""
    if run.trace is None or not port_tracing.available():
        return None
    if not hasattr(run, "spans"):
        start = run.mix["check_steps"] + run.count \
            if run.mix["loop"] == "train" else run.mix["warm_frames"]
        run.spans = stretch(run.conf, run.mix, run.conf["seed"], start)
    return run.spans


def idle_ms(run, name: str):
    """Idle ms inside the span `name`, per step or frame."""
    s = of(run)
    if s is None or name not in s["spans"]:
        return None
    return 1e3 * s["spans"][name]["idle_s"] / s["count"]


def outside_idle_ms(run):
    """Idle ms outside every root span, per step or frame."""
    s = of(run)
    return None if s is None else 1e3 * s["outside_idle_s"] / s["count"]


def per(run, name: str, key: str):
    """A span's launches, syncs or h2d_pageable, per step or frame."""
    s = of(run)
    if s is None or name not in s["spans"]:
        return None
    return s["spans"][name][key] / s["count"]


def counter_per(run, name: str):
    """A counter of the program over the stretch, per step or frame."""
    s = of(run)
    if s is None:
        return None
    return s["counters"].get(name, 0) / s["count"]
