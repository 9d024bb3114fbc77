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
The reduction is `trace.reduce_spans`.
"""
from __future__ import annotations

import json
import os
import tempfile
import time

import torch

from port_bench import harness
from port_bench import port_api as port
from port_bench import trace as trace_lib

WINDOW = "port_bench.spans_stretch"
ROOTS = {"train": "train_step", "depth_stream": "depth_frame"}


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
    port.reset_counters()
    port.set_tracing(True)
    try:
        _, wall, events = profile_events(body, device)
    finally:
        port.set_tracing(False)
    out = trace_lib.reduce_spans(events, ROOTS[mix["loop"]], WINDOW)
    out.update(counters=port.counters(), count=n, wall_s=wall)
    return out


def of(run):
    """The run's spans stretch (made at the first call, kept on the run),
    or None where the run traced nothing or the program has no spans."""
    if run.trace is None or not port.tracing_available():
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
