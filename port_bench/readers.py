"""Shared arithmetic of the per-layer readers in `metrics/`. Each reader
takes the harness's `Run` and returns a number, or None where its run
has nothing to read (then the metric is left out of the result line)."""
from __future__ import annotations

from port_bench import flops


def stage_ms(run, stage: str):
    """Mean device milliseconds of one stage over the window's steps, from
    the CUDA events at the program's marks."""
    vals = [s[stage] for s in run.stages if stage in s]
    return sum(vals) / len(vals) if vals else None


def mfu(run):
    """Model FLOPs of the window's steps or frames over the window's
    seconds and the bf16 tensor-core peak of the cards they ran on, in
    %."""
    if not run.window_s or not run.count or run.trace is None:
        return None
    return 100.0 * run.work_flops * run.count / run.window_s \
        / (run.chips * flops.BF16_FLOP_S)


def idle_share(run):
    """1 - busy / wall over the traced stretch, in %."""
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def launches_per(run):
    """Kernel launches in the traced stretch per step or frame."""
    if run.trace is None or not run.trace["count"]:
        return None
    return run.trace["launches"] / run.trace["count"]


def alone_seconds(run, piece: str) -> float:
    """Seconds of the traced stretch in which kernels whose name holds
    `piece` ran and no other device operation did."""
    if run.trace is None:
        return 0.0
    return sum(s for name, s in run.trace["alone"].items() if piece in name)


def kernel_seconds(run, piece: str):
    """(seconds, launches) of the traced kernels whose name holds
    `piece`."""
    if run.trace is None:
        return 0.0, 0
    secs = n = 0
    for name, (s, c) in run.trace["kernels"].items():
        if piece in name:
            secs += s
            n += c
    return secs, n
