"""Profiler trace of the port's flagship train step.

    python3 tools/profile_train_step.py [--bf16] [--steps 5]   # on the card

Builds the trainer of chip_smoke.py's training phases (the flagship
config, media/weights/flagship_fast_conv.npz, one cached batch of 4
synthetic items at 192x640, numpy-seeded draws), warms it up for 3 steps,
times `--steps` steps on the host clock (synchronized), traces as many
more with torch.profiler, and prints one JSON line: the wall ms per step
without and with the profiler, the device busy ms per step (the union of
the intervals of the trace's device activity: kernels, copies and
memsets, read from its Chrome trace by category, so the profiler's own
annotations of host ranges on the device's timeline are left out), the
device idle share (1 - busy / the unprofiled wall), the kernel launches
per step, and the 10 kernels with the most device time.

It also prices the loss's SSIM statistics, which the port computes in
float64 where the JAX package computes them in f32: the median ms of the
loss stage (CUDA events at the trainer's marks), and the ms per step of
the forward and backward of the loss's SSIM on one step's own inputs, as
the port runs it (float64 statistics) and with the same formula in f32,
on the host clock and as device time from a trace.

Needs one CUDA device. The traces are kept gzipped in out/. A diagnostic
for PERF.md.
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
REPS = 50


def busy_ms(events) -> float:
    """Milliseconds covered by the union of the Chrome trace events'
    intervals (microsecond ts and dur)."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    total, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def ssim_f32(x, y):
    """The loss's SSIM (zero pad, gaussian window, comp_mode) with its
    statistics in the input's dtype, as the JAX package computes it."""
    import torch.nn.functional as F
    from behindthescenes_tpu_torch.ops import ssim as S
    x = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1))
    y = F.pad(y.permute(0, 3, 1, 2), (1, 1, 1, 1))
    w = torch.tensor(S._GAUSS3, dtype=torch.float32).to(x.device, x.dtype)
    mu_x, mu_y = S._depthwise3(x, w), S._depthwise3(y, w)
    sigma_x = S._depthwise3(x * x, w) - mu_x * mu_x
    sigma_y = S._depthwise3(y * y, w) - mu_y * mu_y
    sigma_xy = S._depthwise3(x * y, w) - mu_x * mu_y
    s = ((2 * mu_x * mu_y + S._C1) * (2 * sigma_xy + S._C2)
         / ((mu_x * mu_x + mu_y * mu_y + S._C1)
            * (sigma_x + sigma_y + S._C2)))
    return (torch.clamp(1.0 - s, 0.0, 1.0) * 0.5).permute(0, 2, 3, 1)


def device_events(prof, path: str) -> list:
    """The device activity (kernels, copies, memsets) of `prof`'s Chrome
    trace, written to `path` and kept there gzipped."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    with open(path, "rb") as f, gzip.open(path + ".gz", "wb") as g:
        shutil.copyfileobj(f, g)
    os.remove(path)
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") in DEVICE_CATEGORIES]


def ssim_cost(trainer, tb, td, trace_stem: str) -> dict:
    """Median ms of the loss stage over REPS steps (CUDA events at the
    trainer's marks), and the ms per step of the forward and backward of
    the loss's SSIM on one step's own inputs, with the port's float64
    statistics and with f32 ones: on the host clock (synchronized) and as
    device kernel time from a trace of REPS repetitions."""
    import statistics
    from behindthescenes_tpu_torch import losses
    seen, stage = [], []
    orig = losses.compute_errors_l1ssim

    def spy(a, b):
        seen.append((a.detach().clone(), b.detach().clone()))
        return orig(a, b)
    losses.compute_errors_l1ssim = spy
    try:
        for _ in range(REPS):
            marks = {}

            def mark(name, marks=marks):
                marks[name] = torch.cuda.Event(enable_timing=True)
                marks[name].record()
            trainer.train_step(tb, td, mark=mark)
            stage.append(marks)
    finally:
        losses.compute_errors_l1ssim = orig
    torch.cuda.synchronize()
    inputs = seen[:len(seen) // REPS]
    out = {"loss_stage_ms": statistics.median(
        m["render"].elapsed_time(m["loss"]) for m in stage),
        "ssim_calls_per_step": len(inputs),
        "ssim_shapes": [list(a.shape) for a, _ in inputs]}
    pairs = []
    for a, b in inputs:
        n, pc, h, w, nv, c = a.shape
        pairs.append((a.requires_grad_(True),
                      b.expand(a.shape).permute(0, 1, 4, 2, 3, 5).reshape(
                          -1, h, w, c)))
    variants = (("ssim_f64_stats", lambda x, y: losses.ssim(
        x, y, pad_reflection=False, gaussian_average=True, comp_mode=True)),
                ("ssim_f32_stats", ssim_f32))
    for name, fn in variants:
        def run(fn=fn):
            for a, y in pairs:
                n, pc, h, w, nv, c = a.shape
                x = a.permute(0, 1, 4, 2, 3, 5).reshape(-1, h, w, c)
                fn(x, y).sum().backward()
        for _ in range(5):
            run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            run()
        torch.cuda.synchronize()
        out[name + "_host_ms"] = (time.perf_counter() - t0) * 1e3 / REPS
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                run()
            torch.cuda.synchronize()
        kernels = [e for e in device_events(prof, f"{trace_stem}_{name}.json")
                   if e["cat"] == "kernel"]
        out[name + "_device_ms"] = sum(e["dur"] for e in kernels) / 1e3 / REPS
        out[name + "_kernels"] = len(kernels) / REPS
    return out


def main(argv=None):
    import chip_smoke as cs
    from behindthescenes_tpu_torch import train as train_cli
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_step: no CUDA device found")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    os.chdir(ROOT)
    conf = train_cli.config(cs.TRAIN_CONFIG)
    batch = cs.train_batch(conf)
    draws = cs.numpy_draws(conf, batch, cs.TRAIN_SEED)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    trainer = cs.make_trainer(conf, os.path.join(ROOT, cs.WEIGHTS), "cuda",
                              dtype)
    tb, td = cs.on_device(batch, draws, "cuda")
    for _ in range(3):
        trainer.train_step(tb, td)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        trainer.train_step(tb, td)
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) * 1e3 / args.steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            trainer.train_step(tb, td)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / args.steps
    precision = "bf16" if args.bf16 else "f32"
    stem = os.path.join(ROOT, "out", f"train_step_trace_{precision}")
    os.makedirs(os.path.dirname(os.path.abspath(stem)), exist_ok=True)
    device = device_events(prof, stem + ".json")
    kernels = [e for e in device if e["cat"] == "kernel"]
    busy = busy_ms(device) / args.steps
    by_name = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    print(json.dumps({
        "card": card, "precision": precision,
        "steps": args.steps, "wall_ms_per_step": plain_wall,
        "wall_ms_per_step_profiled": wall,
        "device_busy_ms_per_step": busy,
        "device_idle_share": 1.0 - busy / plain_wall,
        "kernels_per_step": len(kernels) / args.steps,
        "copies_and_memsets_per_step": (len(device) - len(kernels))
        / args.steps,
        "top_kernels_ms_per_step": {k: v / args.steps for k, v in top},
        **ssim_cost(trainer, tb, td, stem)}), flush=True)


if __name__ == "__main__":
    main()
