"""Profiler trace of the port's NVS frame, per NVS config of chip_smoke.py.

    python3 tools/profile_nvs_frame.py [--frames 3]   # on the card

For each NVS config of chip_smoke.CONFIG_RUNS (eval_synthetic_flagship_nvs
and eval_synthetic_re10k_nvs, with their checkpoints, in the task
runner's bf16), renders the first test scene as the NVS evaluator does
(every view from frame 0's encoding), warms up for 2 frames, times
`--frames` frames on the host clock (synchronized), traces as many more
with torch.profiler, and prints one JSON line: the wall ms per frame
without and with the profiler, the device busy ms per frame (the union of
the trace's kernels, copies and memsets), the device idle share (1 - busy
/ the unprofiled wall), the kernel launches per frame, and the 10 kernels
with the most device time.

Needs one CUDA device. The traces are kept gzipped in out/. A diagnostic
for PERF.md.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))


def main(argv=None):
    import chip_smoke as cs
    from profile_train_step import busy_ms, device_events
    from behindthescenes_tpu_torch.config import (find_config, load_config,
                                                  parse_cli_overrides)
    from behindthescenes_tpu_torch.datasets.factory import make_test_dataset
    from behindthescenes_tpu_torch.datasets.synthetic import collate
    from behindthescenes_tpu_torch.evaluation.nvs import NVSEvaluator
    from behindthescenes_tpu_torch.evaluation.tasks import _net_and_cfg
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_nvs_frame: no CUDA device found")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    os.chdir(ROOT)
    for _, name, checkpoint, _ in cs.CONFIG_RUNS:
        conf = load_config(find_config(name), parse_cli_overrides(
            [f"checkpoint={checkpoint}"]))
        if conf["model"] != "bts_nvs":
            continue
        net, rcfg = _net_and_cfg(conf)
        ev = NVSEvaluator(net, rcfg, conf["model_conf"],
                          eval_resolution=conf.get("eval_resolution"))
        batch = collate([make_test_dataset(conf["data"])[0]])
        frame = [torch.as_tensor(batch[k], device="cuda")
                 for k in ("imgs", "projs", "poses")]
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)

        def render(n):
            for _ in range(n):
                ev.render(*frame, generator=gen)
            torch.cuda.synchronize()
        render(2)
        t0 = time.perf_counter()
        render(args.frames)
        plain_wall = (time.perf_counter() - t0) * 1e3 / args.frames
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            render(args.frames)
            wall = (time.perf_counter() - t0) * 1e3 / args.frames
        stem = os.path.join(ROOT, "out", f"nvs_frame_trace_{name}")
        os.makedirs(os.path.dirname(stem), exist_ok=True)
        device = device_events(prof, stem + ".json")
        kernels = [e for e in device if e["cat"] == "kernel"]
        busy = busy_ms(device) / args.frames
        by_name = {}
        for e in kernels:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        print(json.dumps({
            "card": card, "config": name, "frames": args.frames,
            "image_size": conf["data"]["image_size"],
            "renderer": conf["renderer"],
            "wall_ms_per_frame": plain_wall,
            "wall_ms_per_frame_profiled": wall,
            "device_busy_ms_per_frame": busy,
            "device_idle_share": 1.0 - busy / plain_wall,
            "kernels_per_frame": len(kernels) / args.frames,
            "top_kernels_ms_per_frame": {k: v / args.frames
                                         for k, v in top}}), flush=True)
        del net, ev
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
