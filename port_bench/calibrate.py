"""Readings that the limits in `limits/` are set from: the program's
compared numbers over many seeds, the control's (the reference computed
in fp8 in the program's place) and planted faults', at the cell's own
size, on the card.

    python3 -m port_bench.calibrate --workload kitti360.train \
        --seeds 12 --control-seeds 4 [--fault half_batch] --out FILE

A training cell's readings need no measured window: set-up's first
micro-steps are the ones compared. A depth cell's program readings come
from a short stream in the cell's closed loop (`--frames` frames), its
control from the same frames. A data-parallel cell's ranks read every
seed in one process group, each --fault (which may repeat) on the first
--fault-seeds seeds too, and the references run once the ranks have
ended. Prints one JSON line and writes it to --out.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
import time

import numpy as np
import torch

from port_bench import check, harness
from port_bench.reference import set_exact
from port_bench.reference.train import follow
from port_bench.weights import make_weights

SEED0 = 2_147_483_000
CONTROL = "fp8"     # the precision below the configurations' bfloat16


def cell_conf(workload: str, overrides=None, mix_overrides=None):
    _, _, config, mix = harness.load_spec(workload)
    conf = copy.deepcopy(config["port"])
    conf["data"] = copy.deepcopy(config["data"])
    harness._merge(conf, overrides or {})
    return conf, dict(mix, **(mix_overrides or {}))


def train_readings(workload, seed, device, control: bool, fault=None,
                   overrides=None, mix_overrides=None) -> dict:
    """{"program": numbers[, "control": numbers]} of one seed."""
    conf, mix = cell_conf(workload, overrides, mix_overrides)
    mix["pool"] = mix["check_steps"]
    conf["seed"] = seed
    trainer, pool, readings = harness.train_setup(
        conf, mix, seed, device, lambda _: None, fault)
    del trainer
    ref = follow(conf, make_weights(conf["model_conf"], seed, device), pool,
                 seed, "float32")
    out = {"program": check.train_numbers(readings, ref),
           "losses": {"program": readings["loss"], "reference": ref["loss"]},
           "eas": {"program": readings["eas"], "reference": ref["eas"]}}
    if control:
        ctl = follow(conf, make_weights(conf["model_conf"], seed, device),
                     pool, seed, CONTROL)
        out["control"] = check.train_numbers(ctl, ref)
        out["losses"]["control"] = ctl["loss"]
        out["eas"]["control"] = ctl["eas"]
        b16 = follow(conf, make_weights(conf["model_conf"], seed, device),
                     pool, seed, "bfloat16")
        out["bf16_reference"] = check.train_numbers(b16, ref)
        out["losses"]["bf16_reference"] = b16["loss"]
    return out


def depth_readings(workload, seed, device, control: bool, frames: int,
                   fault=None, overrides=None, mix_overrides=None) -> dict:
    """{"program": numbers[, "control": numbers]} of one seed: a short
    stream of `frames` frames in the cell's closed loop, then the check."""
    conf, mix = cell_conf(workload, overrides, mix_overrides)
    conf["seed"] = seed
    stream = harness.depth_setup(conf, mix, seed, device, lambda _: None,
                                 fault)
    stream.kept.clear()
    stream.run(frames=frames)
    pool, kept = stream.frames, dict(stream.kept)
    del stream
    out = {"program": harness.depth_check(conf, mix, seed, device, pool,
                                          kept, "float32")}
    if control:
        out["control"] = harness.depth_check(conf, mix, seed, device, pool,
                                             kept, CONTROL)
    return out


def dp_rows(workload, seeds, control_seeds, faults, fault_seeds, device,
            overrides=None, mix_overrides=None) -> list:
    """Rows of a data-parallel cell (`loops.train_dp.readings`): each
    seed's program, the first `control_seeds` seeds' control and
    bfloat16 reference, each fault's program on the first `fault_seeds`
    seeds."""
    from port_bench.loops import train_dp
    conf, mix = cell_conf(workload, overrides, mix_overrides)
    runs = [(s, None) for s in seeds] \
        + [(s, f) for f in faults for s in seeds[:fault_seeds]]
    rows = train_dp.readings(conf, mix, runs, set(seeds[:control_seeds]),
                             device)
    for row in rows:
        print(json.dumps(row), file=sys.stderr, flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=4)
    ap.add_argument("--first-seed", type=int, default=SEED0)
    ap.add_argument("--fault", action="append", default=[])
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = torch.device("cuda")
    harness.port.exact_f32()
    set_exact()
    _, _, _, mix = harness.load_spec(args.workload)
    seeds = [args.first_seed + 7919 * k for k in range(args.seeds)]
    if mix["loop"] == "train_dp":
        rows = dp_rows(args.workload, seeds, args.control_seeds, args.fault,
                       args.fault_seeds, device)
    elif len(args.fault) > 1:
        raise SystemExit("one --fault at a time on one card")
    else:
        fault = args.fault[0] if args.fault else None
        rows = []
        for k, seed in enumerate(seeds):
            t = time.time()
            if mix["loop"] == "train":
                got = train_readings(args.workload, seed, device,
                                     k < args.control_seeds, fault)
            else:
                got = depth_readings(args.workload, seed, device,
                                     k < args.control_seeds, args.frames,
                                     fault)
            got.update(seed=seed, seconds=time.time() - t)
            rows.append(got)
            print(json.dumps(got), file=sys.stderr, flush=True)
            torch.cuda.empty_cache()
    summary = {}
    sides = [("program", None), ("control", None)] \
        + [("program", f) for f in args.fault if mix["loop"] == "train_dp"]
    for side, fault in sides:
        vals = [r[side] for r in rows if side in r
                and r.get("fault") == fault]
        if vals:
            key = side if fault is None else "fault:" + fault
            summary[key] = {k: {"max": max(v[k] for v in vals),
                                "min": min(v[k] for v in vals),
                                "median": float(np.median([v[k]
                                                           for v in vals]))}
                            for k in vals[0]}
    out = {"workload": args.workload, "fault": args.fault,
           "card": torch.cuda.get_device_name(0), "rows": rows,
           "summary": summary}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out["summary"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
