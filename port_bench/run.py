"""The benchmark's command: one run of one cell on the card.

    python3 -m port_bench.run --workload kitti360.train --seed 7 \
        --seconds 20 --trace 0

prints the set-up split and the compared numbers on standard error and,
as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics with --trace 0,
its per-layer metrics with --trace 1), device, with --trace 1 the
breakdown, the host's CPU state over the window, and last the compared
numbers with their limits. It exits with 1 and prints no result where no
card (or too few) is found, or where a module of JAX or the JAX package
was loaded.
"""
from __future__ import annotations

import os
import time


def process_start() -> float:
    """The wall-clock time this process started (Linux /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_PROCESS = process_start()

# One CPU thread for the program's host-side tensor work: the card is fed
# by one Python thread, and a pool of spinning OpenMP threads as wide as
# the machine only takes cores from it on a shared host.
THREADS = 1
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = str(THREADS)

import argparse  # noqa: E402  (after the start time is taken)
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(THREADS)
    from port_bench import harness
    _, cell, _, _ = harness.load_spec(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{found}", file=sys.stderr)
        return 1
    try:
        result, split = harness.run(args.workload, args.seed, args.seconds,
                                    bool(args.trace), t_process=T_PROCESS)
    except RuntimeError as err:
        print(f"{args.workload}: {err}", file=sys.stderr)
        return 1
    print("setup_split_s " + json.dumps(split), file=sys.stderr)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
