"""Start a function on several ranks of a new process group, on one host.

    results = run_ranks(fn, world=2, args=(...), backend="gloo")

runs fn(rank, world, *args) in `world` fresh processes (the spawn start
method), each joined into one `torch.distributed` group through a file
rendezvous in a temporary directory (no port to collide), and returns the
ranks' results in rank order. A rank that raises, or a run that outlasts
`timeout` seconds, stops every rank and raises here with the rank's
traceback: a collective that one rank never reaches would otherwise hang
the others. The tests use it with gloo on the CPU; `chip_smoke.py` with
gloo on one card, or NCCL over one card a rank.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch


def _rank_main(fn, rank, world, backend, init_file, args, out, threads,
               timeout):
    import torch.distributed as dist
    try:
        if threads:
            torch.set_num_threads(threads)
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, out)
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn: Callable, world: int, args: tuple = (),
              backend: str = "gloo", timeout: float = 120.0,
              threads: Optional[int] = 1) -> list:
    """fn(rank, world, *args) on `world` new ranks (module docstring);
    `fn` must be importable by its module's name. threads: torch's
    intra-op threads in each rank (None leaves torch's default)."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="bts_ranks_") as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world)]
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            fn, r, world, backend, init_file, args, outs[r], threads,
            timeout)) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while True:
                codes = [p.exitcode for p in procs]
                failed = next((r for r, c in enumerate(codes)
                               if c not in (None, 0)), None)
                if failed is not None or all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"ranks still running after {timeout} s "
                        f"(exit codes {codes})")
                time.sleep(0.05)
        finally:
            # The others' collectives fail soon after a rank dies; give
            # them a moment to write their own tracebacks.
            grace = time.monotonic() + (5.0 if failed is not None else 0.0)
            for p in procs:
                p.join(max(0.0, grace - time.monotonic()))
                if p.exitcode is None:
                    p.kill()
                p.join()
        if failed is not None:
            detail = ""
            for r, o in enumerate(outs):
                if os.path.exists(o + ".err"):
                    with open(o + ".err") as f:
                        detail += f"--- rank {r}:\n{f.read()}"
            raise RuntimeError(f"rank {failed} of {world} failed (exit code "
                               f"{procs[failed].exitcode})\n{detail}")
        return [torch.load(o, weights_only=False) for o in outs]
