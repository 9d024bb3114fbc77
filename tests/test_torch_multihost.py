"""Two ranks through the port's training entry point (counterpart of
tests/test_multihost.py): `python -m behindthescenes_tpu_torch.train -cn
exp_synthetic --device cpu` started twice with the JAX package's keys
`num_processes` and `process_id` and a file rendezvous
(`dist_init_method`, no port to collide under xdist), gloo over the CPU.

Both ranks compute the one global step, so their logged losses and
validation means must be identical, iteration for iteration; a rank-
seeded draw, diverged view ids or a missing reduction break that at once.
Rank 0 alone writes checkpoints. Also: `shard_for_host` and the
validation split are disjoint and cover the dataset, and the launcher
stops every rank when one fails or the run outlasts its timeout.
"""
import os
import re
import subprocess
import sys

import pytest
import torch

from behindthescenes_tpu_torch.datasets.loader import (shard_for_host,
                                                      split_for_rank)
from behindthescenes_tpu_torch.parallel.launch import run_ranks
from tests.torch_dist_ranks import failing_rank, sleeping_rank

# One intra-op thread: pytest-xdist runs several workers on this CPU.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT = 150


def _run_two_ranks(tmp_path):
    out = tmp_path / "run"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "behindthescenes_tpu_torch.train", "-cn",
         "exp_synthetic", "--device", "cpu", f"output_path={out}",
         "stop_iteration=6", "validate_every=3", "checkpoint_every=3",
         "log_every_iters=1", "num_epochs=1000", "data.length=16",
         "tensorboard=false", "num_workers=0",
         f"dist_init_method=file://{tmp_path}/rendezvous",
         "num_processes=2", f"process_id={rank}"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(2)]
    logs = []
    try:
        for p in procs:
            stdout, _ = p.communicate(timeout=SPAWN_TIMEOUT)
            logs.append(stdout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, text) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank}:\n{text[-4000:]}"
    return out, logs


def _lines(text, pattern):
    return [m.group(1) for m in re.finditer(pattern, text)]


def test_two_rank_training(tmp_path):
    out, logs = _run_two_ranks(tmp_path)
    for rank, text in enumerate(logs):
        assert f"multi-host: process {rank}/2" in text
    losses = [_lines(t, r"it (\d+ loss \S+)") for t in logs]
    assert len(losses[0]) == 6, logs[0][-3000:]
    assert losses[0] == losses[1]
    vals = [_lines(t, r"validation @ (\d+: .*)") for t in logs]
    assert len(vals[0]) == 2 and vals[0] == vals[1]
    assert "abs_rel" in vals[0][0]
    writes = [_lines(t, r"checkpoint (\d+) written") for t in logs]
    assert writes[1] == []
    assert {"3", "6"} <= set(writes[0])
    steps = sorted(int(d) for d in os.listdir(out / "checkpoints")
                   if d.isdigit())
    assert steps == [3, 6]


def test_shard_for_host_partitions_disjointly():
    """Training shards: disjoint, no padding, the remainder left out (17
    items over 2 ranks give 8 each); validation shares: disjoint and
    covering (9 and 8)."""
    data = list(range(17))
    for world in (1, 2, 3, 4):
        shards = [[s[i] for i in range(len(s))]
                  for s in (shard_for_host(data, r, world)
                            for r in range(world))]
        assert all(len(s) == 17 // world for s in shards)
        flat = sum(shards, [])
        assert len(flat) == len(set(flat))
        assert set(flat) <= set(data)
        shares = [[s[i] for i in range(len(s))]
                  for s in (split_for_rank(data, r, world)
                            for r in range(world))]
        flat = sum(shares, [])
        assert sorted(flat) == data
    assert [len(shard_for_host(data, r, 2)) for r in range(2)] == [8, 8]
    assert [len(split_for_rank(data, r, 2)) for r in range(2)] == [9, 8]


def test_run_ranks_stops_every_rank_when_one_fails():
    """A rank that raises ends the run at once with its traceback, though
    the other rank waits in a collective it would never leave; ranks that
    outlast the timeout are killed and the run raises TimeoutError."""
    import time
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(failing_rank, 2, timeout=60.0)
    with pytest.raises(TimeoutError):
        run_ranks(sleeping_rank, 2, (300,), timeout=3.0)
    assert time.monotonic() - t < 50
