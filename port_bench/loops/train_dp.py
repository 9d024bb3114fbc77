"""The loop "train_dp": data-parallel training, one process and one card
a rank, through the port's own launcher and process group.

The parent process starts `ranks` ranks (`port_api.run_ranks`: a file
rendezvous, the mix's `backend` on the cards, gloo on the CPU) and
touches no card until they have ended. Each rank builds the cell's
trainer on `cuda:<rank>` inside the group, so that the port's step is its
data-parallel one: BatchNorm and the loss over the global batch, then one
flat all-reduce of the gradient after the backward pass, and Adam on
every rank. Each rank's pool of batches and draws is made on its card
from the seed and its rank (`traffic.train_pool`), every flip taken from
rank 0's, since the global batch is flipped as one. A micro-step's global
batch is the ranks' rows in rank order; `accumulate_steps` is the mix's.

Set-up drives `check_steps` micro-steps through the window's own call and
reads them as the one-card loop does, on rank 0, whose gradient is the
all-reduced one; then `replica_gap`, the largest difference of any
parameter between rank 0 and any other rank (`numbers` says what is
compared). After a barrier the ranks run the closed loop in lockstep.
Every `stop_every` micro-steps they agree by an all-reduce whether any
has passed `seconds`, so the window ends on the same whole micro-step
everywhere without a sync on every step. With a trace, rank 0 times the
stages and profiles `trace_steps` further micro-steps while the others
run them unprofiled.

Once the ranks have ended, the parent checks rank 0's readings against
the float32 reference following the same micro-steps over the global
batch, as one batch of ranks x batch_size items (so that BatchNorm's
statistics are the global batch's, as the program's are), on the first
card.
"""
from __future__ import annotations

import functools
import gc
import time

import torch
import torch.distributed as dist

from port_bench import check, flops, harness, traffic
from port_bench import port_api as port
from port_bench import trace as trace_lib
from port_bench.reference import set_exact
from port_bench.reference.train import follow
from port_bench.weights import make_weights


def rank_device(rank: int, kind: str) -> torch.device:
    """This rank's card, made current (NCCL's communicators and the
    port's collectives of host values use the current card), or the
    CPU."""
    if kind != "cuda":
        return torch.device("cpu")
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    torch.empty(1, device=device)
    return device


def rank_pool(conf, mix, seed, device, rank: int, world: int) -> list:
    """The pool of rank `rank`'s rows, every flip rank 0's (every rank
    calls it)."""
    pool = traffic.train_pool(conf, mix, seed, device, rank)
    if world > 1:
        flips = torch.tensor([float(d["flip"]) for _, d in pool],
                             device=device)
        dist.broadcast(flips, 0)
        for (_, draws), flip in zip(pool, flips.tolist()):
            draws["flip"] = flip > 0.5
    return pool


def setup(conf, mix, seed, device, timer, fault, rank, world) -> tuple:
    """train_setup on this rank, then the replica gap, which set-up's
    "warm_up" counts: (trainer, pool, readings)."""
    def stages(name):
        if name != "warm_up":
            timer(name)
    pool_rank = 0 if fault == "shard_repeated" else rank
    make_pool = functools.partial(rank_pool, rank=pool_rank, world=world)
    trainer, pool, readings = harness.train_setup(conf, mix, seed, device,
                                                  stages, fault, make_pool)
    readings["replica_gap"] = replica_gap(trainer, world)
    timer("warm_up")
    return trainer, pool, readings


@torch.no_grad()
def replica_gap(trainer, world: int) -> float:
    """The largest |p - p on rank 0| of any parameter on any rank."""
    if world == 1:
        return 0.0
    mine = torch.cat([p.reshape(-1) for p in
                      port.parameters(trainer).values()])
    first = mine.clone()
    dist.broadcast(first, 0)
    gap = (mine - first).abs().max().reshape(1)
    dist.all_reduce(gap, op=dist.ReduceOp.MAX)
    return float(gap)


def rank_run(rank: int, world: int, job: dict) -> dict:
    """One rank of a run: set-up, the window, the traced stretch. Every
    rank returns its peak memory and the forbidden modules it loaded;
    rank 0 also the window's count and seconds, its wall-clock start,
    the stage marks, the reduced trace, the readings, the set-up split
    and the host's state."""
    conf, mix, seed, fault = job["conf"], job["mix"], job["seed"], \
        job["fault"]
    split, timer = harness.setup_timer(job["t_process"])
    port.import_program()
    timer("imports")
    port.exact_f32()
    set_exact()
    device = rank_device(rank, job["device"])
    port.any_rank(False)            # the group's first collective
    timer("cuda_init")
    split["kernel_library"] = 0.0
    trainer, pool, readings = setup(conf, mix, seed, device, timer, fault,
                                    rank, world)
    start, every, seconds = mix["check_steps"], mix["stop_every"], \
        job["seconds"]

    def stop(steps, elapsed):
        return steps > 0 and steps % every == 0 \
            and port.any_rank(elapsed >= seconds)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    clock = harness.Clock(device) if job["trace"] and rank == 0 else None
    host0 = harness.host_reading()
    port.any_rank(False)            # every rank at the window's start
    t0_wall = time.time()
    count, window_s, losses = harness.train_window(
        trainer, pool, start, seconds, device, clock, fault, stop)
    host = harness.host_state(host0, harness.host_reading())
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    traced = None
    if job["trace"] and cuda:
        stretch = functools.partial(harness.train_stretch, trainer, pool,
                                    start + count, mix["trace_steps"],
                                    device, fault)
        if rank == 0:
            (n, wall), traced = trace_lib.profile(stretch)
            traced.update(count=n, window_s=wall)
        else:
            stretch()
    out = {"peak": peak, "forbidden": harness.forbidden_modules()}
    if rank == 0:
        failed = int((~torch.isfinite(torch.stack(losses))).sum()) \
            if losses else 0
        out.update(count=count, window_s=window_s, t0_wall=t0_wall,
                   stages=clock.stages() if clock else [], trace=traced,
                   failed=failed, readings=readings, split=split, host=host,
                   kind=torch.cuda.get_device_name(device) if cuda
                   else "cpu")
    return out


def global_steps(conf, mix, seed, ranks, device) -> list:
    """The first `check_steps` micro-steps of the global batch: each
    rank's rows in rank order, rank 0's flip."""
    short = dict(mix, pool=mix["check_steps"])
    pools = [traffic.train_pool(conf, short, seed, device, r)
             for r in range(ranks)]
    steps = []
    for parts in zip(*pools):
        batch = {k: torch.cat([b[k] for b, _ in parts])
                 for k in parts[0][0]}
        draws = {k: torch.cat([d[k] for _, d in parts])
                 if torch.is_tensor(v) else v
                 for k, v in parts[0][1].items()}
        steps.append((batch, draws))
    return steps


def reference(conf, mix, seed, device, precision="float32") -> dict:
    """The reference's readings over the global batch's first micro-steps
    (`reference.train.follow`)."""
    steps = global_steps(conf, mix, seed, mix["ranks"], device)
    return follow(conf, make_weights(conf["model_conf"], seed, device),
                  steps, seed, precision)


def numbers(readings: dict, ref: dict) -> dict:
    """The compared numbers of rank 0's readings against the reference's:
    the one-card cells' gradient and change gaps, the loss and its
    smoothness term of the first micro-step alone, and the replica gap.
    With Adam on every micro-step, the later steps' loss and smoothness
    gaps grow with the drift of the bfloat16 path under three updates,
    which the reference in bfloat16 shows as well (PERF.md); the first
    step's are taken before any update."""
    first = {k: v[:1] for k, v in readings.items() if k in ("loss", "eas")}
    ref_first = {k: v[:1] for k, v in ref.items() if k in ("loss", "eas")}
    out = check.train_numbers(dict(readings, **first),
                              dict(ref, **ref_first))
    return {"first_loss_gap": out["loss_gap"],
            "first_eas_gap": out["eas_gap"],
            "grad_median_gap": out["grad_median_gap"],
            "change_gap": out["change_gap"],
            "replica_gap": readings["replica_gap"]}


def _start(fn, conf, mix, job, device, seconds=0.0) -> list:
    backend = mix["backend"] if device.type == "cuda" else "gloo"
    try:
        return port.run_ranks(fn, mix["ranks"], (job,), backend,
                              mix["rank_timeout_s"] + seconds)
    except TimeoutError as err:
        raise RuntimeError(str(err)) from err


def run(bench, workload, conf, mix, seed, seconds, trace, device, fault,
        t_start) -> tuple:
    """One run of a train_dp cell, as `harness.run` returns it."""
    conf = dict(conf, accumulate_steps=mix["accumulate_steps"])
    device = torch.device(device or "cuda")
    job = {"conf": conf, "mix": mix, "seed": seed, "seconds": seconds,
           "trace": trace, "device": device.type, "fault": fault,
           "t_process": t_start}
    outs = _start(rank_run, conf, mix, job, device, seconds)
    bad = sorted(set(harness.forbidden_modules()).union(
        *(o["forbidden"] for o in outs)))
    if bad:
        raise RuntimeError("modules of JAX or the JAX package are loaded: "
                           + ", ".join(bad))
    first, ranks = outs[0], mix["ranks"]
    r = harness.Run(workload, conf, mix)
    r.chips = ranks
    r.work_flops = ranks * flops.train_step_flops(conf)
    r.count, r.window_s = first["count"], first["window_s"]
    r.stages, r.trace = first["stages"], first["trace"]
    peak = max(o["peak"] for o in outs)
    e2e = {"train_items_per_s":
           r.count * ranks * conf["batch_size"] / r.window_s,
           "peak_mem_gib": peak / harness.GIB,
           "setup_s": first["t0_wall"] - t_start}
    set_exact()
    ref_device = torch.device("cuda", 0) if device.type == "cuda" \
        else device
    got = numbers(first["readings"], reference(conf, mix, seed, ref_device))
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": first["kind"], "count": ranks,
                "memory_peak_bytes": int(peak)}
    return harness.result_line(bench, r, trace, e2e, got, dev_info,
                               first["failed"], first["host"]), \
        first["split"]


# ------------------------------------------------------------ calibration
def rank_readings(rank: int, world: int, job: dict):
    """Set-up's readings with the replica gap of each (seed, fault) of
    job["runs"], no window (rank 0's; None on the others)."""
    port.import_program()
    port.exact_f32()
    set_exact()
    device = rank_device(rank, job["device"])
    mix = dict(job["mix"], pool=job["mix"]["check_steps"])
    out = []
    for seed, fault in job["runs"]:
        conf = dict(job["conf"], seed=seed)
        trainer, _, readings = setup(conf, mix, seed, device,
                                     lambda _name: None, fault, rank, world)
        del trainer
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        out.append(readings)
    return out if rank == 0 else None


def readings(conf, mix, runs, control_seeds, device) -> list:
    """Rows of calibration: for each (seed, fault) of `runs` the program's
    compared numbers; for each seed of `control_seeds` also the control's
    (the reference in fp8 in the program's place) and the bfloat16
    reference's. The ranks read every run in one process group, then the
    references run here, one float32 reference a seed."""
    conf = dict(conf, accumulate_steps=mix["accumulate_steps"])
    job = {"conf": conf, "mix": mix, "device": device.type,
           "runs": [(int(s), f) for s, f in runs]}
    got = _start(rank_readings, conf, mix, job, device,
                 mix["rank_timeout_s"] * len(runs))[0]
    set_exact()
    ref_device = torch.device("cuda", 0) if device.type == "cuda" \
        else device
    refs, rows = {}, []
    for (seed, fault), prog in zip(runs, got):
        seed_conf = dict(conf, seed=seed)
        row = {"seed": seed, "fault": fault}
        if seed not in refs:
            t = time.time()
            refs[seed] = reference(seed_conf, mix, seed, ref_device)
            row["reference_s"] = time.time() - t
        row["program"] = numbers(prog, refs[seed])
        row["losses"] = {"program": prog["loss"],
                         "reference": refs[seed]["loss"]}
        row["eas"] = {"program": prog["eas"], "reference": refs[seed]["eas"]}
        if fault is None and seed in control_seeds:
            for name, precision in (("control", "fp8"),
                                    ("bf16_reference", "bfloat16")):
                ctl = reference(seed_conf, mix, seed, ref_device, precision)
                # One process in the program's place: a single replica.
                row[name] = numbers(dict(ctl, replica_gap=0.0), refs[seed])
                row["losses"][name] = ctl["loss"]
                row["eas"][name] = ctl["eas"]
        rows.append(row)
    return rows
