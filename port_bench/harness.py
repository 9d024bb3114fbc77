"""One run of one cell: set-up, the measured window, the traced stretch,
the reference check, the result.

A cell is an entry of `BENCHMARK.json`'s "workloads": a configuration
(`configs/<config>.json`, whose "port" block is the program's config as
it is run) and a traffic mix (`traffic/<mix>.json`). The mix's "loop"
picks the driver: "train" or "depth_stream" here, any other the module
`loops/<loop>.py` by its name (its `run`, called as this module's `run`
would be, after the cell's files are read). Per-layer metrics are read
by `metrics/<name>.py`, found by the metric's name.
"""
from __future__ import annotations

import copy
import functools
import gc
import importlib.util
import json
import math
import os
import statistics
import sys
import time
from collections import deque

import numpy as np
import torch

from port_bench import check, flops, traffic
from port_bench import port_api as port
from port_bench import trace as trace_lib
from port_bench.reference import set_exact
from port_bench.reference.model import selfview_depth
from port_bench.reference.precision import Precision
from port_bench.reference.train import follow, leaf_norms
from port_bench.weights import make_weights

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "behindthescenes_tpu")
GIB = 2.0 ** 30
NAME_CHARS = 160    # a kernel's name in the breakdown, cut to this length


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is
    JAX's, its libraries' or the JAX package's, compared whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def load_spec(workload: str) -> tuple:
    """(BENCHMARK.json, the cell's entry, its config file, its mix)."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    return (bench, cell, traffic.load_json("configs", cell["config"]),
            traffic.load_json("traffic", cell["traffic"]))


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


class Clock:
    """Stage marks of one step: CUDA events on the card, nothing on the
    CPU (where device times are not measured)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.steps = []

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.steps.append([("start", ev)])

    def mark(self, name: str):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.steps[-1].append((name, ev))

    def stages(self) -> list:
        """Per step {stage: ms from the previous mark to this one}."""
        out = []
        for marks in self.steps:
            out.append({b[0]: a[1].elapsed_time(b[1])
                        for a, b in zip(marks, marks[1:])})
        return out


class Run:
    """What the per-layer readers read: the cell, the window's counts and
    times, the stage marks, the traced stretch's reduced trace and the
    work of a step or frame."""

    def __init__(self, workload, conf, mix):
        self.workload, self.conf, self.mix = workload, conf, mix
        self.window_s = 0.0
        self.count = 0           # micro-steps or frames in the window
        self.stages = []         # per step {stage: ms}
        self.issue_ms = []
        self.latency_ms = []     # frames' service latencies
        self.trace = None        # trace_lib.reduce_events + window_s, count
        self.work_flops = 0      # model FLOPs of one step or frame
        self.chips = 1           # the cards that work runs on


def load_reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_reading() -> dict:
    """The host's CPU ticks (/proc/stat's first line), this process's CPU
    seconds, the load average and the cores' clocks: read at both ends of
    the window, so that each run's numbers stand beside the host's state."""
    with open("/proc/stat") as f:
        ticks = [int(x) for x in f.readline().split()[1:]]
    with open("/proc/cpuinfo") as f:
        info = [line.split(":", 1) for line in f if ":" in line]
    mhz = [float(v) for k, v in info if k.strip() == "cpu MHz"]
    model = next((v.strip() for k, v in info if k.strip() == "model name"),
                 "")
    return {"ticks": ticks, "cpu_s": time.process_time(),
            "load1": os.getloadavg()[0], "mhz": mhz, "model": model}


def host_state(a: dict, b: dict) -> dict:
    """Between two readings: the share of the host's CPU time that was
    busy and that was stolen by the hypervisor, this process's CPU
    seconds, the load average and the mean clock at the end."""
    d = [y - x for x, y in zip(a["ticks"], b["ticks"])]
    total = max(sum(d), 1)
    idle = d[3] + (d[4] if len(d) > 4 else 0)
    steal = d[7] if len(d) > 7 else 0
    mhz = b["mhz"] or a["mhz"]
    return {"cpu_model": b["model"], "cores": os.cpu_count(),
            "busy_share": (total - idle - steal) / total,
            "steal_share": steal / total,
            "process_cpu_s": b["cpu_s"] - a["cpu_s"],
            "load1": b["load1"],
            "mhz_mean": sum(mhz) / len(mhz) if mhz else None}


def setup_timer(t_start: float) -> tuple:
    """(split, timer): timer(name) records in split the wall seconds since
    its previous call, the first since `t_start`."""
    split, last = {}, [t_start]

    def timer(name):
        now = time.time()
        split[name] = now - last[0]
        last[0] = now
    return split, timer


# ---------------------------------------------------------------- training
def train_setup(conf, mix, seed, device, timer, fault=None,
                make_pool=traffic.train_pool):
    """The trainer from the seed's weights, the pool `make_pool(conf, mix,
    seed, device)` gives, and the readings of the first `check_steps`
    micro-steps driven through the window's own call."""
    weights = make_weights(conf["model_conf"], seed, device)
    sync(device)
    timer("weights")
    prog_conf = conf
    if fault == "fine_pass_dropped":
        prog_conf = copy.deepcopy(conf)
        prog_conf["renderer"].update(n_fine=0, n_fine_depth=0)
    trainer = port.make_trainer(prog_conf, weights, device)
    del weights
    if fault == "state_unchanged":
        trainer._update = lambda: None
    elif fault == "allreduce_dropped":
        trainer._reduce_grads = lambda: None
    sync(device)
    timer("program")
    pool = make_pool(conf, mix, seed, device)
    sync(device)
    timer("inputs")
    names = list(port.parameters(trainer))
    start = {n: t.detach().clone()
             for n, t in port.parameters(trainer).items()}
    losses, eas, grad = [], [], None
    for i in range(mix["check_steps"]):
        batch, draws = feed(pool, i, fault)
        out = trainer.train_step(batch, port.port_draws(draws))
        losses.append(float(out["loss"]))
        eas.append(float(out["loss_eas"]))
        if grad is None:
            grad = leaf_norms(port.first_gradient(trainer), names)
    params = port.parameters(trainer)
    change = torch.stack([(params[n].detach() - start[n]).double().norm()
                          for n in names])
    del start
    readings = {"loss": losses, "eas": eas, "grad": grad.cpu().numpy(),
                "change": change.cpu().numpy()}
    sync(device)
    timer("warm_up")
    return trainer, pool, readings


def feed(pool, i, fault=None):
    batch, draws = pool[i % len(pool)]
    if fault == "half_batch":
        half = batch["imgs"].shape[0] // 2
        batch = {k: v[:half] for k, v in batch.items()}
        draws = {k: (v[:half] if torch.is_tensor(v) else v)
                 for k, v in draws.items()}
    return batch, draws


def train_window(trainer, pool, start, seconds, device, clock=None,
                 fault=None, stop=None):
    """Closed loop of micro-steps over the pool for `seconds`, or until
    stop(micro-steps so far, seconds so far), asked before each
    micro-step, is true; returns (micro-steps, window seconds, loss
    tensors)."""
    mark = clock.mark if clock is not None else None
    if stop is None:
        def stop(_steps, elapsed):
            return elapsed >= seconds
    losses, i = [], start
    sync(device)
    t0 = time.perf_counter()
    while not stop(i - start, time.perf_counter() - t0):
        batch, draws = feed(pool, i, fault)
        if clock is not None:
            clock.start()
        out = trainer.train_step(batch, port.port_draws(draws), mark=mark)
        losses.append(out["loss"])
        i += 1
    sync(device)
    return i - start, time.perf_counter() - t0, losses


def train_stretch(trainer, pool, first, n, device, fault=None) -> tuple:
    """Micro-steps on the pool's batches first, first + 1, ... (n of
    them), to the end on the device: (n, their seconds)."""
    t0 = time.perf_counter()
    for k in range(n):
        batch, draws = feed(pool, first + k, fault)
        trainer.train_step(batch, port.port_draws(draws))
    sync(device)
    return n, time.perf_counter() - t0


def train_check(conf, mix, seed, device, pool, readings):
    """The compared numbers of the program's first micro-steps against the
    float32 reference following the same steps."""
    weights = make_weights(conf["model_conf"], seed, device)
    ref = follow(conf, weights, [pool[i] for i in range(mix["check_steps"])],
                 seed)
    return check.train_numbers(readings, ref)


# ------------------------------------------------------------------ depth
class Stream:
    """One camera client that keeps `max_in_flight` frames on the device (a
    closed loop): it sends the next frame as soon as a slot is free, else
    waits for its oldest frame. A frame is DepthEvaluator.render, then its
    depth map copied to a pinned host buffer; it is done when the copy has
    landed."""

    def __init__(self, evaluator, frames, mix, seed, device, fault=None):
        self.ev, self.frames, self.device = evaluator, frames, device
        self.fault = fault
        h, w = frames["imgs"].shape[1:3]
        pin = device.type == "cuda"
        self.bufs = [torch.empty((1, h, w), pin_memory=pin)
                     for _ in range(mix["max_in_flight"])]
        self.proj = frames["proj"][None, None]
        self.pose = torch.eye(4, device=device)[None, None]
        # Frames whose depth map is kept for the check: every
        # `mark_every`-th, from an offset drawn from the seed.
        self.mark_every = mix["mark_every"]
        self.mark_at = int(np.random.default_rng(seed).integers(
            self.mark_every))
        self.kept = {}

    def issue(self, i, slot, clock=None):
        pool = self.frames["imgs"].shape[0]
        img = self.frames["imgs"][i % pool][None, None]
        t = time.perf_counter()
        if clock is not None:
            clock.start()
        depth = self.ev.render(img, self.proj, self.pose,
                               mark=clock.mark if clock else None)
        issued = time.perf_counter()
        if self.fault == "answer_altered":
            depth = depth * 1.05
        self.bufs[slot].copy_(depth, non_blocking=True)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return i, slot, t, issued - t, done

    def finish(self, item) -> float:
        """Wait for a frame's depth map; keep it if it is marked. Returns
        when it landed (perf_counter)."""
        i, slot, _, _, done = item
        if done is not None:
            done.synchronize()
        end = time.perf_counter()
        if i % self.mark_every == self.mark_at:
            self.kept[i] = self.bufs[slot][0].numpy().copy()
        return end

    def run(self, seconds=None, frames=None, start=0, clock=None):
        """Frames start, start + 1, ... sent until `seconds` have passed
        (or `frames` frames are sent), each waited for to the end. Returns
        (frames landed within `seconds`, or all of `frames`; the seconds
        that took; latencies s of those frames, from being sent to
        landing; their issue s; the next frame's index)."""
        sync(self.device)
        lat, issue, queue = [], [], deque()
        free = list(range(len(self.bufs)))
        t0 = time.perf_counter()
        end = t0 + seconds if seconds is not None else math.inf
        k = done = 0

        def land(item):
            landed = self.finish(item)
            free.append(item[1])
            if landed <= end:
                lat.append(landed - item[2])
                issue.append(item[3])
                return 1
            return 0

        while (k < frames) if frames is not None \
                else time.perf_counter() < end:
            if free:
                queue.append(self.issue(start + k, free.pop(), clock))
                k += 1
            else:
                done += land(queue.popleft())
        while queue:
            done += land(queue.popleft())
        if frames is not None:
            return k, time.perf_counter() - t0, lat, issue, start + k
        return done, seconds, lat, issue, start + k


def depth_setup(conf, mix, seed, device, timer, fault=None):
    if device.type == "cuda":
        port.kernel_library()
    timer("kernel_library")
    weights = make_weights(conf["model_conf"], seed, device)
    sync(device)
    timer("weights")
    evaluator = port.make_depth_evaluator(conf, weights, device)
    del weights
    sync(device)
    timer("program")
    frames = traffic.frame_pool(conf, mix, seed, device)
    sync(device)
    timer("inputs")
    stream = Stream(evaluator, frames, mix, seed, device, fault)
    stream.run(frames=mix["warm_frames"])
    stream.kept.clear()
    timer("warm_up")
    return stream


def pick_frames(kept: dict, mix: dict, seed: int) -> list:
    """Up to `check_frames` of the kept frames, drawn from the seed, the
    latest kept frame among them."""
    rng = np.random.default_rng(seed + 2)
    idx = sorted(kept)
    take = max(mix["check_frames"], 1)
    pick = idx[-1:]
    if len(idx) > 1 and take > 1:
        pick += [int(i) for i in rng.choice(
            idx[:-1], size=min(take - 1, len(idx) - 1), replace=False)]
    return pick


def depth_numbers(conf, weights, frames, maps: dict) -> dict:
    """The worst frame's mean relative depth gap to the float32 reference,
    in units of the same gap of the reference computed in bfloat16 on
    that frame: maps {frame index: depth (h, w)} of frames from `frames`'s
    pool. The bfloat16 reference sets how far rounding alone moves this
    frame under these weights, which differs tenfold from seed to seed."""
    pool = frames["imgs"].shape[0]
    refs, worst = {}, float("nan") if not maps else 0.0
    with torch.no_grad():
        for i, got in maps.items():
            j = int(i) % pool
            if j not in refs:
                refs[j] = [selfview_depth(weights, frames["imgs"][j],
                                          frames["proj"], conf,
                                          Precision(p)).cpu().numpy()
                           for p in ("float32", "bfloat16")]
            exact, rounded = refs[j]
            worst = max(worst, check.depth_gap(got, exact)
                        / max(check.depth_gap(rounded, exact), 1e-12))
    return {"depth_gap_ratio": worst}


def depth_check(conf, mix, seed, device, frames, kept,
                precision="float32"):
    """The compared number of a depth run over a sample of its kept
    frames; `precision` other than float32 puts the reference computed
    in it in the program's place (the control)."""
    pick = pick_frames(kept, mix, seed)
    weights = make_weights(conf["model_conf"], seed, device)
    maps = {i: kept[i] for i in pick}
    if precision != "float32":
        pool = frames["imgs"].shape[0]
        with torch.no_grad():
            maps = {i: selfview_depth(weights, frames["imgs"][i % pool],
                                      frames["proj"], conf,
                                      Precision(precision)).cpu().numpy()
                    for i in pick}
    return depth_numbers(conf, weights, frames, maps)


# ----------------------------------------------------------------- a run
def run(workload, seed, seconds, trace, device=None, overrides=None,
        fault=None, t_process=None, mix_overrides=None):
    """One run of a cell. Returns (result dict, set-up split dict).
    device None means the card (the caller has checked it is there);
    overrides, mix_overrides: dicts merged into the config's "port"
    block and into the mix (tests cut sizes and change the model with
    them); fault: plants a fault in the timed path (tests:
    "state_unchanged", "half_batch", "fine_pass_dropped" (the program runs
    no fine pass, the reference does), "answer_altered"; on several
    ranks "allreduce_dropped" (each rank steps on its own gradient) and
    "shard_repeated" (every rank trains on rank 0's rows)); t_process:
    when the process started (the start of `setup_s`; default now)."""
    t_start = t_process if t_process is not None else time.time()
    split, timer = setup_timer(t_start)
    bench, cell, config, mix = load_spec(workload)
    conf = copy.deepcopy(config["port"])
    conf["data"] = copy.deepcopy(config["data"])
    _merge(conf, overrides or {})
    conf["seed"] = int(seed)
    mix = dict(mix, **(mix_overrides or {}))
    loop = mix["loop"]
    if loop not in ("train", "depth_stream"):
        if not os.path.exists(os.path.join(HERE, "loops", loop + ".py")):
            raise ValueError(f"unknown loop {loop!r}")
        driver = importlib.import_module("port_bench.loops." + loop)
        return driver.run(bench, workload, conf, mix, seed, seconds, trace,
                          device, fault, t_start)
    port.import_program()
    timer("imports")
    device = torch.device(device or "cuda")
    port.exact_f32()
    set_exact()
    if device.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
        kind = torch.cuda.get_device_name(device)
    else:
        kind = "cpu"
    timer("cuda_init")
    r = Run(workload, conf, mix)
    if loop == "train":
        r.work_flops = flops.train_step_flops(conf)
        trainer, pool, readings = train_setup(conf, mix, seed, device, timer,
                                              fault)
        split["kernel_library"] = 0.0
    else:
        r.work_flops = flops.depth_frame_flops(conf)
        stream = depth_setup(conf, mix, seed, device, timer, fault)
    setup_s = time.time() - t_start
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    clock = Clock(device) if trace else None
    failed = 0
    host0 = host_reading()
    if loop == "train":
        start = mix["check_steps"]
        r.count, r.window_s, losses = train_window(
            trainer, pool, start, seconds, device, clock, fault)
        failed = int((~torch.isfinite(torch.stack(losses))).sum()) \
            if losses else 0
        items = r.count * conf["batch_size"]
        e2e = {"train_items_per_s": items / r.window_s}
    else:
        r.count, r.window_s, lat, issue, next_i = stream.run(seconds,
                                                             clock=clock)
        r.issue_ms = [1e3 * s for s in issue]
        r.latency_ms = [1e3 * s for s in lat]
        e2e = {"frames_per_s": r.count / r.window_s}
    host = host_state(host0, host_reading())
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    e2e["peak_mem_gib"] = peak / GIB
    e2e["setup_s"] = setup_s
    if clock is not None:
        r.stages = clock.stages()
    if trace and device.type == "cuda":
        if loop == "train":
            stretch = functools.partial(train_stretch, trainer, pool,
                                        start + r.count, mix["trace_steps"],
                                        device, fault)
        else:
            n_traced = mix["trace_frames"]

            def stretch():
                got = stream.run(frames=n_traced, start=next_i)
                return got[0], got[1]
        sync(device)
        (count, window), reduced = trace_lib.profile(stretch)
        reduced.update(count=count, window_s=window)
        r.trace = reduced
    bad = forbidden_modules()
    if bad:
        raise RuntimeError("modules of JAX or the JAX package are loaded: "
                           + ", ".join(bad))
    # The check: the program's state freed first, then the reference.
    if loop == "train":
        del trainer
        pool = pool[:mix["check_steps"]]
    else:
        frames, kept = stream.frames, stream.kept
        del stream
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if loop == "train":
        numbers = train_check(conf, mix, seed, device, pool, readings)
    else:
        numbers = depth_check(conf, mix, seed, device, frames, kept)
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": kind, "count": 1, "memory_peak_bytes": int(peak)}
    return result_line(bench, r, trace, e2e, numbers, dev_info, failed,
                       host), split


def result_line(bench, r, trace, e2e, numbers, dev_info, failed, host):
    """The result of run `r`: correct from the compared `numbers` and the
    cell's limits, its end-to-end metrics `e2e` (trace off) or its
    per-layer metrics as the readers read `r` (trace on), the device,
    with the traced stretch's busy and window seconds and breakdown, the
    host's state over the window, and last the compared numbers with
    their limits."""
    workload = r.workload
    correct, compared = check.judge(numbers, check.load_limits(workload))
    metrics = {}
    if trace:
        for m in bench["per_layer"]:
            if applies(m, workload):
                value = load_reader(m["name"])(r)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if applies(m, workload):
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    result = {"correct": correct, "attempted": r.count, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if r.trace is not None:
        dev_info["busy_s"] = r.trace["busy_s"]
        dev_info["window_s"] = r.trace["window_s"]
        result["breakdown"] = {
            key: [[name[:NAME_CHARS], secs] for name, secs in r.trace[key]]
            for key in ("device_ops", "idle_gaps")}
    result["host"] = host
    result["check"] = compared
    return result


def p95(values) -> float:
    """The 95th percentile (statistics.quantiles, exclusive method)."""
    if len(values) < 2:
        return values[0] if values else math.nan
    return statistics.quantiles(values, n=20)[18]


def _merge(base: dict, over: dict) -> None:
    """Merge `over` into `base`, dict into dict; a block whose "type"
    differs from the base's (another encoder, another MLP) replaces it
    whole, since its keys are its own."""
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict) \
                and v.get("type", base[k].get("type")) == base[k].get("type"):
            _merge(base[k], v)
        else:
            base[k] = copy.deepcopy(v)
