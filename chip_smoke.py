#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (behindthescenes_tpu_torch).

    python3 chip_smoke.py          # from the root of the repository

Builds the port's CUDA kernels from csrc/, serves single-image depth of the
flagship ResNet-50 model (media/weights/flagship_fast_conv.npz) at 192x640
with 64 samples on the 4 synthetic scenes of the JAX package's depth gate
(tests/test_train_fast_gate.py), deterministic, jittered f32 and jittered
bf16, and holds the depth metrics to that gate's bounds. Shows through the
launch counters that serving went through every kernel, holds each kernel
against its plain PyTorch version on the flagship activations of one frame,
and times kernels, plain versions and whole frames with CUDA events.

Prints one progress line per phase (flushed, with the phase's seconds),
then a JSON line of frame times and metrics, one JSON line with a record
per kernel, the card's name and power limit, and as the last line
{"ok": true, "device": {...}}. Any failure
raises, so the exit code is not 0. Needs one CUDA device; without one it
stops with an error.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

WEIGHTS = "media/weights/flagship_fast_conv.npz"
N_SCENES = 4
# The flagship depth gate's bounds (tests/test_train_fast_gate.py:34-35).
ABS_REL_MAX = 0.24
A1_MIN = 0.49
# Kernel vs plain version (atol, rtol): the JAX package's kernel tests
# (test_pallas_shared_z.py:36, test_pallas_selfview.py:31,
# test_pallas_jitter.py).
TOLERANCE = {"shared_z": (1e-5, 0.0), "selfview": (3e-5, 0.0),
             "jitter_density": (2e-2, 2e-2)}
# H100 SXM peaks at 700 W (NVIDIA data sheet, dense): HBM bytes/s, f32
# FLOP/s on the CUDA cores, bf16 FLOP/s on the tensor cores.
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
BF16_FLOP_S = 989e12
KERNEL_META = {
    "shared_z": ("behindthescenes_tpu_torch/csrc/shared_z.cu",
                 "behindthescenes_tpu/ops/pallas/shared_z.py:62"),
    "jitter_density": ("behindthescenes_tpu_torch/csrc/jitter_density.cu",
                       "behindthescenes_tpu/ops/pallas/jitter_density.py:196"),
    "selfview": ("behindthescenes_tpu_torch/csrc/selfview.cu",
                 "behindthescenes_tpu/ops/pallas/selfview.py:78"),
}

_T0 = time.perf_counter()


def log(phase: str, msg: str, t_phase: float) -> None:
    print(f"[chip_smoke] {phase}: {msg} ({time.perf_counter() - t_phase:.1f} s"
          f" phase, {time.perf_counter() - _T0:.1f} s total)", flush=True)


def gpu_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_metrics(mode: str, means: dict) -> None:
    print(f"[chip_smoke] {mode} depth metrics: "
          + json.dumps({k: round(v, 6) for k, v in means.items()}),
          flush=True)
    if not (means["abs_rel"] <= ABS_REL_MAX and means["a1"] >= A1_MIN):
        raise AssertionError(
            f"{mode}: abs_rel {means['abs_rel']:.4f} (max {ABS_REL_MAX}), "
            f"a1 {means['a1']:.4f} (min {A1_MIN})")


@contextlib.contextmanager
def recorded_kernel_args():
    """Records the arguments of the last call of each kernel wrapper that
    the serving path makes (models/mlp.py calls the wrappers by name), so
    that the kernels are checked and timed on the very inputs serving
    gives them. Yields {kernel name: (args, kwargs)}."""
    from behindthescenes_tpu_torch.models import mlp
    from behindthescenes_tpu_torch.ops import kernels
    record, saved = {}, {}
    for name, fn in kernels.KERNELS.items():
        if getattr(mlp, fn.__name__) is not fn:
            raise AssertionError(f"models/mlp.py no longer calls the "
                                 f"{name} wrapper by name")

        def recorder(*args, _name=name, _fn=fn, **kwargs):
            record[_name] = (args, kwargs)
            return _fn(*args, **kwargs)
        saved[fn.__name__] = fn
        setattr(mlp, fn.__name__, recorder)
    try:
        yield record
    finally:
        for attr, fn in saved.items():
            setattr(mlp, attr, fn)


def work(name: str, args, kwargs):
    """(bytes the kernel must move, FLOP, peak FLOP/s of their type) of one
    call with these arguments: each input read once, each output written
    once; the decode's FLOP per sample are `kernel_cost` of
    behindthescenes_tpu/ops/pallas/jitter_density.py:69-90."""
    if name == "shared_z":
        hs, hd = args[0], args[1]
        (b, h), k = hs.shape, hd.shape[0]
        return 4 * (b * h + k * h + h + 1 + b * k), 4 * b * k * h, F32_FLOP_S
    if name == "selfview":
        h_static, coord = args[0], args[1]
    else:
        coord, h_static = args[0], args[1]
    (b, k), h = coord.shape, h_static.shape[1]
    n_code = 1 + 2 * kwargs["n_freqs"]
    flop = b * k * (2 * n_code + 2 * n_code * h + 4 * h)
    if name == "selfview":
        return 4 * (b * h + 2 * b * k + (n_code + 2) * h + 1), flop, \
            F32_FLOP_S
    return (2 * b * h + 8 * b * k + 2 * (n_code + 2) * h + 4, flop,
            BF16_FLOP_S)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device found; this run "
                         "measures the card and does not fall back to the "
                         "CPU")
    # Fails here, before any output, where the port is not beside us.
    from behindthescenes_tpu_torch import eval_depth
    from behindthescenes_tpu_torch.ops import kernels
    from behindthescenes_tpu_torch.ops.kernels import _build
    from behindthescenes_tpu_torch.ops.kernels.jitter_density import \
        jitter_density_plain
    from behindthescenes_tpu_torch.ops.kernels.selfview import \
        selfview_density_plain
    from behindthescenes_tpu_torch.ops.kernels.shared_z import \
        shared_z_tail_plain
    from behindthescenes_tpu_torch.platform import resolve_device

    # -- 1: the card and the kernels' build --------------------------------
    t = time.perf_counter()
    card = gpu_name_and_power()
    print(card, flush=True)
    dev = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"[chip_smoke] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {kind}", flush=True)
    log("phase 1 card", card, t)
    t = time.perf_counter()
    _build.library()
    log("phase 1 build", f"one nvcc call over {len(_build.sources())} "
        f"sources into {_build.BUILD_DIR}", t)

    # -- 2: weights -------------------------------------------------------
    t = time.perf_counter()
    net32 = eval_depth.load_model(WEIGHTS, device=dev)
    net16 = eval_depth.load_model(WEIGHTS, bf16=True, device=dev)
    log("phase 2 weights", f"{WEIGHTS} f32 and bf16 on {dev}", t)
    t = time.perf_counter()
    batches = eval_depth.scenes(N_SCENES)
    log("phase 2 scenes", f"{N_SCENES} synthetic scenes at "
        f"{eval_depth.IMAGE_SIZE} ray-cast on the host", t)

    # -- 3, 4: serving (the main path) ------------------------------------
    # Each kernel keeps the arguments of its last launch in serving (one
    # frame's flagship activations) for phases 5 and 6.
    kernels.reset_launch_counts()
    serving = {}
    with recorded_kernel_args() as recorded:
        for mode, net, jitter, kernel in (
                ("deterministic", net32, False, "shared_z"),
                ("jittered f32", net32, True, "selfview"),
                ("jittered bf16", net16, True, "jitter_density")):
            t = time.perf_counter()
            before = kernels.launch_counts()[kernel]
            means, _ = eval_depth.evaluate(net, batches, jitter=jitter)
            torch.cuda.synchronize()
            check_metrics(mode, means)
            launched = kernels.launch_counts()[kernel] - before
            if launched <= 0:
                raise AssertionError(f"{mode}: the {kernel} kernel never "
                                     "ran")
            serving[mode] = means
            log(f"phase {3 if mode == 'deterministic' else 4} {mode}",
                f"{kernel} launches {launched}", t)
    launches = kernels.launch_counts()
    print(f"[chip_smoke] main-path launches {json.dumps(launches)}",
          flush=True)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")

    # -- 5: each kernel against its plain version -------------------------
    t = time.perf_counter()
    plain = {"shared_z": shared_z_tail_plain,
             "selfview": selfview_density_plain,
             "jitter_density": jitter_density_plain}
    calls = {name: (lambda n=name: kernels.KERNELS[n](*recorded[n][0],
                                                      **recorded[n][1]),
                    lambda n=name: plain[n](*recorded[n][0],
                                            **recorded[n][1]))
             for name in kernels.KERNELS}
    # The f32 kernels are held against their plain version evaluated in
    # float64 on the same f32 inputs: two f32 sums of the same 64 terms
    # (|out| up to ~20 here) in different orders already differ by ~1e-5,
    # so an f32 plain run would test the orders, not the kernel. The bf16
    # kernel is held against its plain version as it runs (bf16 rounding
    # at the same places), as the JAX package's test does.

    def in_float64(name):
        args, kwargs = recorded[name]
        return plain[name](*(a.double() if a.is_floating_point() else a
                             for a in args), **kwargs)
    references = {"shared_z": lambda: in_float64("shared_z"),
                  "selfview": lambda: in_float64("selfview"),
                  "jitter_density": calls["jitter_density"][1]}
    err = {}
    with torch.no_grad():
        for name, (kernel_fn, plain_fn) in calls.items():
            got, want = kernel_fn(), references[name]().float()
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.isfinite(got).all():
                raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                                     f"{tuple(want.shape)} or not finite")
            atol, rtol = TOLERANCE[name]
            dev_abs = (got - want).abs()
            err[name] = dev_abs.max().item()
            excess = (dev_abs - atol - rtol * want.abs()).max().item()
            plain_f32 = (got - plain_fn().float()).abs().max().item()
            print(f"[chip_smoke] {name} at {tuple(got.shape)}: max abs "
                  f"deviation {err[name]:.3e} from the plain version "
                  f"({'float64' if name != 'jitter_density' else 'bf16'}; "
                  f"atol {atol}, rtol {rtol}), {plain_f32:.3e} from it run "
                  f"in the kernel's own types; max |out| "
                  f"{want.abs().max().item():.3f}", flush=True)
            if excess > 0:
                raise AssertionError(f"{name}: kernel and plain version "
                                     f"disagree beyond tolerance "
                                     f"(max abs {err[name]:.3e})")
    log("phase 5 kernels vs plain", "all within tolerance", t)

    # -- 6: timing ---------------------------------------------------------
    t = time.perf_counter()
    records = []
    with torch.no_grad():
        for name, (kernel_fn, plain_fn) in calls.items():
            ms_kernel = cuda_ms(kernel_fn, iters=20)
            ms_plain = cuda_ms(plain_fn, iters=5, warmup=1)
            nbytes, flop, peak = work(name, *recorded[name])
            t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flop / peak * 1e3
            source, replaces = KERNEL_META[name]
            records.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": err[name], "ms": ms_kernel,
                "plain_ms": ms_plain, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None})
            print(f"[chip_smoke] {name}: kernel {ms_kernel:.4f} ms, plain "
                  f"{ms_plain:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
                  f"({records[-1]['bound_by']}; {nbytes / 1e6:.1f} MB, "
                  f"{flop / 1e9:.2f} GFLOP)", flush=True)
        frame_ms, encode_ms = {}, {}
        height, width = eval_depth.IMAGE_SIZE
        n_coarse = eval_depth.FLAGSHIP_RENDERER.n_coarse
        for mode, net, jitter in (("deterministic", net32, False),
                                  ("jittered f32", net32, True),
                                  ("jittered bf16", net16, True)):
            ev = eval_depth.DepthEvaluator(net, eval_depth.FLAGSHIP_RENDERER,
                                           eval_depth.FLAGSHIP_MODEL_CONF,
                                           jitter=jitter)
            args = [torch.as_tensor(batches[0][key], device=dev)
                    for key in ("imgs", "projs", "poses")]
            gen = torch.Generator(device=dev)
            gen.manual_seed(eval_depth.SEED)
            depth = ev.render(*args, generator=gen)
            if tuple(depth.shape) != (1, *eval_depth.IMAGE_SIZE) or \
                    not torch.isfinite(depth).all():
                raise AssertionError(f"{mode}: depth {tuple(depth.shape)} "
                                     "not finite or of the wrong shape")
            frame_ms[mode] = cuda_ms(lambda: ev.render(*args, generator=gen),
                                     iters=30)
            encode_ms[mode] = cuda_ms(lambda: net.encode(
                args[0], args[1], args[2], ids_encoder=[0]), iters=30)
            print(f"[chip_smoke] whole frame {mode} (encode + decode + "
                  f"composite, {height}x{width}x{n_coarse}): "
                  f"{frame_ms[mode]:.3f} ms, of which encode "
                  f"{encode_ms[mode]:.3f} ms", flush=True)
    log("phase 6 timing", card, t)

    print(json.dumps({"frame_ms": frame_ms, "encode_ms": encode_ms,
                      "serving": serving}), flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
