#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (behindthescenes_tpu_torch).

    python3 chip_smoke.py          # from the root of the repository

Builds the port's CUDA kernels from csrc/, serves single-image depth of the
flagship ResNet-50 model (media/weights/flagship_fast_conv.npz) at 192x640
with 64 samples on the 4 synthetic scenes of the JAX package's depth gate
(tests/test_train_fast_gate.py) in four modes: deterministic f32,
deterministic bf16 (the JAX package's default evaluation), jittered f32 and
jittered bf16; holds the depth metrics to that gate's bounds. Shows through
the launch counters that serving went through every kernel, holds each
kernel against its plain PyTorch version on the flagship activations of one
frame of each mode and on ragged shapes, and times kernels, plain versions
and whole frames with CUDA events.

Then trains the flagship model (configs/exp_synthetic_flagship.yaml:
ResNet-50, 4 items at 192x640, 2048 rays x 64 samples, Adam at 1e-4) from
the same checkpoint: phase 7 holds one f32 step on the card against the
same step on the host CPU in float64 (loss, and every parameter's
gradient norm);
phase 8 runs 30 steps in bf16 and in f32 on one cached batch with fixed
draws and times them, split into encode, ray sampling and render, loss,
backward and optimiser; both check through the launch counters that
training reaches none of the three decode kernels. Phase 9 serves the
depth gate through the general cross-view path (eval_selfview: false) and
holds it to the gate and to the self-view metrics of phase 3.

Then evaluates the repository's configs through the port's config-driven
task runner (behindthescenes_tpu_torch.eval), at their own sizes, each
held to the means the JAX package printed for the same command on the
CPU: phase 10 novel-view synthesis of the flagship
(eval_synthetic_flagship_nvs: 4 scenes at 192x640, 24 coarse + 16
importance-fine samples reusing the coarse ones, bf16), phase 11 that of
the RE10K-shape model (eval_synthetic_re10k_nvs: 8 indoor scenes at
256x384, 48 samples, distance code, one-block MLP), each with its frame
time split into encode and render and its peak memory, and no decode
kernel launched; phase 12 depth through exp_synthetic_re10k (self-view,
distance code) and eval_synthetic_flagship (bf16, through the shared_z
kernel, whose launches it counts). Phase 13 holds the fine pass's value
on the thin-structure checkpoint: 8 coarse + 8 fine beats 16 flat, and
reusing the coarse samples equals re-querying them.

Then evaluates KITTI-360 occupancy with the synthetic-KITTI-360 checkpoint
(media/weights/k360_synth_conv.npz: ResNet-50, 192x640, 64 samples) on the
JAX package's occupancy gate drive, which the port generates and
preprocesses on the host into a temporary directory
(datasets/gen_synthetic_kitti_360.make_gate_tree): phase 14 the LiDAR
occupancy of configs/eval_lidar_occ.yaml over its 4 keyframes in bf16
(one jitter_density launch per keyframe) and over 1 keyframe in f32 (one
selfview launch), phase 15 the 3D-box occupancy of configs/eval_3dbb.yaml
over 2 frames (the pseudo-depth at 96x320: one jitter_density launch of
30,720 rays per frame). Each launch is held against its plain version,
the means to the JAX gate's bounds and to the JAX package's CPU means for
the same command, and each frame's time is split into encode, pseudo-depth
render, density query and host ground truth.

Then, on the same drive, phase 16 runs the paper's KITTI-360 training
(configs/exp_kitti_360.yaml at full width: ResNet-50, 192x640, batch 4 x
accumulate_steps 4, 8 views an item, 4096 rays x 64 samples, bf16, colour
jitter) through `python -m behindthescenes_tpu_torch.train -cn
exp_kitti_360`'s task: its fisheye frames preprocessed, the encoder from a
torchvision-keyed ResNet-50 `.pth` written from k360_synth_conv.npz, 30
micro-steps in this process and 10 more in a second one that auto-resumes.
It holds the checkpoints, best steps, the bit-equal restore and the
resumed micro-step to the JAX harness's rules, checks that no decode
kernel ran, holds run_validation of the checkpoint to the JAX package's
CPU means, and splits a micro-step at the trainer's mark points, beside
the loader's wait, the update, checkpoint and validation times.

Prints one progress line per phase (flushed, with the phase's seconds),
then a JSON line of frame times, metrics and training times, one JSON line
with a record per kernel, the card's name and power limit, and as the
last line {"ok": true, "device": {...}}. Any failure raises, so the exit
code is not 0. Needs one CUDA device; without one it stops with an
error.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

WEIGHTS = "media/weights/flagship_fast_conv.npz"
N_SCENES = 4
# The flagship depth gate's bounds (tests/test_train_fast_gate.py:34-35).
ABS_REL_MAX = 0.24
A1_MIN = 0.49
# Serving modes: (mode, bf16 compute, jitter, kernel wrapper, record).
# A record is one kernel on one mode's arguments; shared_z serves both
# deterministic modes, in f32 and with bf16 inputs.
MODES = (("deterministic f32", False, False, "shared_z", "shared_z"),
         ("deterministic bf16", True, False, "shared_z", "shared_z_bf16"),
         ("jittered f32", False, True, "selfview", "selfview"),
         ("jittered bf16", True, True, "jitter_density", "jitter_density"))
# Kernel vs plain version (atol, rtol): the JAX package's kernel tests
# (test_pallas_shared_z.py:36, test_pallas_selfview.py:31,
# test_pallas_jitter.py). The f32 kernels and the bf16 shared_z are held
# against their plain version evaluated in float64 on the same inputs
# (bf16 inputs stay bf16, so hs + hd rounds where the kernel rounds it and
# only the f32 sum is left to differ); jitter_density against its plain
# version as it runs, bf16 rounding at the same places.
TOLERANCE = {"shared_z": (1e-5, 0.0), "shared_z_bf16": (1e-5, 0.0),
             "selfview": (3e-5, 0.0), "jitter_density": (2e-2, 2e-2)}
# The ragged checks: rays of one frame cut to a number that is no multiple
# of the kernels' blocks of rays (4 warps, 32-ray tiles, 256 threads), with
# (H, K) cuts at both widths the kernels are built for, each leaving
# jitter_density and shared_z a partial last tile of samples: K = 44 ends
# in one partial tile of 16, K = 24 (exp_synthetic's samples at its H =
# 32) in a pair; both are partial chunks of shared_z f32's 64 samples. The
# width-48 cut runs the runtime-shape kernels of shared_z and
# jitter_density, which serve the widths the others are not built for.
RAGGED_B = 1001
RAGGED_HK = ((64, 44), (32, 24))
RAGGED_ANY_HK = ((48, 44),)
# Octave counts other than the built 6, which run the runtime-shape
# jitter_density kernel at the first ragged cut, on W_d rows drawn from
# RAGGED_SEED.
RAGGED_OCTAVES = (4, 8)
RAGGED_SEED = 0
# H100 SXM peaks at 700 W (NVIDIA data sheet and H100 architecture white
# paper, dense): HBM bytes/s, f32 FLOP/s and bf16 FLOP/s on the CUDA cores,
# bf16 FLOP/s on the tensor cores.
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
BF16_VEC_FLOP_S = 133.8e12
BF16_FLOP_S = 989e12
KERNEL_META = {
    "shared_z": ("behindthescenes_tpu_torch/csrc/shared_z.cu",
                 "behindthescenes_tpu/ops/pallas/shared_z.py:62"),
    "shared_z_bf16": ("behindthescenes_tpu_torch/csrc/shared_z.cu",
                      "behindthescenes_tpu/ops/pallas/shared_z.py:62"),
    "jitter_density": ("behindthescenes_tpu_torch/csrc/jitter_density.cu",
                       "behindthescenes_tpu/ops/pallas/jitter_density.py:196"),
    "selfview": ("behindthescenes_tpu_torch/csrc/selfview.cu",
                 "behindthescenes_tpu/ops/pallas/selfview.py:78"),
}
# Each record's kernel in ptxas's report: a piece of its mangled name (at
# the served H = 64).
PTXAS_NAME = {"shared_z": "shared_z_f32_kernelILi64E",
              "shared_z_bf16": "shared_z_bf16_kernelILi64ELi4E",
              "selfview": "selfview_density_kernelILi64E",
              "jitter_density": "jitter_density_kernelILi64E"}

# Training (phases 7 and 8): the built-in config of the port's train.py,
# the draws' numpy seed, the steps and the first step timed.
TRAIN_CONFIG = "exp_synthetic_flagship"
TRAIN_SEED = 0
TRAIN_STEPS = 30
TIMED_FROM = 5
# Phase 7's bounds: the card's f32 loss and each parameter's gradient norm
# (of the tensors whose norm exceeds GRAD_NORM_FLOOR of the largest) against
# the same step on the host CPU, evaluated there in float64: the host's own
# f32 step is the less exact of the two (1.3e-3 from float64 on three
# BatchNorm tensors of the first stage, the card's f32 step 2.4e-4 at
# most; tools/train_precision.py on an NVIDIA H100 80GB HBM3 at 700 W).
LOSS_RTOL = 1e-4
GRAD_NORM_RTOL = 1e-3
GRAD_NORM_FLOOR = 1e-6
# Phase 9: the general path against the self-view path, per scene
# (tests/test_accuracy_gate.py:153-155), each bound times max(1, value).
GENERAL_BOUNDS = (("abs_rel", 0.02), ("a1", 0.05), ("rmse", 0.05))
STAGES = ("encode", "render", "loss", "backward", "optimizer")

# Phases 10-12: configs of configs/ with their checkpoints, through the
# port's task runner, and the means that the JAX package printed for the
# same command on the CPU (`JAX_PLATFORMS=cpu python eval.py -cn <config>
# checkpoint=<npz>`, all scenes of each config). The two sides draw their
# jitter from different generators, so the gap is sampling noise and
# rounding; JAX_GAP bounds it.
RE10K_WEIGHTS = "media/weights/re10k_synth_conv.npz"
THIN_WEIGHTS = "media/weights/thin_synth_conv.npz"
CONFIG_RUNS = (
    ("10", "eval_synthetic_flagship_nvs", WEIGHTS,
     {"psnr": 21.737083151764843, "ssim": 0.8550886325707533}),
    ("11", "eval_synthetic_re10k_nvs", RE10K_WEIGHTS,
     {"psnr": 34.67743968537996, "ssim": 0.9651916788752829}),
    ("12", "exp_synthetic_re10k", RE10K_WEIGHTS,
     {"abs_rel": 0.11355338990688324, "a1": 0.9073164198133682}),
    ("12", "eval_synthetic_flagship", WEIGHTS,
     {"abs_rel": 0.2174396589398384, "a1": 0.5499790945193574}),
)
JAX_GAP = {"psnr": 0.15, "ssim": 0.005, "abs_rel": 0.005, "a1": 0.01}
# The JAX package's own NVS gate floors for these families
# (tests/test_nvs_gate_re10k.py:36-37, measured at 64x96;
# tests/test_train_anneal_gate.py:31-32, flagship shape at 96x320).
NVS_FLOORS = {"eval_synthetic_re10k_nvs": {"psnr": 27.2, "ssim": 0.87},
              "eval_synthetic_flagship_nvs": {"psnr": 17.9, "ssim": 0.70}}
# Timed NVS frames per config (after one untimed frame).
NVS_TIMED_FRAMES = 5
# Phase 13 (tests/test_fine_gate_thin.py:41,103): the thin-structure
# checkpoint on 4 held-out scenes at 96x128 in f32 (as that gate), 8 coarse
# + 8 fine with reuse against 16 flat, and reuse against re-query at 16 +
# 16.
THIN_CONFIG = "eval_synthetic_thin_nvs"
THIN_OVERRIDES = ("data.length=32", "bf16=false")
FINE_PROFILES = {
    "8+8 reuse": ("renderer.n_coarse=8", "renderer.n_fine=8",
                  "renderer.fine_reuse_coarse=true"),
    "16 flat": ("renderer.n_coarse=16", "renderer.n_fine=0"),
    "16+16 reuse": ("renderer.n_coarse=16", "renderer.n_fine=16",
                    "renderer.fine_reuse_coarse=true"),
    "16+16 re-query": ("renderer.n_coarse=16", "renderer.n_fine=16",
                       "renderer.fine_reuse_coarse=false")}
FINE_MARGIN_MIN = 0.14
REUSE_GAP_MAX = 0.05

# Phases 14-15: the occupancy configs with the synthetic-KITTI-360
# checkpoint on the occupancy gate's drive (make_gate_tree), each run
# (phase, config, split directory, its keyframes, overrides, record)
# launching the record's kernel once per keyframe (OCC_RECORDS) on
# OCC_RAYS rays. The split directories other than `splits` (the 4
# keyframes) hold the first keyframes of the gate.
K360_WEIGHTS = "media/weights/k360_synth_conv.npz"
OCC_RUNS = (
    ("14", "eval_lidar_occ", "splits", (2, 5, 8, 11), (),
     "jitter_density_lidar"),
    ("14", "eval_lidar_occ", "splits_first1", (2,), ("bf16=false",),
     "selfview_lidar"),
    ("15", "eval_3dbb", "splits_first2", (2, 5), (), "jitter_density_bbox"),
)
OCC_RECORDS = {"jitter_density_lidar": "jitter_density",
               "selfview_lidar": "selfview",
               "jitter_density_bbox": "jitter_density"}
OCC_RAYS = {"jitter_density_lidar": 192 * 640, "selfview_lidar": 192 * 640,
            "jitter_density_bbox": 96 * 320}
# The JAX package's means on the CPU for the same command on the tree its
# own scripts generate (the gate's, scripts/datasets/
# gen_synthetic_kitti_360.py and preprocess_kitti_360.py, with the split
# files of make_gate_tree): `JAX_PLATFORMS=cpu python eval.py -cn <config>
# checkpoint=media/weights/k360_synth_conv.npz data.data_path=<tree>
# data.pose_path=<tree>/data_poses data.split_path=<tree>/<split>
# data.is_preprocessed=true`. The two sides draw different jitter, which
# moves only the predicted visibility mask; OCC_GAP bounds the gap.
OCC_JAX_MEANS = {
    "jitter_density_lidar": {"o_acc": 0.91767578125,
                             "ie_prec": 0.649168194692345,
                             "ie_rec": 0.4413175512777716},
    "jitter_density_bbox": {"o_acc": 0.9152573529411765,
                            "ie_prec": 0.6324734089439972,
                            "ie_rec": 0.3125602285242291},
}
OCC_GAP = {"o_acc": 0.005, "ie_prec": 0.01, "ie_rec": 0.01}
# The JAX occupancy gate's floors (tests/test_occupancy_gate.py:40-42 and
# :140-141).
OCC_FLOORS = {"jitter_density_lidar": {"o_acc": 0.85, "ie_prec": 0.55,
                                       "ie_rec": 0.38},
              "jitter_density_bbox": {"o_acc": 0.82, "ie_rec": 0.25}}
OCC_METRICS = ("o_acc", "o_prec", "o_rec", "ie_acc", "ie_prec", "ie_rec")
OCC_STAGES = ("encode", "render", "query", "ground_truth")

# Phase 16: the paper's KITTI-360 training run (configs/exp_kitti_360.yaml:
# ResNet-50, 192x640, batch 4 x accumulate_steps 4, 8 views an item, 4096
# patch rays x 64 samples, bf16) on the gate drive, its fisheye frames
# preprocessed at the config's rotation, the encoder initialised from a
# torchvision-keyed ResNet-50 `.pth` written from K360_WEIGHTS. A first
# run in this process to `stops[0]` micro-steps, then a second process
# on the same output_path to `stops[1]`, which auto-resumes.
K360_TRAIN_CONFIG = "exp_kitti_360"
K360_RUN = {"stops": (30, 40), "checkpoint_every": 10, "validate_every": 16,
            "timed_from": 5}
# The JAX package's run_validation means of K360_WEIGHTS on the drive's
# test split for the same command, on this sandbox's CPU
# (`JAX_PLATFORMS=cpu python3 tools/k360_val_reference.py`: the same
# files, bf16, 4 items of 8 views); the two sides draw different jitter.
K360_VAL_JAX = {"abs_rel": 0.12195942178368568, "a1": 0.9036229252815247}
K360_VAL_GAP = {"abs_rel": 0.005, "a1": 0.01}
# Micro-steps on one cached batch after the runs (the first 2 not timed).
K360_CACHED_STEPS = 8
# The micro-step's points: the harness's "wait" (the next batch asked for)
# and "data" (on the card), then the train step's STAGES.
RUN_POINTS = ("wait", "data") + STAGES

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
    """Records, per serving mode, the arguments of the last call of each
    kernel wrapper that the serving path makes (models/mlp.py calls the
    wrappers by name), so that the kernels are checked and timed on the
    very inputs serving gives them. Yields ({mode: {kernel name: (args,
    kwargs)}}, state); the caller sets state["mode"] before each mode, and
    a list in state["calls"] gets every call's (kernel name, args,
    kwargs)."""
    from behindthescenes_tpu_torch.models import mlp
    from behindthescenes_tpu_torch.ops import kernels
    record, saved, state = {}, {}, {"mode": None}
    for name, fn in kernels.KERNELS.items():
        if getattr(mlp, fn.__name__) is not fn:
            raise AssertionError(f"models/mlp.py no longer calls the "
                                 f"{name} wrapper by name")

        def recorder(*args, _name=name, _fn=fn, **kwargs):
            record.setdefault(state["mode"], {})[_name] = (args, kwargs)
            if state.get("calls") is not None:
                state["calls"].append((_name, args, kwargs))
            return _fn(*args, **kwargs)
        saved[fn.__name__] = fn
        setattr(mlp, fn.__name__, recorder)
    try:
        yield record, state
    finally:
        for attr, fn in saved.items():
            setattr(mlp, attr, fn)


def ragged(kernel: str, args, h: int, k: int):
    """A kernel's arguments cut to RAGGED_B rays, k samples and the first
    h hidden units."""
    if kernel == "shared_z":
        hs, hd, w_out, b_out = args
        return (hs[:RAGGED_B, :h].contiguous(), hd[:k, :h].contiguous(),
                w_out[:h].contiguous(), b_out)
    args = list(args)
    hs_arg, coord_arg = (0, 1) if kernel == "selfview" else (1, 0)
    args[hs_arg] = args[hs_arg][:RAGGED_B, :h].contiguous()
    args[coord_arg] = args[coord_arg][:RAGGED_B, :k].contiguous()
    # W_d or W_z (13, H), b_in and w_out (H,); b_out stays
    args[2:5] = [w if w.shape[-1] == h else w[..., :h].contiguous()
                 for w in args[2:5]]
    return tuple(args)


def octave_cut(args, kwargs, n_freqs: int):
    """jitter_density's arguments and keywords for `n_freqs` octaves: W_d
    redrawn as 1 + 2 n_freqs rows from RAGGED_SEED, at the scale and in the
    dtype of the recorded W_d."""
    import torch
    w_d = args[2]
    gen = torch.Generator(device=w_d.device)
    gen.manual_seed(RAGGED_SEED)
    rows = torch.randn((1 + 2 * n_freqs, w_d.shape[1]), generator=gen,
                       device=w_d.device)
    args = list(args)
    args[2] = (rows * w_d.float().std()).to(w_d.dtype)
    return tuple(args), dict(kwargs, n_freqs=n_freqs)


def work(name: str, args, kwargs):
    """(bytes the kernel must move, {peak FLOP/s: FLOP of that type}) of
    one call with these arguments: each input read once, each output
    written once; each operation at the peak of its type. The decodes'
    FLOP per sample are `kernel_cost` of
    behindthescenes_tpu/ops/pallas/jitter_density.py:69-90."""
    if name.startswith("shared_z"):
        hs, hd = args[0], args[1]
        (b, h), k = hs.shape, hd.shape[0]
        nbytes = hs.element_size() * (b * h + k * h + h) + 4 * (1 + b * k)
        if name == "shared_z":
            return nbytes, {F32_FLOP_S: 4 * b * k * h}
        # bf16 add and relu on the CUDA cores; the projection's products of
        # bf16 values, summed in f32, on the tensor cores
        return nbytes, {BF16_VEC_FLOP_S: 2 * b * k * h,
                        BF16_FLOP_S: 2 * b * k * h}
    if name == "selfview":
        h_static, coord = args[0], args[1]
    else:
        coord, h_static = args[0], args[1]
    (b, k), h = coord.shape, h_static.shape[1]
    n_code = 1 + 2 * kwargs["n_freqs"]
    code, products, add_relu = 2 * n_code, 2 * n_code * h + 2 * h, 2 * h
    if name == "selfview":
        return (4 * (b * h + 2 * b * k + (n_code + 2) * h + 1),
                {F32_FLOP_S: b * k * (code + products + add_relu)})
    # the products on the tensor cores, the add and relu in bf16, the code
    # in f32
    return (2 * b * h + 8 * b * k + 2 * (n_code + 2) * h + 4,
            {BF16_FLOP_S: b * k * products, BF16_VEC_FLOP_S: b * k * add_relu,
             F32_FLOP_S: b * k * code})


def plain_version(kernel: str):
    """The plain PyTorch version of a kernel wrapper."""
    from behindthescenes_tpu_torch.ops.kernels.jitter_density import \
        jitter_density_plain
    from behindthescenes_tpu_torch.ops.kernels.selfview import \
        selfview_density_plain
    from behindthescenes_tpu_torch.ops.kernels.shared_z import \
        shared_z_tail_plain
    return {"shared_z": shared_z_tail_plain,
            "selfview": selfview_density_plain,
            "jitter_density": jitter_density_plain}[kernel]


def plain_reference(rec: str, kernel: str, args, kwargs):
    """The kernel's plain version on its arguments: jitter_density as it
    runs (bf16 rounding at the kernel's places), the others in float64."""
    import torch
    plain = plain_version(kernel)
    if rec == "jitter_density":
        return plain(*args, **kwargs)
    return plain(*(a.double() if torch.is_tensor(a)
                   and a.dtype == torch.float32 else a for a in args),
                 **kwargs)


def against_plain(rec: str, kernel: str, args, kwargs, label: str):
    """The kernel (through its wrapper) against its plain version on the
    same arguments, within TOLERANCE[rec]. Returns (max abs deviation,
    max |out|, the output's shape); raises on another shape, a value that
    is not finite or a deviation beyond the tolerance."""
    import torch
    from behindthescenes_tpu_torch.ops import kernels
    with torch.no_grad():
        got = kernels.KERNELS[kernel](*args, **kwargs)
        want = plain_reference(rec, kernel, args, kwargs).float()
    if got.is_cuda:
        torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{rec} ({label}): shape {tuple(got.shape)} "
                             f"vs {tuple(want.shape)} or not finite")
    atol, rtol = TOLERANCE[rec]
    dev_abs = (got - want).abs()
    max_dev = dev_abs.max().item()
    if (dev_abs - atol - rtol * want.abs()).max().item() > 0:
        raise AssertionError(f"{rec} ({label}): kernel and plain version "
                             f"disagree beyond tolerance (max abs "
                             f"{max_dev:.3e})")
    return max_dev, want.abs().max().item(), tuple(got.shape)


def kernel_record(name: str, rec: str, kernel: str, args, kwargs,
                  launches: int, max_abs_err: float, mode: str,
                  resources: dict) -> dict:
    """The kernel's line of the kernels record: its time and its plain
    version's on these arguments (CUDA events), and its bound from work()
    of the record `rec`; prints it."""
    from behindthescenes_tpu_torch.ops import kernels
    ms_kernel = cuda_ms(lambda: kernels.KERNELS[kernel](*args, **kwargs),
                        iters=20)
    ms_plain = cuda_ms(lambda: plain_version(kernel)(*args, **kwargs),
                       iters=5, warmup=1)
    nbytes, flops = work(rec, args, kwargs)
    flop = sum(flops.values())
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = sum(n / peak for peak, n in flops.items()) * 1e3
    bound = max(t_bytes, t_ops)
    source, replaces = KERNEL_META[rec]
    out = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches,
           "max_abs_err": max_abs_err, "ms": ms_kernel,
           "plain_ms": ms_plain, "bound_ms": bound,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None, "mode": mode,
           "share_of_bound": bound / ms_kernel,
           "registers": resources.get("registers"),
           "spill_bytes": resources.get("spill_stores", 0)
           + resources.get("spill_loads", 0)}
    print(f"[chip_smoke] {name} ({mode}): kernel {ms_kernel:.4f} ms, "
          f"{100 * bound / ms_kernel:.1f}% of its bound {bound:.4f} ms "
          f"({out['bound_by']}; {nbytes / 1e6:.1f} MB, {flop / 1e9:.2f} "
          f"GFLOP); plain {ms_plain:.4f} ms; {out['registers']} registers, "
          f"{out['spill_bytes']} spill bytes", flush=True)
    return out


def train_batch(conf: dict) -> dict:
    """The first batch_size items of the synthetic training set (numpy)."""
    from behindthescenes_tpu_torch.datasets.factory import make_datasets
    from behindthescenes_tpu_torch.datasets.synthetic import collate
    train_ds, _ = make_datasets(conf["data"])
    return collate([train_ds[i] for i in range(conf["batch_size"])])


def numpy_draws(conf: dict, batch: dict, seed: int):
    """A training step's random choices from numpy's generator: patch views
    among the loss views, patch corners, and the coarse jitter."""
    import numpy as np
    import torch
    from behindthescenes_tpu_torch.ray_sampler import PatchDraws
    from behindthescenes_tpu_torch.training.view_select import select_views
    from behindthescenes_tpu_torch.training.wrapper import Draws
    mc = conf["model_conf"]
    n, v, h, w, _ = batch["imgs"].shape
    ids = select_views(np.random.default_rng(conf["seed"]), v,
                       list(range(mc["n_frames_render"])),
                       mc["frame_sample_mode"], True)
    p, rays = mc["patch_size"], mc["ray_batch_size"]
    pc = rays // (p * p)
    rng = np.random.default_rng(seed)
    views = rng.integers(0, len(ids.ids_loss), (n, pc))
    ys = rng.integers(0, h - p, (n, pc))
    xs = rng.integers(0, w - p, (n, pc))
    jitter = rng.uniform(size=(n, rays, conf["renderer"]["n_coarse"]))
    return Draws(rays=PatchDraws(*(torch.as_tensor(a) for a in
                                   (views, ys, xs))),
                 z_jitter=torch.as_tensor(jitter, dtype=torch.float32))


def on_device(batch: dict, draws, dev, dtype=None):
    """The batch and the draws as tensors on `dev`, the floating ones in
    `dtype` where given."""
    import dataclasses
    import torch
    from behindthescenes_tpu_torch.ray_sampler import PatchDraws
    tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    jitter = draws.z_jitter.to(dev)
    if dtype is not None:
        tb = {k: v.to(dtype) if v.is_floating_point() else v
              for k, v in tb.items()}
        jitter = jitter.to(dtype)
    rays = PatchDraws(*(t.to(dev) for t in dataclasses.astuple(draws.rays)))
    return tb, dataclasses.replace(draws, rays=rays, z_jitter=jitter)


def make_trainer(conf: dict, weights: str, dev, dtype):
    """A trainer from `weights` on `dev` computing in `dtype` (bf16, f32,
    or f64 with the parameters in f64 too)."""
    import torch
    from behindthescenes_tpu_torch.training.trainer import BTSTrainer
    trainer = BTSTrainer(conf, device=dev, compute_dtype=dtype)
    trainer.init_state(weights)
    if dtype == torch.float64:
        trainer.net.double()
    return trainer


def train_parity(conf: dict, weights: str, batch: dict, draws,
                 dev) -> dict:
    """One f32 step from `weights` on `dev`, and the same step (batch,
    draws, views) on the host CPU in float64. Raises unless the loss
    agrees to LOSS_RTOL and every parameter's gradient norm above
    GRAD_NORM_FLOOR of the largest to GRAD_NORM_RTOL, or if the step on
    `dev` launched a decode kernel."""
    import torch
    from behindthescenes_tpu_torch.ops import kernels
    out = {}
    for d, dtype in ((dev, torch.float32), ("cpu", torch.float64)):
        trainer = make_trainer(conf, weights, d, dtype)
        tb, td = on_device(batch, draws, d, dtype)
        kernels.reset_launch_counts()
        loss = float(trainer.train_step(tb, td)["loss"])
        launched = kernels.launch_counts()
        if dtype == torch.float32 and any(launched.values()):
            raise AssertionError(f"the train step launched decode kernels: "
                                 f"{launched}")
        norms = {n: p.grad.double().norm().item()
                 for n, p in trainer.net.named_parameters()
                 if p.grad is not None}
        out[dtype] = (loss, norms, launched)
    (loss_d, norms_d, launched), (loss_h, norms_h, _) = \
        out[torch.float32], out[torch.float64]
    rel = abs(loss_d - loss_h) / abs(loss_h)
    if rel > LOSS_RTOL:
        raise AssertionError(f"loss {loss_d} on {dev} vs {loss_h} on "
                             f"the host: {rel:.2e} relative")
    if set(norms_d) != set(norms_h):
        raise AssertionError("gradients of different parameters")
    floor = GRAD_NORM_FLOOR * max(norms_h.values())
    devs = {n: abs(norms_d[n] - v) / v for n, v in norms_h.items()
            if v > floor}
    worst = max(devs, key=devs.get)
    if devs[worst] > GRAD_NORM_RTOL:
        raise AssertionError(f"gradient norm of {worst}: {norms_d[worst]} "
                             f"on {dev} vs {norms_h[worst]} on the host")
    return {"loss": loss_d, "loss_host": loss_h, "loss_rel": rel,
            "grad_norm_rel_max": devs[worst], "grad_norm_worst": worst,
            "tensors": len(devs), "launches": launched}


def cuda_clock():
    """A clock of CUDA events: clock() records one; clock.ms(a, b) reads
    the milliseconds between two after a synchronize."""
    import torch

    def clock():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    clock.ms = lambda a, b: a.elapsed_time(b)
    clock.sync = torch.cuda.synchronize
    return clock


def train_steps(conf: dict, weights: str, batch: dict, draws, dev,
                bf16: bool, clock, steps: int = TRAIN_STEPS,
                timed_from: int = TIMED_FROM) -> dict:
    """`steps` steps from `weights` on one batch with fixed draws and the
    same views each step. Raises unless every loss is finite and the last
    is below the first, or if a decode kernel was launched. Returns the
    losses and the median ms of the step and of each stage over steps
    timed_from..steps-1, by `clock`."""
    import math
    import statistics
    import numpy as np
    import torch
    from behindthescenes_tpu_torch.ops import kernels
    trainer = make_trainer(conf, weights, dev,
                           torch.bfloat16 if bf16 else torch.float32)
    tb, td = on_device(batch, draws, dev)
    kernels.reset_launch_counts()
    losses, marks = [], []
    for _ in range(steps):
        trainer.np_rng = np.random.default_rng(conf["seed"])
        events = [("start", clock())]
        terms = trainer.train_step(
            tb, td, mark=lambda name: events.append((name, clock())))
        losses.append(terms["loss"])
        marks.append(events)
    clock.sync()
    launched = kernels.launch_counts()
    if any(launched.values()):
        raise AssertionError(f"training launched decode kernels: {launched}")
    losses = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite or not falling: {losses}")
    split = {}
    for events in marks[timed_from:]:
        names = [n for n, _ in events]
        if names != ["start", *STAGES]:
            raise AssertionError(f"stages {names}")
        for (_, a), (name, b) in zip(events, events[1:]):
            split.setdefault(name, []).append(clock.ms(a, b))
        split.setdefault("step", []).append(clock.ms(events[0][1],
                                                     events[-1][1]))
    return {"losses": losses, "launches": launched,
            "median_ms": {k: statistics.median(v) for k, v in split.items()}}


def general_depth(net, batches, selfview_per_scene, generator) -> dict:
    """The gate scenes through the evaluator's general path (eval_selfview:
    false). Raises unless the mean metrics meet the gate and each scene's
    are within GENERAL_BOUNDS of its self-view metrics."""
    import numpy as np
    from behindthescenes_tpu_torch import eval_depth
    ev = eval_depth.DepthEvaluator(
        net, eval_depth.FLAGSHIP_RENDERER,
        dict(eval_depth.FLAGSHIP_MODEL_CONF, eval_selfview=False))
    if ev.use_selfview:
        raise AssertionError("eval_selfview: false took the self-view path")
    per_scene = [ev.evaluate(b, generator=generator) for b in batches]
    means = {k: float(np.mean([m[k] for m in per_scene]))
             for k in per_scene[0]}
    check_metrics("general path f32", means)
    for i, (gen, sv) in enumerate(zip(per_scene, selfview_per_scene)):
        for k, tol in GENERAL_BOUNDS:
            if not abs(gen[k] - sv[k]) < tol * max(1.0, gen[k]):
                raise AssertionError(f"scene {i} {k}: general {gen[k]:.4f} "
                                     f"vs self-view {sv[k]:.4f}")
    return {"means": means, "per_scene": per_scene}


@contextlib.contextmanager
def recorded_evaluations():
    """Records every call the task runner makes to an evaluator's
    `evaluate`: yields the list of (evaluator, batch, metrics)."""
    from behindthescenes_tpu_torch.evaluation.bbox_occ import \
        BBoxOccEvaluator
    from behindthescenes_tpu_torch.evaluation.depth import DepthEvaluator
    from behindthescenes_tpu_torch.evaluation.lidar_occ import \
        LidarOccEvaluator
    from behindthescenes_tpu_torch.evaluation.nvs import NVSEvaluator
    calls, saved = [], {}
    for cls in (DepthEvaluator, NVSEvaluator, LidarOccEvaluator,
                BBoxOccEvaluator):
        saved[cls] = cls.evaluate

        def recorder(self, batch, *args, _fn=cls.evaluate, **kwargs):
            out = _fn(self, batch, *args, **kwargs)
            calls.append((self, batch, out))
            return out
        cls.evaluate = recorder
    try:
        yield calls
    finally:
        for cls, fn in saved.items():
            cls.evaluate = fn


def config_eval(name: str, checkpoint: str, dev, overrides=()):
    """configs/NAME.yaml with the checkpoint and overrides through the
    port's task runner on `dev`. Returns (config, means, [(evaluator,
    batch, per-scene metrics)])."""
    from behindthescenes_tpu_torch.config import (find_config, load_config,
                                                  parse_cli_overrides)
    from behindthescenes_tpu_torch.evaluation.tasks import TASKS
    conf = load_config(find_config(name), parse_cli_overrides(
        [f"checkpoint={checkpoint}", *overrides]))
    with recorded_evaluations() as calls:
        means = TASKS[conf["model"]](conf, device=dev)
    return conf, means, calls


def nvs_frame_ms(evaluator, batch, clock, frames: int) -> dict:
    """Median ms of one NVS frame (every view of a batch rendered from
    frame 0's encoding) and of its encode and render stages, over `frames`
    frames after one untimed, by `clock`."""
    import statistics
    import torch
    dev = next(evaluator.net.parameters()).device
    args = [torch.as_tensor(batch[k], device=dev)
            for k in ("imgs", "projs", "poses")]
    split = {}
    for i in range(frames + 1):
        gen = torch.Generator(device=dev)
        gen.manual_seed(i)
        events = [("start", clock())]
        rgb = evaluator.render(*args, generator=gen,
                               mark=lambda name: events.append((name,
                                                                clock())))
        clock.sync()
        if not torch.isfinite(rgb).all():
            raise AssertionError("an NVS frame is not finite")
        if i == 0:
            continue
        for (_, a), (name, b) in zip(events, events[1:]):
            split.setdefault(name, []).append(clock.ms(a, b))
        split.setdefault("frame", []).append(clock.ms(events[0][1],
                                                      events[-1][1]))
    return {k: statistics.median(v) for k, v in split.items()}


def config_phase(name: str, checkpoint: str, jax_means: dict, dev, clock,
                 overrides=(), frames: int = NVS_TIMED_FRAMES) -> dict:
    """One config through the task runner, with the decode kernels'
    launches counted from 0 and the peak memory. Raises unless every mean
    is finite and within JAX_GAP of jax_means, and the NVS means meet
    NVS_FLOORS. NVS configs also get their frame time split."""
    import math
    import torch
    from behindthescenes_tpu_torch.ops import kernels
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    conf, means, calls = config_eval(name, checkpoint, dev, overrides)
    launched = kernels.launch_counts()
    res = {"config": name, "checkpoint": checkpoint, "means": means,
           "jax_means": jax_means,
           "per_scene": [out for _, _, out in calls], "launches": launched,
           "peak_memory": torch.cuda.max_memory_allocated() if cuda
           else None}
    if not calls or not all(math.isfinite(v) for v in means.values()):
        raise AssertionError(f"{name}: {len(calls)} scenes, means {means}")
    for k, want in jax_means.items():
        res[f"gap_{k}"] = means[k] - want
        if not abs(means[k] - want) <= JAX_GAP[k]:
            raise AssertionError(f"{name}: {k} {means[k]:.6f} vs JAX "
                                 f"{want:.6f} (bound {JAX_GAP[k]})")
    for k, floor in NVS_FLOORS.get(name, {}).items():
        if not means[k] > floor:
            raise AssertionError(f"{name}: {k} {means[k]:.4f} under the "
                                 f"JAX gate's {floor}")
    if conf["model"] == "bts_nvs":
        res["frame_ms"] = nvs_frame_ms(calls[-1][0], calls[-1][1], clock,
                                       frames)
    return res


def fine_value(dev, overrides=THIN_OVERRIDES) -> dict:
    """Phase 13: the thin-structure checkpoint's NVS PSNR under each of
    FINE_PROFILES. Raises unless 8 + 8 with reuse beats 16 flat by more
    than FINE_MARGIN_MIN, and reuse equals re-query at 16 + 16 within
    REUSE_GAP_MAX."""
    psnr = {}
    for label, profile in FINE_PROFILES.items():
        _, means, _ = config_eval(THIN_CONFIG, THIN_WEIGHTS, dev,
                                  (*overrides, *profile))
        psnr[label] = means["psnr"]
    margin = psnr["8+8 reuse"] - psnr["16 flat"]
    gap = abs(psnr["16+16 reuse"] - psnr["16+16 re-query"])
    if not margin > FINE_MARGIN_MIN:
        raise AssertionError(f"8 + 8 fine beats 16 flat by {margin:.4f} dB "
                             f"(min {FINE_MARGIN_MIN}): {psnr}")
    if not gap < REUSE_GAP_MAX:
        raise AssertionError(f"reuse and re-query differ by {gap:.4f} dB: "
                             f"{psnr}")
    return {"psnr": psnr, "margin": margin, "reuse_gap": gap}


def config_phases(dev, card: str, clock_fn, overrides=(),
                  thin_overrides=THIN_OVERRIDES,
                  frames: int = NVS_TIMED_FRAMES):
    """Phases 10-13 on `dev`, printing each phase's results: every config
    of CONFIG_RUNS (with `overrides`) through `config_phase`, the NVS
    configs with no decode kernel launched, eval_synthetic_flagship with
    the shared_z kernel launched; then `fine_value`. Returns (the config
    records, the fine-pass record)."""
    configs = []
    for phase, name, checkpoint, jax_means in CONFIG_RUNS:
        t = time.perf_counter()
        res = config_phase(name, checkpoint, jax_means, dev, clock_fn(),
                           overrides, frames)
        configs.append(res)
        launched = res["launches"]
        if phase in ("10", "11") and any(launched.values()):
            raise AssertionError(f"{name} launched decode kernels: "
                                 f"{launched}")
        if name == "eval_synthetic_flagship" and \
                launched["shared_z"] <= 0:
            raise AssertionError(f"{name}: the shared_z kernel never ran")
        keys = list(jax_means)
        peak = res["peak_memory"]
        print(f"[chip_smoke] {name} ({card}): "
              + ", ".join(f"{k} {res['means'][k]:.6f} (JAX on the CPU "
                          f"{jax_means[k]:.6f}, gap {res['gap_' + k]:+.6f},"
                          f" bound {JAX_GAP[k]})" for k in keys)
              + "; per scene "
              + json.dumps([[round(m[k], 6) for k in keys]
                            for m in res["per_scene"]])
              + f"; decode kernel launches {json.dumps(launched)}; peak "
              "memory " + ("not measured" if peak is None
                           else f"{peak / 2**30:.2f} GiB"), flush=True)
        if "frame_ms" in res:
            fm = res["frame_ms"]
            print(f"[chip_smoke] {name} NVS frame ({card}): median "
                  f"{fm['frame']:.3f} ms over {frames} frames, encode "
                  f"{fm['encode']:.3f} ms, render {fm['render']:.3f} ms",
                  flush=True)
        log(f"phase {phase} {name}", "within the bounds of JAX's means", t)

    t = time.perf_counter()
    fine = fine_value(dev, thin_overrides)
    print("[chip_smoke] thin-structure NVS PSNR: "
          + json.dumps({k: round(v, 6) for k, v in fine["psnr"].items()})
          + f"; 8 + 8 fine beats 16 flat by {fine['margin']:.4f} dB (min "
          f"{FINE_MARGIN_MIN}); reuse vs re-query {fine['reuse_gap']:.2e} dB"
          f" (max {REUSE_GAP_MAX})", flush=True)
    log("phase 13 fine pass", "beats flat; reuse equals re-query", t)
    return configs, fine


def write_occupancy_splits(tree: str, frames: int) -> None:
    """The split directories of OCC_RUNS beside make_gate_tree's `splits`,
    in a tree of `frames` frames."""
    from behindthescenes_tpu_torch.datasets import \
        gen_synthetic_kitti_360 as gen
    for _, _, split, keyframes, _, _ in OCC_RUNS:
        if split != "splits":
            gen.write_splits(tree, gen.GATE_SEQ, list(keyframes), frames,
                             split)


def occupancy_stage_ms(calls, clock) -> list:
    """Each recorded item evaluated once more with the generator of the
    task run (seed = its place), its stages marked by `clock`: per item
    the ms of OCC_STAGES and of the whole item."""
    import torch
    out = []
    for i, (ev, batch, _) in enumerate(calls):
        gen = torch.Generator(device=next(ev.net.parameters()).device)
        gen.manual_seed(i)
        events = [("start", clock())]
        ev.evaluate(batch, generator=gen,
                    mark=lambda name: events.append((name, clock())))
        clock.sync()
        names = [n for n, _ in events]
        if names != ["start", *OCC_STAGES]:
            raise AssertionError(f"stages {names}")
        split = {name: clock.ms(a, b)
                 for (_, a), (name, b) in zip(events, events[1:])}
        split["item"] = clock.ms(events[0][1], events[-1][1])
        out.append(split)
    return out


def occupancy_phase(tree: str, name: str, split: str, keyframes,
                    overrides, record: str, dev, clock, extra=()):
    """One run of OCC_RUNS: configs/NAME with K360_WEIGHTS on the tree's
    split through the task runner, then each item again with its stages
    timed. Raises unless the record's kernel was launched once per
    keyframe, each time on OCC_RAYS[record] rays and within tolerance of
    its plain version, and no other kernel was; unless every mean is
    finite; and unless the means meet OCC_FLOORS and lie within OCC_GAP
    of OCC_JAX_MEANS, where the record has them. Returns (the record of
    the run, the (kernel, args, kwargs) of its first launch)."""
    import math
    import torch
    from behindthescenes_tpu_torch.ops import kernels
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with recorded_kernel_args() as (_, state):
        state["mode"], state["calls"] = record, []
        _, means, calls = config_eval(name, K360_WEIGHTS, dev, (
            f"data.data_path={tree}",
            f"data.pose_path={os.path.join(tree, 'data_poses')}",
            f"data.split_path={os.path.join(tree, split)}",
            "data.is_preprocessed=true", *overrides, *extra))
    launched = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() if cuda else None
    kernel, n = OCC_RECORDS[record], len(keyframes)
    want = {k: n if k == kernel else 0 for k in launched}
    if launched != want:
        raise AssertionError(f"{name} ({record}): kernel launches "
                             f"{launched}, want {want}")
    launch_calls = state["calls"]
    rays = [(args[1] if kernel == "selfview" else args[0]).shape[0]
            for _, args, _ in launch_calls]
    if [k for k, _, _ in launch_calls] != [kernel] * n or \
            rays != [OCC_RAYS[record]] * n:
        raise AssertionError(f"{name} ({record}): calls of "
                             f"{[k for k, _, _ in launch_calls]} on {rays} "
                             f"rays, want {n} of {kernel} on "
                             f"{OCC_RAYS[record]}")
    errs = [against_plain(kernel, kernel, args, kwargs,
                          f"{record} launch {i}")[0]
            for i, (_, args, kwargs) in enumerate(launch_calls)]
    if len(calls) != n or not all(math.isfinite(means[k])
                                  for k in OCC_METRICS):
        raise AssertionError(f"{name} ({record}): {len(calls)} items, "
                             f"means {means}")
    res = {"config": name, "record": record, "split": split,
           "keyframes": list(keyframes), "overrides": list(overrides),
           "means": means, "per_item": [out for _, _, out in calls],
           "launches": launched, "launch_rays": rays,
           "max_abs_err": errs, "peak_memory": peak}
    for k, want_k in OCC_JAX_MEANS.get(record, {}).items():
        res[f"gap_{k}"] = means[k] - want_k
        if not abs(means[k] - want_k) <= OCC_GAP[k]:
            raise AssertionError(f"{name}: {k} {means[k]:.6f} vs JAX "
                                 f"{want_k:.6f} (bound {OCC_GAP[k]})")
    for k, floor in OCC_FLOORS.get(record, {}).items():
        if not means[k] > floor:
            raise AssertionError(f"{name}: {k} {means[k]:.4f} under the "
                                 f"JAX gate's {floor}")
    res["stage_ms"] = occupancy_stage_ms(calls, clock)
    return res, launch_calls[0]


def occupancy_phases(tree: str, dev, card: str, clock_fn, extra=()):
    """Phases 14-15: every run of OCC_RUNS on `tree` (with the split
    directories of write_occupancy_splits), with the `extra` overrides,
    printing each run's means against JAX's and the gates, its launches
    and peak memory, and each item's stages. Returns [(record, first
    launch)]."""
    out = []
    for phase, name, split, keyframes, overrides, record in OCC_RUNS:
        t = time.perf_counter()
        res, launch = occupancy_phase(tree, name, split, keyframes,
                                      overrides, record, dev, clock_fn(),
                                      extra)
        out.append((res, launch))
        jax_means = OCC_JAX_MEANS.get(record, {})
        peak = res["peak_memory"]
        print(f"[chip_smoke] {' '.join((name, *overrides))} ({record}, "
              f"{card}): "
              + ", ".join(f"{k} {res['means'][k]:.6f}"
                          + (f" (JAX on the CPU {jax_means[k]:.6f}, gap "
                             f"{res['gap_' + k]:+.6f}, bound {OCC_GAP[k]})"
                             if k in jax_means else "")
                          for k in OCC_METRICS)
              + "; per keyframe "
              + json.dumps([[round(m[k], 6) for k in OCC_METRICS]
                            for m in res["per_item"]])
              + f"; launches {json.dumps(res['launches'])} on "
              f"{res['launch_rays']} rays, max abs deviation from the "
              f"plain version {max(res['max_abs_err']):.3e}; peak memory "
              + ("not measured" if peak is None
                 else f"{peak / 2**30:.2f} GiB"), flush=True)
        for kf, st in zip(keyframes, res["stage_ms"]):
            print(f"[chip_smoke] {name} ({record}) keyframe {kf} ({card}): "
                  + ", ".join(f"{k} {st[k]:.3f} ms" for k in OCC_STAGES)
                  + f"; item {st['item']:.3f} ms", flush=True)
        host = sum(st["ground_truth"] for st in res["stage_ms"])
        total = sum(st["item"] for st in res["stage_ms"])
        log(f"phase {phase} {name} ({record})",
            f"within the gates and JAX's means; host ground truth "
            f"{100 * host / total:.1f}% of the items' time", t)
    return out


def torchvision_resnet_state_dict(npz: str, layers: int = 50) -> dict:
    """A torchvision-keyed ResNet state dict (conv1.weight, bn1.*,
    layerN.M.*, downsample.*, fc.*) of the encoder in a Flax-keyed `.npz`,
    as torchvision's `resnet{layers}-*.pth` files hold it; fc is zero."""
    import torch
    from behindthescenes_tpu_torch.weights import (load_params_npz,
                                                   state_dict_from_flat)
    prefix = "encoder.encoder.encoder."
    sd = {k[len(prefix):]: v for k, v in
          state_dict_from_flat(load_params_npz(npz)).items()
          if k.startswith(prefix)}
    width = 2048 if layers >= 50 else 512
    sd["fc.weight"] = torch.zeros(1000, width)
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def k360_run_overrides(tree: str, pth: str, out: str, stop: int,
                       extra=()) -> list:
    """The command line's overrides of phase 16's runs."""
    return [f"data.data_path={tree}",
            f"data.pose_path={os.path.join(tree, 'data_poses')}",
            f"data.split_path={os.path.join(tree, 'splits')}",
            f"model_conf.encoder.cp_location={pth}",
            "model_conf.encoder.pretrained_strict=true",
            f"stop_iteration={stop}",
            f"checkpoint_every={K360_RUN['checkpoint_every']}",
            f"validate_every={K360_RUN['validate_every']}",
            f"output_path={out}", *extra]


def expected_run_steps(stops, every: int, keep: int = 3) -> tuple:
    """The step directories the JAX harness's rules leave in checkpoints/
    after each run: a save every `every` micro-steps and at each stop
    (not twice), the newest `keep` kept."""
    saved, out = [], []
    for stop in stops:
        start = saved[-1] if saved else 0
        saved += [s for s in range(start + 1, stop + 1) if s % every == 0]
        if saved[-1] != stop:
            saved.append(stop)
        out.append(sorted(saved)[-keep:])
    return tuple(out)


def _flat_state(state, prefix=""):
    """A trainer state dict flattened to {path: tensor or number}."""
    out = {}
    if isinstance(state, dict):
        for k, v in state.items():
            out.update(_flat_state(v, f"{prefix}{k}/"))
    elif isinstance(state, (list, tuple)):
        for i, v in enumerate(state):
            out.update(_flat_state(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = state.detach().cpu().clone() \
            if hasattr(state, "detach") else state
    return out


def _states_equal(a: dict, b: dict) -> list:
    """The paths where two flattened states differ, bit for bit."""
    import torch
    bad = sorted(set(a) ^ set(b))
    for k in set(a) & set(b):
        x, y = a[k], b[k]
        if isinstance(x, torch.Tensor) != isinstance(y, torch.Tensor):
            bad.append(k)
        elif isinstance(x, torch.Tensor):
            if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(
                    x.reshape(-1).view(torch.uint8),
                    y.reshape(-1).view(torch.uint8)):
                bad.append(k)
        elif x != y:
            bad.append(k)
    return bad


def k360_training_phase(tree: str, dev, card: str, clock_fn,
                        extra=()) -> dict:
    """Phase 16 on `tree` (a make_gate_tree drive), with the `extra`
    overrides. Raises unless the encoder loaded from the `.pth` equals
    K360_WEIGHTS' bit for bit; parameters stay put on the micro-steps that
    emit no update and move on those that do; every loss is finite; the
    first run leaves the checkpoint and best directories of the JAX
    harness's rules; the state restored from its last checkpoint equals
    the state it saved there bit for bit (the half-filled accumulator and
    its counter included); the second run resumes at the next micro-step,
    leaves the newest checkpoints and carries the best value over; no
    decode kernel was launched; and run_validation of K360_WEIGHTS lies
    within K360_VAL_GAP of K360_VAL_JAX. Returns the phase's record."""
    import copy
    import math
    import re
    import statistics
    import numpy as np
    import torch
    from behindthescenes_tpu_torch.config import (find_config, load_config,
                                                  parse_cli_overrides)
    from behindthescenes_tpu_torch.datasets.preprocess_kitti_360 import \
        preprocess
    from behindthescenes_tpu_torch.ops import kernels
    from behindthescenes_tpu_torch.training import harness, tasks
    from behindthescenes_tpu_torch.training.trainer import BTSTrainer
    from behindthescenes_tpu_torch.weights import (flat_from_state_dict,
                                                   load_params_npz)
    cuda = torch.device(dev).type == "cuda"
    stops = K360_RUN["stops"]
    res = {"config": K360_TRAIN_CONFIG, "overrides": list(extra),
           "stops": list(stops)}

    def conf_for(stop, pth, out):
        return load_config(find_config(K360_TRAIN_CONFIG),
                           parse_cli_overrides(k360_run_overrides(
                               tree, pth, out, stop, extra)))

    with tempfile.TemporaryDirectory(prefix="k360_run_") as tmp:
        t = time.perf_counter()
        conf = conf_for(stops[0], os.path.join(tmp, "resnet50.pth"),
                        os.path.join(tmp, "run"))
        data = conf["data"]
        preprocess(tree, data["image_size"],
                   fisheye_rotation=data["fisheye_rotation"],
                   only_fisheye=True)
        res["fisheye_preprocess_s"] = time.perf_counter() - t
        pth = conf["model_conf"]["encoder"]["cp_location"]
        out = conf["output_path"]
        torch.save(torchvision_resnet_state_dict(
            K360_WEIGHTS, conf["model_conf"]["encoder"]["resnet_layers"]),
            pth)

        # The encoder the run starts from, against the npz's.
        probe = BTSTrainer(conf, device=dev)
        probe.init_state()
        got = flat_from_state_dict(probe.net.state_dict(),
                                   probe.net.encoder.scales)
        want = {k: v for k, v in load_params_npz(K360_WEIGHTS).items()
                if k.split("/", 1)[1].startswith("encoder/encoder/")}
        differ = [k for k in want if not np.array_equal(got[k], want[k])]
        if len(want) < 100 or differ:
            raise AssertionError(f"pretrained encoder: {len(differ)} of "
                                 f"{len(want)} tensors differ from "
                                 f"{K360_WEIGHTS}: {differ[:3]}")
        res["encoder_tensors_equal"] = len(want)
        del probe

        # The first run, in this process.
        kernels.reset_launch_counts()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        clock = clock_fn()
        points = []

        def mark(name):
            points.append((name, time.perf_counter(), clock()))
        steps, losses, iteration_ends = [], [], []
        prev = {}

        def on_iteration(it, trainer, loss_dict):
            params = torch.cat([p.detach().reshape(-1)
                                for p in trainer.net.parameters()])
            if "params" in prev:
                steps.append((it, torch.equal(params, prev["params"])))
            prev["params"] = params
            losses.append(float(loss_dict["loss"]))
            iteration_ends.append((time.perf_counter(), clock()))

        t = time.perf_counter()
        trainer = tasks.bts_training(conf, device=dev, mark=mark,
                                     on_iteration=on_iteration)
        if cuda:
            torch.cuda.synchronize()
        res["first_run_s"] = time.perf_counter() - t
        res["launches"] = kernels.launch_counts()
        res["peak_memory"] = torch.cuda.max_memory_allocated() if cuda \
            else None
        if any(res["launches"].values()):
            raise AssertionError(f"training launched decode kernels: "
                                 f"{res['launches']}")
        if len(losses) != stops[0] or trainer.step != stops[0] or \
                not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"first run: {trainer.step} micro-steps, "
                                 f"losses {losses}")
        k = conf["accumulate_steps"]
        moved = {it: not same for it, same in steps}
        want_moved = {it: it % k == 0 for it in moved}
        if moved != want_moved:
            raise AssertionError(f"parameters moved at {moved}, want "
                                 f"{want_moved}")
        res["losses"] = losses

        ckpt_dir = os.path.join(out, "checkpoints")
        best_dir = os.path.join(out, "best")
        want_steps = expected_run_steps(stops, K360_RUN["checkpoint_every"])

        def listing(d):
            return sorted(int(x) for x in os.listdir(d) if x.isdigit())
        best_first = [s for s in range(1, stops[0] + 1)
                      if s % K360_RUN["validate_every"] == 0]
        with open(os.path.join(best_dir, "best_value.json")) as f:
            best_value = json.load(f)
        res["best_value_first"] = best_value
        best_saved = listing(best_dir)
        if listing(ckpt_dir) != want_steps[0] or \
                best_value["metric"] != "abs_rel" or \
                not best_saved or best_saved[-1] != best_value["step"] or \
                not set(best_saved) <= set(best_first) or \
                len(best_saved) > 2:
            raise AssertionError(f"first run: checkpoints "
                                 f"{listing(ckpt_dir)} (want "
                                 f"{want_steps[0]}), best "
                                 f"{listing(best_dir)}, {best_value}")

        # The saved state at the stop against the state in memory.
        live = _flat_state(trainer.state_dict())
        del trainer
        if cuda:
            torch.cuda.empty_cache()
        fresh = BTSTrainer(conf, device=dev)
        fresh.init_state()
        t0, c0 = time.perf_counter(), clock()
        step, _ = harness.CheckpointManager(ckpt_dir).restore(fresh)
        c1 = clock()
        clock.sync()
        res["restore_ms"] = clock.ms(c0, c1)
        res["restore_host_ms"] = (time.perf_counter() - t0) * 1e3
        bad = _states_equal(live, _flat_state(fresh.state_dict()))
        if step != stops[0] or bad or fresh.mini_step != stops[0] % k or \
                not any(bool(a.abs().max() > 0)
                        for a in fresh.acc_grads.values()):
            raise AssertionError(f"restored step {step}, mini_step "
                                 f"{fresh.mini_step}; differs at {bad[:5]}")
        res["restored_mini_step"] = fresh.mini_step
        del fresh

        # The second run: a new process on the same output_path.
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "behindthescenes_tpu_torch.train", "-cn",
             K360_TRAIN_CONFIG, *k360_run_overrides(
                 tree, pth, out, stops[1], (*extra, "log_every_iters=1")),
             *(["--device", str(dev)] if not cuda else [])],
            capture_output=True, text=True, timeout=900)
        res["second_run_s"] = time.perf_counter() - t
        if proc.returncode != 0:
            raise AssertionError(f"second run exited {proc.returncode}: "
                                 f"{proc.stderr[-3000:]}")
        its = [int(m.group(1)) for m in
               re.finditer(r" it (\d+) loss (\S+)", proc.stderr)]
        second_losses = [float(m.group(2)) for m in
                         re.finditer(r" it (\d+) loss (\S+)", proc.stderr)]
        with open(os.path.join(best_dir, "best_value.json")) as f:
            best_second = json.load(f)
        # A new best of the second run joins the first run's; two kept.
        want_best = sorted(set(best_saved) | {best_second["step"]})[-2:]
        carried = f"resuming best abs_rel tracker at signed value " \
            f"{best_value['signed_value']:.5f}" in proc.stderr
        if its != list(range(stops[0] + 1, stops[1] + 1)) or \
                not all(math.isfinite(x) for x in second_losses) or \
                listing(ckpt_dir) != want_steps[1] or not carried or \
                listing(best_dir) != want_best:
            raise AssertionError(f"second run: micro-steps {its}, losses "
                                 f"{second_losses}, checkpoints "
                                 f"{listing(ckpt_dir)} (want "
                                 f"{want_steps[1]}), best "
                                 f"{listing(best_dir)} (want {want_best}),"
                                 f" best value carried {carried}")
        res.update(second_losses=second_losses, best_value=best_second,
                   checkpoints=listing(ckpt_dir), best=listing(best_dir))

    # Validation of the committed checkpoint against JAX's means.
    val_trainer = BTSTrainer(conf, device=dev)
    val_trainer.init_state(K360_WEIGHTS)
    _, val_loader, _ = tasks.bts_get_dataflow(conf)
    t0, c0 = time.perf_counter(), clock()
    means = harness.run_validation(val_trainer, val_loader)
    c1 = clock()
    clock.sync()
    n_items = len(val_loader)
    res["validation_ms_per_item"] = clock.ms(c0, c1) / n_items
    res["validation_host_ms_per_item"] = \
        (time.perf_counter() - t0) * 1e3 / n_items
    res["validation"] = means
    for key, bound in K360_VAL_GAP.items():
        res[f"gap_{key}"] = means[key] - K360_VAL_JAX[key]
        if not abs(res[f"gap_{key}"]) <= bound:
            raise AssertionError(f"run_validation {key} {means[key]:.6f} vs "
                                 f"JAX {K360_VAL_JAX[key]:.6f} (bound "
                                 f"{bound})")

    # The loader's work alone: items made one after another on this
    # thread; then micro-steps on one of its batches, cached on the card,
    # with no loader thread running beside them.
    from behindthescenes_tpu_torch.datasets.synthetic import collate
    train_ds = tasks.bts_get_dataflow(conf)[0].dataset
    n = conf["batch_size"]
    t0 = time.perf_counter()
    items = [train_ds[i] for i in range(2 * n)]
    res["loader_item_host_ms"] = (time.perf_counter() - t0) * 1e3 / (2 * n)
    plain_ds = copy.copy(train_ds)
    plain_ds.color_aug = False
    t0 = time.perf_counter()
    for i in range(2 * n):
        plain_ds[i]
    res["loader_item_no_jitter_host_ms"] = \
        (time.perf_counter() - t0) * 1e3 / (2 * n)
    batch = {key: torch.as_tensor(v).to(dev)
             for key, v in collate(items[:n]).items()}
    cached = []
    for _ in range(K360_CACHED_STEPS):
        events = [("data", time.perf_counter(), clock())]
        val_trainer.train_step(batch, mark=lambda name: events.append(
            (name, time.perf_counter(), clock())))
        cached.append(events)
    clock.sync()
    split = {}
    for events in cached[2:]:
        for (_, _, a), (name, _, b) in zip(events, events[1:]):
            split.setdefault(name, []).append(clock.ms(a, b))
        split.setdefault("micro_step", []).append(
            clock.ms(events[0][2], events[-1][2]))
    res["cached_median_ms"] = {key: statistics.median(v)
                               for key, v in split.items()}

    # Where a micro-step's time goes.
    res.update(run_split(points, iteration_ends, clock, k,
                         K360_RUN["timed_from"]))
    return res


def run_split(points, iteration_ends, clock, accumulate: int,
              timed_from: int) -> dict:
    """The first run's marks in order (name, host time, clock event): per
    micro-step after `timed_from`, the card's ms of each train-step stage
    (between consecutive points), the host's wait for the loader, and the
    whole micro-step on the host's clock; the optimizer stage apart on
    the micro-steps that apply an update; each checkpoint save's ms, from
    the end of its micro-step's on_iteration (`iteration_ends`)."""
    import statistics
    steps, cur, saves = [], None, []
    for name, host, ev in points:
        if name == "wait" and cur is not None and len(cur["events"]) == 1:
            continue  # an epoch ended: the wait goes on in the next one
        if name == "wait":
            if cur is not None:
                cur["host_ms"] = (host - cur["t0"]) * 1e3
                steps.append(cur)
            cur = {"t0": host, "events": [(name, host, ev)]}
        elif cur is not None:
            cur["events"].append((name, host, ev))
        if name == "checkpoint":
            h0, e0 = [e for e in iteration_ends if e[0] <= host][-1]
            saves.append((h0, host, e0, ev))
    out = {"stage_ms": {}, "update_ms": [], "no_update_ms": [],
           "loader_wait_ms": [], "micro_step_host_ms": [],
           "micro_step_ms": []}
    for n, st in enumerate(steps, start=1):
        names = [e[0] for e in st["events"]]
        if names[:len(RUN_POINTS)] != list(RUN_POINTS):
            raise AssertionError(f"micro-step {n}: points {names}")
        ev = {e[0]: e for e in st["events"]}
        out["loader_wait_ms"].append((ev["data"][1] - ev["wait"][1]) * 1e3)
        if n <= timed_from:
            continue
        for a, b in zip(RUN_POINTS[1:], RUN_POINTS[2:]):
            out["stage_ms"].setdefault(b, []).append(
                clock.ms(ev[a][2], ev[b][2]))
        out["micro_step_ms"].append(clock.ms(ev["data"][2],
                                             ev["optimizer"][2]))
        out["micro_step_host_ms"].append(st["host_ms"])
        opt = clock.ms(ev["backward"][2], ev["optimizer"][2])
        (out["update_ms"] if n % accumulate == 0
         else out["no_update_ms"]).append(opt)
    out["median_stage_ms"] = {k: statistics.median(v)
                              for k, v in out.pop("stage_ms").items()}
    out["checkpoint_save_ms"] = [clock.ms(a, b) for _, _, a, b in saves]
    out["checkpoint_save_host_ms"] = [(h1 - h0) * 1e3
                                      for h0, h1, _, _ in saves]
    return out


def print_k360_run(res: dict, card: str) -> None:
    """Phase 16's lines: the micro-step split, loader wait, update,
    checkpoint and validation times, peak memory, and the checks."""
    import statistics

    def med(xs):
        return statistics.median(xs) if xs else float("nan")
    peak = res["peak_memory"]
    stages = res["median_stage_ms"]
    print(f"[chip_smoke] exp_kitti_360 micro-step ({card}), median over "
          f"micro-steps {K360_RUN['timed_from'] + 1}-{res['stops'][0] - 1}:"
          f" card {med(res['micro_step_ms']):.2f} ms ("
          + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
          + f" ms), host {med(res['micro_step_host_ms']):.2f} ms, of which "
          f"loader wait {med(res['loader_wait_ms'][K360_RUN['timed_from']:]):.2f}"
          f" ms (first micro-step {res['loader_wait_ms'][0]:.2f}); optimizer"
          f" stage {med(res['update_ms']):.2f} ms with the update, "
          f"{med(res['no_update_ms']):.2f} ms without; peak memory "
          + ("not measured" if peak is None else f"{peak / 2**30:.2f} GiB"),
          flush=True)
    cached = res["cached_median_ms"]
    print(f"[chip_smoke] exp_kitti_360 micro-step on one cached batch, no "
          f"loader thread ({card}), median of {K360_CACHED_STEPS - 2}: "
          f"{cached['micro_step']:.2f} ms ("
          + ", ".join(f"{k} {v:.2f}" for k, v in cached.items()
                      if k != "micro_step")
          + f" ms); the loader's item alone {res['loader_item_host_ms']:.1f}"
          f" ms on one host thread (8 PNG reads and 8 colour jitters), "
          f"{res['loader_item_no_jitter_host_ms']:.1f} ms without the "
          f"jitter", flush=True)
    print(f"[chip_smoke] exp_kitti_360 run ({card}): checkpoint save "
          + ", ".join(f"{x:.1f}" for x in res["checkpoint_save_host_ms"])
          + f" ms (host), restore {res['restore_host_ms']:.1f} ms (host), "
          f"validation {res['validation_ms_per_item']:.1f} ms per item "
          f"(card), {res['validation_host_ms_per_item']:.1f} (host); "
          f"fisheye frames preprocessed in {res['fisheye_preprocess_s']:.1f}"
          f" s; first run {res['first_run_s']:.1f} s, second (a new "
          f"process) {res['second_run_s']:.1f} s", flush=True)
    print(f"[chip_smoke] exp_kitti_360 run: encoder from the .pth equal to "
          f"{K360_WEIGHTS} in {res['encoder_tensors_equal']} tensors; "
          f"losses {res['losses'][0]:.5f} ... {res['losses'][-1]:.5f}, then "
          f"{res['second_losses'][0]:.5f} ... {res['second_losses'][-1]:.5f}"
          f"; restored mini_step {res['restored_mini_step']}, state "
          f"bit-equal; checkpoints {res['checkpoints']}, best {res['best']}"
          f" ({json.dumps(res['best_value'])}); decode kernel launches "
          f"{json.dumps(res['launches'])}; run_validation of {K360_WEIGHTS}"
          f" abs_rel {res['validation']['abs_rel']:.6f} (JAX on the CPU "
          f"{K360_VAL_JAX['abs_rel']:.6f}, gap {res['gap_abs_rel']:+.6f}, "
          f"bound {K360_VAL_GAP['abs_rel']}), a1 "
          f"{res['validation']['a1']:.6f} (JAX {K360_VAL_JAX['a1']:.6f}, "
          f"gap {res['gap_a1']:+.6f}, bound {K360_VAL_GAP['a1']})",
          flush=True)


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
    ptxas = _build.ptxas_report()
    resources = {}
    for rec, piece in PTXAS_NAME.items():
        found = [v for k, v in ptxas.items() if piece in k]
        if len(found) != 1:
            raise AssertionError(f"ptxas report: {len(found)} kernels match "
                                 f"{piece}")
        resources[rec] = found[0]
    for name, res in sorted(ptxas.items()):
        print(f"[chip_smoke] ptxas {name}: {json.dumps(res)}", flush=True)
    for rec, res in resources.items():
        if res.get("spill_stores", 0) + res.get("spill_loads", 0):
            raise AssertionError(f"{rec}: ptxas spills registers: {res}")
    log("phase 1 build", f"one nvcc call over {len(_build.sources())} "
        f"sources into {_build.BUILD_DIR}", t)

    # -- 2: weights -------------------------------------------------------
    t = time.perf_counter()
    nets = {False: eval_depth.load_model(WEIGHTS, device=dev),
            True: eval_depth.load_model(WEIGHTS, bf16=True, device=dev)}
    log("phase 2 weights", f"{WEIGHTS} f32 and bf16 on {dev}", t)
    t = time.perf_counter()
    batches = eval_depth.scenes(N_SCENES)
    log("phase 2 scenes", f"{N_SCENES} synthetic scenes at "
        f"{eval_depth.IMAGE_SIZE} ray-cast on the host", t)

    # -- 3, 4: serving (the main path) ------------------------------------
    # Each kernel keeps the arguments of its last launch in each mode (one
    # frame's flagship activations) for phases 5 and 6.
    kernels.reset_launch_counts()
    serving, mode_launches, serving_scenes = {}, {}, {}
    with recorded_kernel_args() as (recorded, state):
        for mode, bf16, jitter, kernel, _ in MODES:
            t = time.perf_counter()
            state["mode"] = mode
            before = kernels.launch_counts()[kernel]
            means, serving_scenes[mode] = eval_depth.evaluate(
                nets[bf16], batches, jitter=jitter)
            torch.cuda.synchronize()
            check_metrics(mode, means)
            mode_launches[mode] = kernels.launch_counts()[kernel] - before
            if mode_launches[mode] <= 0:
                raise AssertionError(f"{mode}: the {kernel} kernel never "
                                     "ran")
            serving[mode] = means
            log(f"phase {4 if jitter else 3} {mode}",
                f"{kernel} launches {mode_launches[mode]}", t)
    launches = kernels.launch_counts()
    print(f"[chip_smoke] main-path launches {json.dumps(launches)}",
          flush=True)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")

    # -- 5: each kernel against its plain version -------------------------
    t = time.perf_counter()
    # (label, record, kernel, args, kwargs): each mode's own arguments,
    # then every kernel on ragged cuts of them, at each H it is built for,
    # and shared_z and jitter_density at a width, and jitter_density at
    # octave counts, that run their runtime-shape kernels.
    cases = [(mode, rec, kernel, *recorded[mode][kernel])
             for mode, _, _, kernel, rec in MODES]
    for mode, _, _, kernel, rec in MODES:
        args, kwargs = recorded[mode][kernel]
        cuts = RAGGED_HK + (RAGGED_ANY_HK if kernel != "selfview" else ())
        cases += [(f"ragged {RAGGED_B}x{k}, H = {h}", rec, kernel,
                   ragged(kernel, args, h, k), kwargs) for h, k in cuts]
        if kernel == "jitter_density":
            h, k = RAGGED_HK[0]
            cases += [(f"ragged {RAGGED_B}x{k}, H = {h}, {n} octaves", rec,
                       kernel, *octave_cut(ragged(kernel, args, h, k),
                                           kwargs, n))
                      for n in RAGGED_OCTAVES]

    err = {}
    for label, rec, kernel, args, kwargs in cases:
        max_dev, max_out, shape = against_plain(rec, kernel, args, kwargs,
                                                label)
        if label in serving:
            err[rec] = max_dev
        atol, rtol = TOLERANCE[rec]
        print(f"[chip_smoke] {rec} ({label}) at {shape}: max abs deviation "
              f"{max_dev:.3e} from the plain version "
              f"({'bf16' if rec == 'jitter_density' else 'float64'}; atol "
              f"{atol}, rtol {rtol}); max |out| {max_out:.3f}", flush=True)
    log("phase 5 kernels vs plain", "all within tolerance", t)

    # -- 6: timing ---------------------------------------------------------
    t = time.perf_counter()
    records = []
    with torch.no_grad():
        for label, rec, kernel, args, kwargs in cases:
            if label not in serving:
                continue
            records.append(kernel_record(
                rec, rec, kernel, args, kwargs, mode_launches[label],
                err[rec], label, resources[rec]))
        frame_ms, encode_ms = {}, {}
        height, width = eval_depth.IMAGE_SIZE
        n_coarse = eval_depth.FLAGSHIP_RENDERER.n_coarse
        for mode, bf16, jitter, _, _ in MODES:
            net = nets[bf16]
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

    # -- 7: one f32 train step, card against host -------------------------
    from behindthescenes_tpu_torch import train as train_cli
    t = time.perf_counter()
    conf = train_cli.config(TRAIN_CONFIG)
    batch = train_batch(conf)
    draws = numpy_draws(conf, batch, TRAIN_SEED)
    log("phase 7 batch", f"{conf['batch_size']} training items at "
        f"{conf['data']['image_size']} ray-cast on the host", t)
    t = time.perf_counter()
    parity = train_parity(conf, WEIGHTS, batch, draws, dev)
    print(f"[chip_smoke] train step f32: loss {parity['loss']:.8f} on the "
          f"card, {parity['loss_host']:.8f} on the host CPU in float64 "
          f"({parity['loss_rel']:.2e} relative, bound {LOSS_RTOL}); "
          f"gradient norms of {parity['tensors']} tensors within "
          f"{parity['grad_norm_rel_max']:.2e} relative (bound "
          f"{GRAD_NORM_RTOL}; worst {parity['grad_norm_worst']}); decode "
          f"kernel launches {json.dumps(parity['launches'])}", flush=True)
    log("phase 7 train parity", "card and host agree", t)

    # -- 8: 30 steps in bf16 and in f32 ------------------------------------
    training = {"card": card, "config": TRAIN_CONFIG, "steps": TRAIN_STEPS,
                "timed_from": TIMED_FROM}
    for mode, bf16 in (("bf16", True), ("f32", False)):
        t = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        res = train_steps(conf, WEIGHTS, batch, draws, dev, bf16,
                          cuda_clock())
        res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        res["allocated_before"] = resident
        training[mode] = res
        med = res["median_ms"]
        print(f"[chip_smoke] train {mode} ({card}): loss "
              f"{res['losses'][0]:.6f} -> {res['losses'][-1]:.6f} over "
              f"{TRAIN_STEPS} steps; median step {med['step']:.2f} ms over "
              f"steps {TIMED_FROM}-{TRAIN_STEPS - 1}: "
              + ", ".join(f"{k} {med[k]:.2f}" for k in STAGES)
              + f" ms; peak memory {res['max_memory_allocated'] / 2**30:.2f}"
              f" GiB (of which {resident / 2**30:.2f} GiB held before the "
              f"trainer); decode kernel launches "
              f"{json.dumps(res['launches'])}",
              flush=True)
        log(f"phase 8 train {mode}", "losses finite and falling", t)

    # -- 9: the general depth path -----------------------------------------
    t = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(eval_depth.SEED)
    general = general_depth(nets[False], batches,
                            serving_scenes["deterministic f32"], gen)
    log("phase 9 general path", "gate met, within the self-view bounds", t)

    # -- 10-13: configs through the port's task runner ---------------------
    configs, fine = config_phases(dev, card, cuda_clock)

    # -- 14, 15: KITTI-360 occupancy on the gate drive ---------------------
    from behindthescenes_tpu_torch.datasets.gen_synthetic_kitti_360 import \
        GATE_FRAMES, make_gate_tree
    with tempfile.TemporaryDirectory(prefix="k360_gate_") as tree:
        t = time.perf_counter()
        make_gate_tree(tree)
        write_occupancy_splits(tree, GATE_FRAMES)
        log("phase 14 tree", "the occupancy gate's drive generated and "
            "preprocessed on the host", t)
        occupancy = occupancy_phases(tree, dev, card, cuda_clock)

        # -- 16: the exp_kitti_360 training run on the same drive ----------
        t = time.perf_counter()
        k360_run = k360_training_phase(tree, dev, card, cuda_clock)
        print_k360_run(k360_run, card)
        log("phase 16 exp_kitti_360 run", "checkpoints, best, resume and "
            "validation as the JAX harness's; no decode kernel", t)
    t = time.perf_counter()
    for res, (kernel, args, kwargs) in occupancy:
        records.append(kernel_record(
            res["record"], kernel, kernel, args, kwargs,
            res["launches"][kernel], max(res["max_abs_err"]),
            " ".join((res["config"], *res["overrides"])),
            resources[kernel]))
    log("phase 15 timing", card, t)

    print(json.dumps({"frame_ms": frame_ms, "encode_ms": encode_ms,
                      "serving": serving, "general_path": general["means"],
                      "train_parity": parity, "training": training,
                      "configs": configs, "fine_pass": fine,
                      "occupancy": [res for res, _ in occupancy],
                      "k360_training": k360_run}),
          flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
