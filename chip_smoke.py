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
kernel, whose launches it counts), and the converged exp_synthetic
checkpoint (media/weights/synthetic_conv_step8400.npz) through
eval_synthetic (4 scenes at 48x64, bf16, the shared_z kernel at H = 32:
each launch held against the plain version, then timed) and
eval_synthetic_nvs, each also held to the JAX accuracy gate's bounds
(tests/test_accuracy_gate.py). Phase 13 holds the fine pass's value
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

Phase 17 trains the fast profiles at full width from the flagship
checkpoint, with the configs' batch (4 items at 192x640, 2048 rays):
exp_synthetic_flagship_fast (24 coarse + 16 importance-fine samples
reusing the coarse ones) and _fast2 (8 of the 16 around the coarse
depth). For each, one f32 step on the card against the host's float64
step, the reuse step against the re-query step on the card, and 30 bf16
steps with their median step split at the trainer's mark points and the
peak memory; then one f32 step of the first with automasking and one
with the patch image processor, each against the host.

Phases 18-20 run the paper's own benchmarks on trees that the port's
generators build on the host (frames written by its JPEG writer and read
by its JPEG reader): phase 18 `-cn eval_depth` with k360_synth_conv.npz
on a synthetic KITTI raw drive (20 frames at 375x1242 with velodyne
scans; 8 test keyframes at 192x640, 64 samples, bf16, 4 views an item),
through the shared_z kernel (bf16, H = 64, a frame's 122,880 rays), each
launch held against its plain version and timed; the frame split into
the loader's item (its JPEG reads and velodyne ground truth apart),
encode and render. Phase 19 trains `-cn exp_kitti_raw` on that drive at
the config's widths for 8 micro-steps; phase 20 `-cn eval_nvs` with
re10k_synth_conv.npz on a synthetic RealEstate10K tree (360x640 frames,
12 test keyframes at 256x384, 48 samples) and 4 micro-steps of `-cn
exp_re10k`. Each benchmark is held to the JAX package's CPU means for the
same command (tools/kitti_raw_reference.py, tools/re10k_reference.py) and
to floors at about 90% of them; each training run to finite losses and
no decode kernel, its micro-step split beside the loader's wait and the
loader's item with its JPEG share.

Phases 21-23 run the JAX package's remaining serving and media paths:
phase 21 serves NVS in sweep mode (models/sweep.py: the shared ladder,
features fetched on a warp lattice) through `-cn
eval_synthetic_flagship_nvs model_conf.nvs_sweep=true renderer.n_fine=0
renderer.n_coarse=64` and the RE10K shape, each held to the JAX
package's sweep means on the CPU (tools/sweep_reference.py), the
flagship frame timed at warp 0.5, warp 0.25 and exact beside phase 10's
general path, and the exact sweep held to the general path on its
ladder in f32. Phase 22 trains the flagship with the tile fetch
(model_conf.tile_fetch_region=[16, 64]) and without it on one batch:
the share of tiles that fit, each fetched point of a fitting tile
against grid_sample_2d, and both paths' steps timed in bf16 and f32.
Phase 23 runs the image demos (`python -m
behindthescenes_tpu_torch.scripts.gen_img_custom` on
media/example/0000.png with the KITTI raw model, and gen_imgs), whose
depth launches jitter_density (held against its plain version and
timed as record jitter_density_demo), and holds the BEV profile, sigma
and depth to the JAX demo's (media/reference/).

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
STEP8400_WEIGHTS = "media/weights/synthetic_conv_step8400.npz"
CONFIG_RUNS = (
    ("10", "eval_synthetic_flagship_nvs", WEIGHTS,
     {"psnr": 21.737083151764843, "ssim": 0.8550886325707533}),
    ("11", "eval_synthetic_re10k_nvs", RE10K_WEIGHTS,
     {"psnr": 34.67743968537996, "ssim": 0.9651916788752829}),
    ("12", "exp_synthetic_re10k", RE10K_WEIGHTS,
     {"abs_rel": 0.11355338990688324, "a1": 0.9073164198133682}),
    ("12", "eval_synthetic_flagship", WEIGHTS,
     {"abs_rel": 0.2174396589398384, "a1": 0.5499790945193574}),
    # exp_synthetic's ResNet-18 (an f16 export), 4 scenes at 48x64, 24
    # samples, bf16; the JAX means from `JAX_PLATFORMS=cpu python3
    # tools/step8400_reference.py`.
    ("12", "eval_synthetic", STEP8400_WEIGHTS,
     {"abs_rel": 0.16368312761187553, "a1": 0.7637174431043636}),
    ("12", "eval_synthetic_nvs", STEP8400_WEIGHTS,
     {"psnr": 20.785650029574413, "ssim": 0.8333972933502852}),
)
JAX_GAP = {"psnr": 0.15, "ssim": 0.005, "abs_rel": 0.005, "a1": 0.01}
# The JAX package's own NVS gate floors for these families
# (tests/test_nvs_gate_re10k.py:36-37, measured at 64x96;
# tests/test_train_anneal_gate.py:31-32, flagship shape at 96x320).
NVS_FLOORS = {"eval_synthetic_re10k_nvs": {"psnr": 27.2, "ssim": 0.87},
              "eval_synthetic_flagship_nvs": {"psnr": 17.9, "ssim": 0.70},
              "eval_synthetic_nvs": {"psnr": 19.8, "ssim": 0.80},
              # phase 20: about 90% of JAX's means (DISK_RUNS)
              "eval_nvs": {"psnr": 31.7, "ssim": 0.87}}
# The JAX accuracy gate of synthetic_conv_step8400.npz
# (tests/test_accuracy_gate.py:116-117): abs_rel under, a1 over.
DEPTH_GATES = {"eval_synthetic": {"abs_rel": 0.21, "a1": 0.63},
               # phase 18: about 90% of JAX's means (DISK_RUNS), abs_rel's
               # a ceiling at JAX's / 0.9
               "eval_depth": {"abs_rel": 0.229, "a1": 0.774}}
# Rows of CONFIG_RUNS (and phase 18's eval_depth) whose every kernel
# launch is recorded and held against its plain version: the kernel, its
# record and the width H that the config's model gives it
# (exp_synthetic's ResnetFC is 32 wide, exp_kitti_raw's 64; bf16, so
# shared_z takes bf16 inputs).
KERNEL_ROWS = {"eval_synthetic": ("shared_z", "shared_z_bf16", 32),
               "eval_depth": ("shared_z", "shared_z_bf16", 64)}
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

# Phase 17: the fast training profiles at full width from WEIGHTS, with
# the configs' batch (4 items at 192x640, 2048 patch rays):
# exp_synthetic_flagship_fast (24 coarse + 16 importance-fine samples
# reusing the coarse ones) and _fast2 (8 of the 16 around the coarse
# depth, depth_std 0.25). Each: one f32 step on the card against the host
# in float64 (LOSS_RTOL, GRAD_NORM_RTOL), the reuse step against the
# re-query step on the card (REUSE_LOSS_RTOL, REUSE_GRAD_RTOL: the same
# composite in another order), and FAST_STEPS bf16 steps. Then one f32
# step of the first with each of FAST_VARIANTS' model_conf changes
# against the host. _fast2's gradient norms are held to 3e-3: through its
# around-depth samples (placed at the coarse depth, which the network
# moves) every f32 step is that far from float64 on a few small tensors,
# the host's own f32 step as far as the card's (1.37e-3 and 1.45e-3 on
# mlp_coarse.lin_out.bias; `python3 tools/train_precision.py
# exp_synthetic_flagship_fast2`), where the other profiles stay under
# GRAD_NORM_RTOL.
FAST_CONFIGS = ("exp_synthetic_flagship_fast", "exp_synthetic_flagship_fast2")
FAST_GRAD_NORM_RTOL = {"exp_synthetic_flagship_fast2": 3e-3}
FAST_STEPS = 30
REUSE_LOSS_RTOL = 1e-5
REUSE_GRAD_RTOL = 1e-4
FAST_VARIANTS = {
    "automasking": {"use_automasking": True},
    "patch processor": {"image_processor": {"type": "patch",
                                            "patch_size": 3}},
}

# Phases 18-20: the paper's KITTI raw depth and RealEstate10K NVS
# benchmarks and their training configs, on the port's synthetic trees
# (datasets/gen_synthetic_kitti_raw.py: 20 frames at 375x1242, 8 test
# keyframes; datasets/gen_synthetic_re10k.py: one training and one test
# sequence of 60 frames at 360x640, 12 test keyframes), built on the host
# in a process of their own. The JAX package's means for the same
# commands on the CPU, on trees of the same generators with the JPEG
# frames decoded by cv2: `JAX_PLATFORMS=cpu python3
# tools/kitti_raw_reference.py` and `tools/re10k_reference.py` (eval_depth:
# 192x640, 64 samples, bf16, the C++ velodyne projector; eval_nvs:
# 256x384, 48 samples, bf16). eval_depth decodes through the shared-z
# ladder, so it launches shared_z (bf16, H = 64) once per keyframe on a
# frame's rays (KERNEL_ROWS); eval_nvs launches no decode kernel. Their
# floors are in DEPTH_GATES and NVS_FLOORS.
DISK_RUNS = (
    ("18", "eval_depth", K360_WEIGHTS, "gen_synthetic_kitti_raw",
     {"abs_rel": 0.206322418525815, "a1": 0.859669389621036}),
    ("20", "eval_nvs", RE10K_WEIGHTS, "gen_synthetic_re10k",
     {"psnr": 35.26165460734307, "ssim": 0.9668717595751142}),
)
# The shape of eval_depth's launches: a 192x640 frame's rays, 64 samples.
KRAW_LAUNCH_SHAPE = (192 * 640, 64)
# Depth configs whose frame is split into encode and render by CUDA
# events (the NVS configs are split always).
DEPTH_FRAME_SPLIT = ("eval_depth",)
# Phases 19 and 20's training runs at the configs' own widths
# (exp_kitti_raw: batch 8 x accumulate_steps 2, 4 views an item, 2048
# patch rays x 64 samples; exp_re10k: batch 12 x 2, 3 views, random
# dilation, 1024 rays x 48 samples; bf16, colour jitter, flips), each
# encoder from a torchvision-keyed ResNet-50 `.pth` written from its
# benchmark's checkpoint: (phase, config, checkpoint, micro-steps, the
# first timed).
DISK_TRAIN_RUNS = (
    ("19", "exp_kitti_raw", K360_WEIGHTS, 8, 2),
    ("20", "exp_re10k", RE10K_WEIGHTS, 4, 1),
)

# Phase 21: sweep-mode NVS serving (models/sweep.py) through the task
# runner: (config, checkpoint, overrides, the JAX package's CPU means for
# the same command). JAX's evaluator reads `model_conf.nvs_sweep=true` as
# an empty dict and renders its general path then, so its means come from
# the sweep's defaults named (`model_conf.nvs_sweep.warp_scale=0.5`):
# `JAX_PLATFORMS=cpu python3 tools/sweep_reference.py --part nvs`. The
# sweep draws nothing; only rounding separates the two sides.
SWEEP_RUNS = (
    ("eval_synthetic_flagship_nvs", WEIGHTS,
     ("model_conf.nvs_sweep=true", "renderer.n_fine=0",
      "renderer.n_coarse=64"),
     {"psnr": 22.024194808526797, "ssim": 0.8554890709152171}),
    ("eval_synthetic_re10k_nvs", RE10K_WEIGHTS,
     ("model_conf.nvs_sweep=true", "renderer.n_fine=0"),
     {"psnr": 34.92799132802529, "ssim": 0.96789160887886}),
)
# The sweep's frame profiles timed on the flagship: the default (warp
# 0.5), warp 0.25, and the exact frame (every sample fetched, every
# sample's colour).
SWEEP_PROFILES = {"warp 0.5": {},
                  "warp 0.25": {"warp_scale": 0.25},
                  "exact": {"warp_scale": None, "color_mode": "exact"}}
# The exact sweep against the port's general path on the same shared
# ladder, f32 (tests/test_sweep.py:80-88).
SWEEP_EXACT_TOL = {"rgb": 2e-5, "depth": 1e-4, "weights": 2e-5}

# Phase 22: the tile fetch in patch-mode training (TRAIN_CONFIG with
# model_conf.tile_fetch_region) against the gathers on the same batch and
# draws: each fetched point of a tile that fits its region against
# grid_sample_2d at f32, and, where every tile fits, the f32 step's loss
# and gradient norms within phase 7's bounds.
TILE_REGION = (16, 64)
TILE_POINT_ATOL = 1e-5

# Phase 23: the image demos through the port. gen_img_custom on the
# example image with the KITTI raw model (k360_synth_conv.npz, 192x640, 64
# samples, bf16: its depth is one jitter_density launch of 122,880 rays),
# held to the JAX demo's grids on the CPU (`JAX_PLATFORMS=cpu python3
# tools/sweep_reference.py --part demo` writes DEMO_REFERENCE): the
# profile's cells within DEMO_PROFILE_ATOL in at least DEMO_CELLS_EQUAL
# of them, sigma's relative error over the grid (2-norm) within
# DEMO_SIGMA_RTOL, and, the two sides drawing different jitter, the
# depth's median relative difference within DEMO_DEPTH_MEDIAN_REL.
# gen_imgs on exp_synthetic's test items with synthetic_conv_step8400.npz
# (jitter_density at H = 32).
DEMO_IMAGE = "media/example/0000.png"
DEMO_REFERENCE = "media/reference/gen_img_custom_kitti_raw.npz"
DEMO_CELLS_EQUAL, DEMO_PROFILE_ATOL = 0.99, 1e-2
DEMO_SIGMA_RTOL = 1e-2
DEMO_DEPTH_MEDIAN_REL = 0.02
DEMO_IMGS_INDICES = (0, 1)
DEMO_TIMED = 10

_T0 = time.perf_counter()


# Phase 24: multi-GPU on torch.distributed. PARALLEL_WORLD ranks started by
# behindthescenes_tpu_torch.parallel.launch.run_ranks, over NCCL with a
# card a rank where the machine has that many cards, else over gloo with
# every rank on cuda:0 (NCCL refuses two ranks on one card). Each rank,
# and this process at world 1, runs `parallel_work`: (a) phase 7's f32
# flagship step on its rows of the batch and draws (the global batch is
# phase 7's 4 items), then PARALLEL_TIMED bf16 steps, timed from
# PARALLEL_TIMED_FROM (recorded only: ranks that share a card are no
# scaling figure); (b) phase 9's general-path depth of the gate scenes and
# the flagship NVS config, both in f32, per frame; (c) phase 14's LiDAR
# runs on the gate drive. The ranks are held to world 1 within the CPU
# tests' bounds (tests/test_torch_multidevice_*.py): the loss to 1e-6
# relative; each gradient element to 1e-3 relative plus 1e-2 of its
# leaf's max plus what a one-ulp scaling of the images moves world 1's
# own gradient there; the BatchNorm statistics to 1e-6 of max(1, |s|)
# (an f32 ulp of a running variance over 16 is 1.9e-6); the step's
# parameters within 3 lr, under 5e-3 of them apart by more than 0.5 lr;
# the ranks' parameters bit-equal; each frame's metrics to 1e-5 relative
# (of max(1, |m|)); o_acc, ie_prec and ie_rec to 1e-4.
PARALLEL_WORLD = 2
PARALLEL_TIMEOUT = 600.0
PARALLEL_TIMED = 10
PARALLEL_TIMED_FROM = 2
PARALLEL_NVS = ("eval_synthetic_flagship_nvs", ("bf16=false",))
PARALLEL_LOSS_RTOL = 1e-6
PARALLEL_GRAD_RTOL = 1e-3
PARALLEL_GRAD_ATOL_OF_MAX = 1e-2
PARALLEL_STATS_RTOL = 1e-6
PARALLEL_METRIC_RTOL = 1e-5
PARALLEL_OCC_ATOL = 1e-4
PARALLEL_OCC_METRICS = ("o_acc", "ie_prec", "ie_rec")


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
    among the loss views, patch corners, the coarse jitter, and with the
    fine pass its importance uniforms and around-depth normals."""
    import numpy as np
    import torch
    from behindthescenes_tpu_torch.ray_sampler import PatchDraws
    from behindthescenes_tpu_torch.renderer import FineDraws
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
    rc = conf["renderer"]
    jitter = rng.uniform(size=(n, rays, rc["n_coarse"]))
    fine = None
    n_fd = rc.get("n_fine_depth", 0)
    n_imp = rc.get("n_fine", 0) - n_fd
    if rc.get("n_fine", 0) > 0:
        def f32(a):
            return None if a is None else torch.as_tensor(
                a, dtype=torch.float32)
        fine = FineDraws(
            *(f32(rng.uniform(size=(n, rays, n_imp))) if n_imp > 0 else None
              for _ in range(2)),
            normals=f32(rng.standard_normal((n, rays, n_fd)))
            if n_fd > 0 else None)
    return Draws(rays=PatchDraws(*(torch.as_tensor(a) for a in
                                   (views, ys, xs))),
                 z_jitter=torch.as_tensor(jitter, dtype=torch.float32),
                 fine=fine)


def on_device(batch: dict, draws, dev, dtype=None):
    """The batch and the draws as tensors on `dev`, the floating ones in
    `dtype` where given."""
    import dataclasses
    import torch
    from behindthescenes_tpu_torch.ray_sampler import PatchDraws
    from behindthescenes_tpu_torch.renderer import FineDraws
    tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    if dtype is not None:
        tb = {k: v.to(dtype) if v.is_floating_point() else v
              for k, v in tb.items()}

    def move(t):
        return None if t is None else t.to(dev, dtype or t.dtype)
    rays = PatchDraws(*(t.to(dev) for t in dataclasses.astuple(draws.rays)))
    fine = None if draws.fine is None else FineDraws(
        *(move(t) for t in dataclasses.astuple(draws.fine)))
    return tb, dataclasses.replace(draws, rays=rays,
                                   z_jitter=move(draws.z_jitter), fine=fine)


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


def one_step(conf: dict, weights: str, batch: dict, draws, dev,
             dtype) -> tuple:
    """One train step from `weights` on `dev` in `dtype` with these draws.
    Returns (loss, {parameter: gradient norm}, the decode kernels'
    launches); raises if an f32 step launched a decode kernel."""
    import torch
    from behindthescenes_tpu_torch.ops import kernels
    trainer = make_trainer(conf, weights, dev, dtype)
    tb, td = on_device(batch, draws, dev, dtype)
    kernels.reset_launch_counts()
    loss = float(trainer.train_step(tb, td)["loss"])
    launched = kernels.launch_counts()
    if dtype == torch.float32 and any(launched.values()):
        raise AssertionError(f"the train step launched decode kernels: "
                             f"{launched}")
    norms = {n: p.grad.double().norm().item()
             for n, p in trainer.net.named_parameters()
             if p.grad is not None}
    return loss, norms, launched


def step_gap(got: tuple, want: tuple, loss_rtol: float, grad_rtol: float,
             what: str) -> dict:
    """The loss of step `got` against `want`'s within loss_rtol, and each
    parameter's gradient norm above GRAD_NORM_FLOOR of the largest within
    grad_rtol, relative; raises where not."""
    (loss_d, norms_d, launched), (loss_h, norms_h, _) = got, want
    rel = abs(loss_d - loss_h) / abs(loss_h)
    if rel > loss_rtol:
        raise AssertionError(f"{what}: loss {loss_d} vs {loss_h}: "
                             f"{rel:.2e} relative")
    if set(norms_d) != set(norms_h):
        raise AssertionError(f"{what}: gradients of different parameters")
    floor = GRAD_NORM_FLOOR * max(norms_h.values())
    devs = {n: abs(norms_d[n] - v) / v for n, v in norms_h.items()
            if v > floor}
    worst = max(devs, key=devs.get)
    if devs[worst] > grad_rtol:
        raise AssertionError(f"{what}: gradient norm of {worst}: "
                             f"{norms_d[worst]} vs {norms_h[worst]}")
    return {"loss": loss_d, "loss_host": loss_h, "loss_rel": rel,
            "grad_norm_rel_max": devs[worst], "grad_norm_worst": worst,
            "tensors": len(devs), "launches": launched}


def train_parity(conf: dict, weights: str, batch: dict, draws,
                 dev, grad_rtol: float = GRAD_NORM_RTOL) -> dict:
    """One f32 step from `weights` on `dev`, and the same step (batch,
    draws, views) on the host CPU in float64. Raises unless the loss
    agrees to LOSS_RTOL and every parameter's gradient norm above
    GRAD_NORM_FLOOR of the largest to grad_rtol, or if the step on
    `dev` launched a decode kernel."""
    import torch
    return step_gap(one_step(conf, weights, batch, draws, dev,
                             torch.float32),
                    one_step(conf, weights, batch, draws, "cpu",
                             torch.float64),
                    LOSS_RTOL, grad_rtol, f"{dev} vs the host")


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


def host_clock():
    """cuda_clock's interface on the host's clock (for a rank on the
    CPU)."""
    def clock():
        return time.perf_counter()
    clock.ms = lambda a, b: (b - a) * 1e3
    clock.sync = lambda: None
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


def fast_training_phase(dev, card: str, clock_fn, weights: str = WEIGHTS,
                        overrides=(), steps: int = FAST_STEPS,
                        timed_from: int = TIMED_FROM) -> dict:
    """Phase 17 (see FAST_CONFIGS) on `dev`, the configs with the
    `overrides`, printing each result beside the card. Raises if a check
    fails or a decode kernel was launched. Returns the phase's record."""
    import copy
    import torch
    from behindthescenes_tpu_torch import train as train_cli
    cuda = torch.device(dev).type == "cuda"
    out = {"card": card, "steps": steps, "timed_from": timed_from}
    for name in FAST_CONFIGS:
        t = time.perf_counter()
        conf = train_cli.config(name, overrides=overrides)
        rc = conf["renderer"]
        if not (rc["n_fine"] > 0 and rc["fine_reuse_coarse"]):
            raise AssertionError(f"{name}: not a fine pass with reuse: {rc}")
        batch = train_batch(conf)
        draws = numpy_draws(conf, batch, TRAIN_SEED)
        grad_rtol = FAST_GRAD_NORM_RTOL.get(name, GRAD_NORM_RTOL)
        parity = train_parity(conf, weights, batch, draws, dev, grad_rtol)
        requery = copy.deepcopy(conf)
        requery["renderer"]["fine_reuse_coarse"] = False
        reuse = step_gap(
            one_step(conf, weights, batch, draws, dev, torch.float32),
            one_step(requery, weights, batch, draws, dev, torch.float32),
            REUSE_LOSS_RTOL, REUSE_GRAD_RTOL, f"{name} reuse vs re-query")
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        res = train_steps(conf, weights, batch, draws, dev, True, clock_fn(),
                          steps, timed_from)
        res["max_memory_allocated"] = torch.cuda.max_memory_allocated() \
            if cuda else None
        out[name] = {"renderer": {k: rc.get(k) for k in (
            "n_coarse", "n_fine", "n_fine_depth", "depth_std")},
            "parity": parity, "reuse_vs_requery": reuse, "bf16": res}
        med, peak = res["median_ms"], res["max_memory_allocated"]
        print(f"[chip_smoke] {name} f32 step: loss {parity['loss']:.8f} on "
              f"the card, {parity['loss_host']:.8f} on the host in float64 "
              f"({parity['loss_rel']:.2e} relative, bound {LOSS_RTOL}); "
              f"gradient norms within {parity['grad_norm_rel_max']:.2e} "
              f"(bound {grad_rtol}; worst {parity['grad_norm_worst']}); "
              "reuse vs re-query on the card: "
              f"loss {reuse['loss_rel']:.2e}, gradient norms "
              f"{reuse['grad_norm_rel_max']:.2e} relative (bounds "
              f"{REUSE_LOSS_RTOL}, {REUSE_GRAD_RTOL})", flush=True)
        print(f"[chip_smoke] {name} train bf16 ({card}): loss "
              f"{res['losses'][0]:.6f} -> {res['losses'][-1]:.6f} over "
              f"{steps} steps; median step {med['step']:.2f} ms over steps "
              f"{timed_from}-{steps - 1}: "
              + ", ".join(f"{k} {med[k]:.2f}" for k in STAGES)
              + " ms; peak memory " + ("not measured" if peak is None
                                       else f"{peak / 2**30:.2f} GiB")
              + f"; decode kernel launches {json.dumps(res['launches'])}",
              flush=True)
        log(f"phase 17 {name}", "the card's step agrees with the host's; "
            "reuse equals re-query; losses finite and falling", t)
    out["variants"] = {}
    for label, change in FAST_VARIANTS.items():
        t = time.perf_counter()
        conf = train_cli.config(FAST_CONFIGS[0], overrides=overrides)
        conf["model_conf"].update(copy.deepcopy(change))
        batch = train_batch(conf)
        parity = train_parity(conf, weights, batch,
                              numpy_draws(conf, batch, TRAIN_SEED), dev)
        out["variants"][label] = parity
        print(f"[chip_smoke] {FAST_CONFIGS[0]} with {label} f32 step: loss "
              f"{parity['loss']:.8f} on the card, {parity['loss_host']:.8f}"
              f" on the host in float64 ({parity['loss_rel']:.2e} relative,"
              f" bound {LOSS_RTOL}); gradient norms within "
              f"{parity['grad_norm_rel_max']:.2e} (bound {GRAD_NORM_RTOL})",
              flush=True)
        log(f"phase 17 {label}", "the card's step agrees with the host's", t)
    return out


def shared_z_bf16_piece(h: int, k: int) -> str:
    """The piece of ptxas's name of the bf16 shared_z kernel that serves
    width h and k samples: csrc/shared_z.cu's launch_bf16_tiles gives a
    warp 4, 2 or 1 tiles of 16 samples, as many as divide k's tiles."""
    tiles = -(-k // 16)
    kt = 4 if tiles % 4 == 0 else 2 if tiles % 2 == 0 else 1
    return f"shared_z_bf16_kernelILi{h}ELi{kt}E"


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


def depth_frame_ms(calls, clock) -> dict:
    """Median ms of each recorded depth item's frame again (the task
    run's generator, seed = its place) and of its encode and render
    stages, by `clock`."""
    import statistics
    import torch
    split = {}
    for i, (ev, batch, _) in enumerate(calls):
        dev = next(ev.net.parameters()).device
        args = [torch.as_tensor(batch[k], device=dev)
                for k in ("imgs", "projs", "poses")]
        gen = torch.Generator(device=dev)
        gen.manual_seed(i)
        events = [("start", clock())]
        depth = ev.render(*args, generator=gen, mark=lambda name:
                          events.append((name, clock())))
        clock.sync()
        if not torch.isfinite(depth).all() or \
                [n for n, _ in events] != ["start", "encode", "render"]:
            raise AssertionError("a depth frame is not finite or not split")
        for (_, a), (name, b) in zip(events, events[1:]):
            split.setdefault(name, []).append(clock.ms(a, b))
        split.setdefault("frame", []).append(clock.ms(events[0][1],
                                                      events[-1][1]))
    return {k: statistics.median(v) for k, v in split.items()}


def config_phase(name: str, checkpoint: str, jax_means: dict, dev, clock,
                 overrides=(), frames: int = NVS_TIMED_FRAMES) -> dict:
    """One config through the task runner, with the decode kernels'
    launches counted from 0 and the peak memory. Raises unless every mean
    is finite and within JAX_GAP of jax_means, and the means meet
    NVS_FLOORS and DEPTH_GATES. NVS configs also get their frame time
    split. For a row of KERNEL_ROWS, raises unless its kernel, and no
    other, was launched once per scene at the row's width, each launch
    within tolerance of the plain version on its arguments; its first
    launch's (args, kwargs) are res["launch"]."""
    import math
    import torch
    from behindthescenes_tpu_torch.ops import kernels
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with recorded_kernel_args() as (_, state):
        state["mode"], state["calls"] = name, []
        conf, means, calls = config_eval(name, checkpoint, dev, overrides)
    launched = kernels.launch_counts()
    res = {"config": name, "checkpoint": checkpoint, "means": means,
           "jax_means": jax_means,
           "per_scene": [out for _, _, out in calls], "launches": launched,
           "peak_memory": torch.cuda.max_memory_allocated() if cuda
           else None}
    if not calls or not all(math.isfinite(v) for v in means.values()):
        raise AssertionError(f"{name}: {len(calls)} scenes, means {means}")
    if name in KERNEL_ROWS:
        kernel, rec, h = KERNEL_ROWS[name]
        launch_calls = state["calls"]
        widths = [args[0].shape[1] for _, args, _ in launch_calls]
        want = {k: len(calls) if k == kernel else 0 for k in launched}
        if launched != want or widths != [h] * len(calls):
            raise AssertionError(f"{name}: kernel launches {launched} at "
                                 f"H = {widths}, want {want} at H = {h}")
        res["max_abs_err"] = [
            against_plain(rec, kernel, args, kwargs, f"{name} launch {i}")[0]
            for i, (_, args, kwargs) in enumerate(launch_calls)]
        res["launch"] = launch_calls[0][1:]
    for k, want in jax_means.items():
        res[f"gap_{k}"] = means[k] - want
        if not abs(means[k] - want) <= JAX_GAP[k]:
            raise AssertionError(f"{name}: {k} {means[k]:.6f} vs JAX "
                                 f"{want:.6f} (bound {JAX_GAP[k]})")
    for k, floor in NVS_FLOORS.get(name, {}).items():
        if not means[k] > floor:
            raise AssertionError(f"{name}: {k} {means[k]:.4f} under the "
                                 f"JAX gate's {floor}")
    gate = DEPTH_GATES.get(name)
    if gate and not (means["abs_rel"] < gate["abs_rel"]
                     and means["a1"] > gate["a1"]):
        raise AssertionError(f"{name}: abs_rel {means['abs_rel']:.4f} "
                             f"(max {gate['abs_rel']}), a1 "
                             f"{means['a1']:.4f} (min {gate['a1']})")
    if conf["model"] == "bts_nvs":
        res["frame_ms"] = nvs_frame_ms(calls[-1][0], calls[-1][1], clock,
                                       frames)
    elif name in DEPTH_FRAME_SPLIT:
        res["frame_ms"] = depth_frame_ms(calls, clock)
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
    the shared_z kernel launched, the KERNEL_ROWS with theirs held
    against the plain version; then `fine_value`. Returns (the config
    records, the fine-pass record, {row of KERNEL_ROWS: the (args,
    kwargs) of its first launch})."""
    configs, launches = [], {}
    for phase, name, checkpoint, jax_means in CONFIG_RUNS:
        t = time.perf_counter()
        res = config_phase(name, checkpoint, jax_means, dev, clock_fn(),
                           overrides, frames)
        if "launch" in res:
            launches[name] = res.pop("launch")
        configs.append(res)
        launched = res["launches"]
        if name.endswith("_nvs") and any(launched.values()):
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
              + f"; decode kernel launches {json.dumps(launched)}"
              + (f" (max abs deviation from the plain version "
                 f"{max(res['max_abs_err']):.3e})" if "max_abs_err" in res
                 else "")
              + "; peak memory " + ("not measured" if peak is None
                                    else f"{peak / 2**30:.2f} GiB"),
              flush=True)
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
    return configs, fine, launches


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


def build_tree(module: str, tree: str, args=()) -> dict:
    """datasets/MODULE.py's generator writing its tree under `tree` in a
    process of its own (its frames rendered by a pool of forked
    processes, one a core); returns its JSON line (the seconds of its
    parts summed over the frames, the frames' bytes, the wall seconds)."""
    proc = subprocess.run(
        [sys.executable, "-m", f"behindthescenes_tpu_torch.datasets.{module}",
         "--out", tree, "--workers", str(os.cpu_count()), *args],
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"{module} exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


@contextlib.contextmanager
def timed_calls(owner, attr: str, seconds: list):
    """owner.attr wrapped so that each call appends its seconds."""
    fn = getattr(owner, attr)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            seconds.append(time.perf_counter() - t0)
    setattr(owner, attr, timed)
    try:
        yield seconds
    finally:
        setattr(owner, attr, fn)


def loader_split(ds, indices) -> dict:
    """Items of a KITTI raw or RealEstate10K dataset made one after
    another on this thread: median ms of an item, of its JPEG reads (and
    their count) and of its velodyne ground truth (KITTI raw's test
    split), and the JPEG reads' share of the items' time."""
    import statistics
    from behindthescenes_tpu_torch.datasets import kitti_raw, realestate10k
    jpeg, velo, item, frames = [], [], [], []
    with contextlib.ExitStack() as stack:
        for mod in (kitti_raw, realestate10k):
            stack.enter_context(timed_calls(mod, "read_jpeg", jpeg))
        stack.enter_context(timed_calls(kitti_raw.KittiRawDataset,
                                        "load_depth", velo))
        for i in indices:
            n_jpeg, n_velo = len(jpeg), len(velo)
            t0 = time.perf_counter()
            ds[i]
            item.append(time.perf_counter() - t0)
            frames.append(len(jpeg) - n_jpeg)
            jpeg[n_jpeg:] = [sum(jpeg[n_jpeg:])]
            if len(velo) > n_velo:
                velo[n_velo:] = [sum(velo[n_velo:])]
    out = {"item_ms": statistics.median(item) * 1e3,
           "jpeg_ms": statistics.median(jpeg) * 1e3,
           "jpeg_frames": statistics.median(frames),
           "jpeg_share": sum(jpeg) / sum(item)}
    if velo:
        out["velodyne_ms"] = statistics.median(velo) * 1e3
    return out


def disk_eval_phase(phase: str, name: str, checkpoint: str, tree_over,
                    jax_means: dict, dev, card: str, clock_fn,
                    extra=()) -> tuple:
    """Phase 18's or 20's benchmark: configs/NAME with `checkpoint` on a
    tree (its data overrides `tree_over`) through `config_phase` (the means within JAX_GAP of JAX's and
    above the floors; eval_depth's shared_z launches once per keyframe at
    H = 64, each against its plain version, on KRAW_LAUNCH_SHAPE;
    eval_nvs with no decode kernel), then the test loader's items split
    on the host. Prints and returns (the record, the first launch's
    (args, kwargs) or None)."""
    from behindthescenes_tpu_torch.config import (find_config, load_config,
                                                  parse_cli_overrides)
    from behindthescenes_tpu_torch.datasets.factory import make_test_dataset
    t = time.perf_counter()
    res = config_phase(name, checkpoint, jax_means, dev, clock_fn(),
                       (*tree_over, *extra))
    launch = res.pop("launch", None)
    launched = res["launches"]
    if name == "eval_depth":
        hs, hd = launch[0][0], launch[0][1]
        if launched["shared_z"] <= 0 or \
                (hs.shape[0], hd.shape[0]) != KRAW_LAUNCH_SHAPE or \
                hs.dtype != hd.dtype or str(hs.dtype) != "torch.bfloat16":
            raise AssertionError(f"{name}: shared_z launches {launched} on "
                                 f"{tuple(hs.shape)} x {tuple(hd.shape)} "
                                 f"{hs.dtype}, want {KRAW_LAUNCH_SHAPE} "
                                 "bf16")
    elif any(launched.values()):
        raise AssertionError(f"{name} launched decode kernels: {launched}")
    conf = load_config(find_config(name), parse_cli_overrides(
        [f"checkpoint={checkpoint}", *tree_over, *extra]))
    ds = make_test_dataset(conf["data"])
    if hasattr(ds, "return_depth"):
        ds.return_depth = True
    res["loader"] = loader_split(ds, range(min(len(ds), 4)))
    keys = list(jax_means)
    peak, fm, ld = res["peak_memory"], res["frame_ms"], res["loader"]
    print(f"[chip_smoke] {name} on the synthetic tree ({card}): "
          + ", ".join(f"{k} {res['means'][k]:.6f} (JAX on the CPU "
                      f"{jax_means[k]:.6f}, gap {res['gap_' + k]:+.6f}, "
                      f"bound {JAX_GAP[k]})" for k in keys)
          + f"; {len(res['per_scene'])} items, per item "
          + json.dumps([[round(m[k], 6) for k in keys]
                        for m in res["per_scene"]])
          + f"; decode kernel launches {json.dumps(launched)}"
          + (f" (max abs deviation from the plain version "
             f"{max(res['max_abs_err']):.3e})" if "max_abs_err" in res
             else "")
          + "; peak memory " + ("not measured" if peak is None
                                else f"{peak / 2**30:.2f} GiB"), flush=True)
    print(f"[chip_smoke] {name} frame ({card}): median {fm['frame']:.3f} ms"
          f" (encode {fm['encode']:.3f}, render {fm['render']:.3f}); the "
          f"loader's item {ld['item_ms']:.1f} ms on one host thread, of "
          f"which {ld['jpeg_frames']:.0f} JPEG reads {ld['jpeg_ms']:.1f} ms"
          + (f" and the velodyne ground truth {ld['velodyne_ms']:.1f} ms"
             if "velodyne_ms" in ld else ""), flush=True)
    log(f"phase {phase} {name}", "within the bounds of JAX's means", t)
    return res, launch


def _generator(module: str):
    """datasets/MODULE.py of the port (a tree generator)."""
    import importlib
    return importlib.import_module(
        f"behindthescenes_tpu_torch.datasets.{module}")


def disk_training_phase(phase: str, name: str, checkpoint: str, tree_over,
                        stop: int, timed_from: int, dev, card: str,
                        clock_fn, extra=()) -> dict:
    """Phase 19's or 20's training: configs/NAME on a tree (its data
    overrides `tree_over`) through the port's training task for `stop` micro-steps, the encoder from a
    torchvision-keyed `.pth` of `checkpoint`. Raises unless every loss is
    finite, the run took `stop` micro-steps and no decode kernel was
    launched. Prints and returns the micro-step split (after
    `timed_from`), the loader's wait, the loader's item on one host
    thread with its JPEG share, and the peak memory."""
    import math
    import torch
    from behindthescenes_tpu_torch.config import (find_config, load_config,
                                                  parse_cli_overrides)
    from behindthescenes_tpu_torch.ops import kernels
    from behindthescenes_tpu_torch.training import tasks
    t = time.perf_counter()
    cuda = torch.device(dev).type == "cuda"
    with tempfile.TemporaryDirectory(prefix=f"{name}_run_") as tmp:
        pth = os.path.join(tmp, "resnet50.pth")
        conf = load_config(find_config(name), parse_cli_overrides([
            *tree_over,
            f"model_conf.encoder.cp_location={pth}",
            "model_conf.encoder.pretrained_strict=true",
            f"stop_iteration={stop}", f"checkpoint_every={stop}",
            "validate_every=1000000", f"output_path={tmp}/run", *extra]))
        torch.save(torchvision_resnet_state_dict(
            checkpoint, conf["model_conf"]["encoder"]["resnet_layers"]), pth)
        kernels.reset_launch_counts()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        clock = clock_fn()
        points, losses, iteration_ends = [], [], []

        def mark(point):
            points.append((point, time.perf_counter(), clock()))

        def on_iteration(it, trainer, loss_dict):
            losses.append(float(loss_dict["loss"]))
            iteration_ends.append((time.perf_counter(), clock()))
        t0 = time.perf_counter()
        trainer = tasks.bts_training(conf, device=dev, mark=mark,
                                     on_iteration=on_iteration)
        clock.sync()
        res = {"config": name, "checkpoint": checkpoint, "stop": stop,
               "run_s": time.perf_counter() - t0, "losses": losses,
               "launches": kernels.launch_counts(),
               "peak_memory": torch.cuda.max_memory_allocated() if cuda
               else None,
               "batch_size": conf["batch_size"],
               "accumulate_steps": conf["accumulate_steps"]}
        if any(res["launches"].values()):
            raise AssertionError(f"{name}: training launched decode "
                                 f"kernels: {res['launches']}")
        if len(losses) != stop or trainer.step != stop or \
                not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{name}: {trainer.step} micro-steps, "
                                 f"losses {losses}")
        res.update(run_split(points, iteration_ends, clock,
                             conf["accumulate_steps"], timed_from))
        train_ds = tasks.bts_get_dataflow(conf)[0].dataset
        res["loader"] = loader_split(train_ds, range(conf["batch_size"]))
    print_disk_training(res, phase, timed_from, card)
    log(f"phase {phase} {name}", f"{stop} micro-steps, losses finite, no "
        "decode kernel", t)
    return res


def print_disk_training(res: dict, phase: str, timed_from: int,
                        card: str) -> None:
    import statistics

    def med(xs):
        return statistics.median(xs) if xs else float("nan")
    peak, ld = res["peak_memory"], res["loader"]
    stages = res["median_stage_ms"]
    print(f"[chip_smoke] {res['config']} micro-step ({card}), batch "
          f"{res['batch_size']} x {res['accumulate_steps']}, median over "
          f"micro-steps {timed_from + 1}-{res['stop'] - 1}: card "
          f"{med(res['micro_step_ms']):.2f} ms ("
          + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
          + f" ms), host {med(res['micro_step_host_ms']):.2f} ms, of which "
          f"loader wait {med(res['loader_wait_ms'][timed_from:]):.2f} ms "
          f"(first micro-step {res['loader_wait_ms'][0]:.2f}); losses "
          f"{res['losses'][0]:.5f} ... {res['losses'][-1]:.5f}; the loader's"
          f" item {ld['item_ms']:.1f} ms on one host thread, of which "
          f"{ld['jpeg_frames']:.0f} JPEG reads {ld['jpeg_ms']:.1f} ms "
          f"({100 * ld['jpeg_share']:.1f}%); decode kernel launches "
          f"{json.dumps(res['launches'])}; peak memory "
          + ("not measured" if peak is None else f"{peak / 2**30:.2f} GiB"),
          flush=True)


def disk_phases(dev, card: str, clock_fn, tree_args=None,
                eval_extra=None, train_extra=None, train_runs=None):
    """Phases 18-20: each tree of DISK_RUNS built (with `tree_args`), its
    benchmark, then its training run of DISK_TRAIN_RUNS (`train_runs`
    cuts them), in a temporary directory. `eval_extra` and `train_extra`
    map a config to its cut. Returns ({config: record}, eval_depth's
    first launch)."""
    out, launch = {}, None
    train_runs = train_runs or DISK_TRAIN_RUNS
    for (phase, name, checkpoint, module, jax_means), train in zip(
            DISK_RUNS, train_runs):
        with tempfile.TemporaryDirectory(prefix=f"{module}_") as tree:
            t = time.perf_counter()
            secs = build_tree(module, tree, (tree_args or {}).get(module, ()))
            out[f"{module}_tree"] = secs
            log(f"phase {phase} tree", f"{module} on the host: "
                f"{secs['seconds']:.1f} s ({secs['frame_bytes'] / 1e6:.1f} "
                f"MB of JPEG; summed over the pool, render "
                f"{secs['render']:.1f} s, JPEG writes {secs['jpeg']:.1f} s"
                + (f", velodyne {secs['velodyne']:.1f} s"
                   if "velodyne" in secs else "") + ")", t)
            tree_over = _generator(module).overrides(tree)
            res, first = disk_eval_phase(
                phase, name, checkpoint, tree_over, jax_means, dev, card,
                clock_fn, (eval_extra or {}).get(name, ()))
            out[name] = res
            if first is not None:
                launch = first
            t_phase, t_name, t_ckpt, stop, timed_from = train
            out[t_name] = disk_training_phase(
                t_phase, t_name, t_ckpt, tree_over, stop, timed_from, dev,
                card, clock_fn, (train_extra or {}).get(t_name, ()))
    return out, launch


@contextlib.contextmanager
def counted_calls(owner, attr: str):
    """owner.attr wrapped so that each call appends its arguments to the
    yielded list."""
    calls, fn = [], getattr(owner, attr)

    def counted(*args, **kwargs):
        calls.append((args, kwargs))
        return fn(*args, **kwargs)
    setattr(owner, attr, counted)
    try:
        yield calls
    finally:
        setattr(owner, attr, fn)


def sweep_exactness(dev, weights: str = WEIGHTS, overrides=()) -> dict:
    """The flagship's exact sweep frame (warp_scale None, exact colours)
    against the port's general path composited over the sweep's own
    ladder (tests/test_sweep.py:58-71), f32, on view 1 of the first scene
    of SWEEP_RUNS[0]'s config: raises unless rgb, depth and weights are
    within SWEEP_EXACT_TOL and the invalid masks equal."""
    import torch
    from behindthescenes_tpu_torch import geometry
    from behindthescenes_tpu_torch import renderer as rlib
    from behindthescenes_tpu_torch.config import (find_config, load_config,
                                                  parse_cli_overrides)
    from behindthescenes_tpu_torch.datasets.factory import make_test_dataset
    from behindthescenes_tpu_torch.datasets.synthetic import collate
    from behindthescenes_tpu_torch.models import sweep
    from behindthescenes_tpu_torch.models.bts import BTSNet
    from behindthescenes_tpu_torch.weights import load_weights
    name, _, sweep_over, _ = SWEEP_RUNS[0]
    conf = load_config(find_config(name), parse_cli_overrides(
        [*sweep_over, *overrides]))
    mc = conf["model_conf"]
    cfg = rlib.RendererConfig.from_conf(conf["renderer"])
    net = load_weights(BTSNet.from_conf(mc), weights).to(dev).eval()
    batch = collate([make_test_dataset(conf["data"])[0]])
    images, projs, poses = (torch.as_tensor(batch[k], device=dev)
                            for k in ("imgs", "projs", "poses"))
    _, _, h, w, _ = images.shape
    poses = geometry.rebase_poses_to_keyframe(poses)
    pose, proj = poses[0, 1], projs[0, 1]
    with torch.no_grad():
        grid = net.encode(images, projs, poses, ids_encoder=[0],
                          ids_render=[0], images_alt=images[:, :1] * 0.5
                          + 0.5)
        got = sweep.render_frame_sweep(net, grid, pose, proj, (h, w), cfg,
                                       warp_scale=None,
                                       color_mode="exact")["coarse"]
        z = sweep.sweep_z_ladder(cfg.n_coarse, mc["z_near"], mc["z_far"],
                                 cfg.lindisp, device=images.device)
        focal = torch.stack([proj[0, 0], proj[1, 1]])
        center = torch.stack([proj[0, 2], proj[1, 2]])
        rays = geometry.gen_rays(pose[None], w, h, mc["z_near"],
                                 mc["z_far"], focal=focal,
                                 c=center).reshape(1, h * w, 8)
        want = rlib.composite(
            lambda xyz, coarse: net.query(grid, xyz, coarse=coarse), rays,
            z.expand(1, h * w, cfg.n_coarse), cfg)
    err = {k: (got[k].float() - want[k].float()).abs().max().item()
           for k in SWEEP_EXACT_TOL}
    same_invalid = torch.equal(got["invalid"][..., 0] > 0,
                               want["invalid"][..., 0] > 0)
    if not same_invalid or any(err[k] > t for k, t in
                               SWEEP_EXACT_TOL.items()):
        raise AssertionError(f"exact sweep vs the general path: max abs "
                             f"{err} (bounds {SWEEP_EXACT_TOL}); invalid "
                             f"masks equal: {same_invalid}")
    return {"max_abs": err, "invalid_equal": same_invalid,
            "shape": [h, w, cfg.n_coarse]}


def sweep_phase(dev, card: str, clock_fn, general_frame_ms: dict,
                overrides=(), frames: int = NVS_TIMED_FRAMES) -> dict:
    """Phase 21: each of SWEEP_RUNS through `config_phase` (the means
    within JAX_GAP of JAX's sweep means and above NVS_FLOORS, no decode
    kernel, every frame through render_frame_sweep), the flagship's
    SWEEP_PROFILES timed beside phase 10's general-path frame, and
    `sweep_exactness`. Prints and returns the record."""
    import torch
    from behindthescenes_tpu_torch.evaluation import nvs
    out = {"card": card, "runs": []}
    for name, checkpoint, sweep_over, jax_means in SWEEP_RUNS:
        t = time.perf_counter()
        with counted_calls(nvs, "render_frame_sweep") as frames_swept, \
                recorded_evaluations() as calls:
            res = config_phase(name, checkpoint, jax_means, dev, clock_fn(),
                               (*sweep_over, *overrides), frames)
            n_swept = len(frames_swept)
            if name == SWEEP_RUNS[0][0]:
                ev, batch = calls[-1][0], calls[-1][1]
                profiles = {}
                base = dict(ev.sweep_conf)
                for label, change in SWEEP_PROFILES.items():
                    ev.sweep_conf = dict(base, **change)
                    if torch.device(dev).type == "cuda":
                        torch.cuda.reset_peak_memory_stats()
                    fm = nvs_frame_ms(ev, batch, clock_fn(), frames)
                    fm["peak_memory"] = torch.cuda.max_memory_allocated() \
                        if torch.device(dev).type == "cuda" else None
                    profiles[label] = fm
                res["profiles"] = profiles
        res["overrides"] = list(sweep_over)
        res["frames_swept"] = n_swept
        if n_swept <= 0 or any(res["launches"].values()):
            raise AssertionError(f"{name} sweep: {n_swept} frames through "
                                 f"render_frame_sweep, decode kernel "
                                 f"launches {res['launches']}")
        out["runs"].append(res)
        keys = list(jax_means)
        fm, peak = res["frame_ms"], res["peak_memory"]
        print(f"[chip_smoke] {name} sweep ({card}): "
              + ", ".join(f"{k} {res['means'][k]:.6f} (JAX's sweep on the "
                          f"CPU {jax_means[k]:.6f}, gap "
                          f"{res['gap_' + k]:+.6f}, bound {JAX_GAP[k]})"
                          for k in keys)
              + f"; {n_swept} frames swept; frame median {fm['frame']:.3f} "
              f"ms (encode {fm['encode']:.3f}, render {fm['render']:.3f}); "
              "peak memory " + ("not measured" if peak is None
                                else f"{peak / 2**30:.2f} GiB"), flush=True)
        if "profiles" in res:
            gen = general_frame_ms.get(name)
            print(f"[chip_smoke] {name} frame by sweep profile ({card}): "
                  + "; ".join(
                      f"{label} {fm['frame']:.3f} ms (render "
                      f"{fm['render']:.3f}, peak "
                      + ("not measured" if fm["peak_memory"] is None
                         else f"{fm['peak_memory'] / 2**30:.2f} GiB") + ")"
                      for label, fm in res["profiles"].items())
                  + "; the general path (phase 10, 24 + 16 reuse) "
                  + ("not measured" if gen is None
                     else f"{gen['frame']:.3f} ms"), flush=True)
        log(f"phase 21 {name} sweep", "within the bounds of JAX's sweep "
            "means", t)
    t = time.perf_counter()
    out["exactness"] = sweep_exactness(dev, overrides=overrides)
    print(f"[chip_smoke] exact sweep vs the general path on its ladder, "
          f"f32, {out['exactness']['shape']}: max abs "
          + json.dumps(out["exactness"]["max_abs"])
          + f" (bounds {json.dumps(SWEEP_EXACT_TOL)}); invalid masks equal",
          flush=True)
    log("phase 21 exactness", "the exact sweep equals the general path", t)
    return out


def tile_fit_and_points(conf: dict, weights: str, batch: dict, draws,
                        dev) -> dict:
    """One f32 train step of `conf` (with a tile region) on `dev`, every
    call of the tile fetch recorded: the share of tiles that fit their
    region (tile_region_fit, the JAX package's test), the points of
    fitting tiles whose footprint passes the region's last texel (JAX's
    test passes a tile whose span is within a texel of the region while
    its region starts at the truncated minimum), and every other point of
    a fitting tile against grid_sample_2d on the same map (max abs
    deviation). Raises beyond TILE_POINT_ATOL or if the step fetched no
    tile."""
    import torch
    from behindthescenes_tpu_torch.models import bts
    from behindthescenes_tpu_torch.ops import grid_sample as gs
    with counted_calls(bts, "grid_sample_2d_tiles") as calls:
        one_step(conf, weights, batch, draws, dev, torch.float32)
    if not calls:
        raise AssertionError("the tile step fetched no tile")
    fit = tiles = points = past_edge = 0
    max_dev = 0.0
    with torch.no_grad():
        for (image, coords, region), _ in calls:
            ok = gs.tile_region_fit(coords, image.shape[:2], region)
            fit += int(ok.sum())
            tiles += ok.numel()
            if not ok.any():
                continue
            inside = gs.tile_points_inside(coords[ok], image.shape[:2],
                                           region)
            points += inside.numel()
            past_edge += int((~inside).sum())
            got = gs.grid_sample_2d_tiles(image, coords[ok], region)
            want = gs.grid_sample_2d(
                image.expand((int(ok.sum()),) + image.shape), coords[ok])
            max_dev = max(max_dev,
                          (got - want)[inside].abs().max().item())
    if max_dev > TILE_POINT_ATOL:
        raise AssertionError(f"tile fetch vs grid_sample_2d: {max_dev:.3e}")
    return {"tiles": tiles, "fit": fit, "fit_share": fit / tiles,
            "calls": len(calls), "points": points, "past_edge": past_edge,
            "point_max_abs": max_dev, "dtype": str(calls[0][0][0].dtype)}


def tile_phase(dev, card: str, clock_fn, overrides=(),
               steps: int = TRAIN_STEPS,
               timed_from: int = TIMED_FROM) -> dict:
    """Phase 22: TRAIN_CONFIG with and without the tile fetch on one
    batch and one set of draws: the fit share and the per-point check of
    `tile_fit_and_points`; where every tile fits, the f32 tile step
    against the gather step (LOSS_RTOL, GRAD_NORM_RTOL); and `steps`
    steps of each path in bf16 and f32, timed as phase 8 times them.
    Prints and returns the record."""
    import copy
    import torch
    from behindthescenes_tpu_torch import train as train_cli
    t = time.perf_counter()
    conf = train_cli.config(TRAIN_CONFIG, overrides=overrides)
    tile = copy.deepcopy(conf)
    tile["model_conf"]["tile_fetch_region"] = list(TILE_REGION)
    batch = train_batch(conf)
    draws = numpy_draws(conf, batch, TRAIN_SEED)
    out = {"card": card, "region": list(TILE_REGION), "steps": steps,
           "timed_from": timed_from}
    out["fit"] = fit = tile_fit_and_points(tile, WEIGHTS, batch, draws, dev)
    missed = fit["tiles"] - fit["fit"]
    if missed == 0:
        out["vs_gather"] = step_gap(
            one_step(tile, WEIGHTS, batch, draws, dev, torch.float32),
            one_step(conf, WEIGHTS, batch, draws, dev, torch.float32),
            LOSS_RTOL, GRAD_NORM_RTOL, "tile step vs gather step")
    print(f"[chip_smoke] tile fetch {list(TILE_REGION)} on {TRAIN_CONFIG} "
          f"({fit['dtype']}): {fit['fit']} of {fit['tiles']} tiles fit "
          f"({100 * fit['fit_share']:.2f}%), {missed} do not; of their "
          f"{fit['points']} points {fit['past_edge']} pass the region's "
          f"last texel; the others against grid_sample_2d max abs "
          f"{fit['point_max_abs']:.3e} (bound {TILE_POINT_ATOL})"
          + ("" if missed else
             f"; f32 step vs the gathers: loss "
             f"{out['vs_gather']['loss_rel']:.2e} relative (bound "
             f"{LOSS_RTOL}), gradient norms "
             f"{out['vs_gather']['grad_norm_rel_max']:.2e} (bound "
             f"{GRAD_NORM_RTOL})"), flush=True)
    log("phase 22 tile fit", "fitting points equal grid_sample_2d", t)
    for mode, bf16 in (("bf16", True), ("f32", False)):
        for path, c in (("tile", tile), ("gather", conf)):
            t = time.perf_counter()
            cuda = torch.device(dev).type == "cuda"
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            res = train_steps(c, WEIGHTS, batch, draws, dev, bf16,
                              clock_fn(), steps, timed_from)
            res["max_memory_allocated"] = torch.cuda.max_memory_allocated() \
                if cuda else None
            out[f"{path} {mode}"] = res
            med, peak = res["median_ms"], res["max_memory_allocated"]
            print(f"[chip_smoke] train {mode} {path} ({card}): loss "
                  f"{res['losses'][0]:.6f} -> {res['losses'][-1]:.6f}; "
                  f"median step {med['step']:.2f} ms over steps "
                  f"{timed_from}-{steps - 1}: "
                  + ", ".join(f"{k} {med[k]:.2f}" for k in STAGES)
                  + " ms; peak memory " + ("not measured" if peak is None
                                           else f"{peak / 2**30:.2f} GiB"),
                  flush=True)
            log(f"phase 22 train {mode} {path}", "losses finite and "
                "falling", t)
    return out


def demo_phase(dev, card: str, image_model=("kitti_raw", K360_WEIGHTS),
               imgs_run=("exp_synthetic", STEP8400_WEIGHTS),
               reference: str = DEMO_REFERENCE, extra=(),
               timed: int = DEMO_TIMED):
    """Phase 23: gen_img_custom (DEMO_IMAGE, image_model) and gen_imgs
    (imgs_run, DEMO_IMGS_INDICES) through the port on `dev` into a
    temporary directory, each with the jitter_density launches counted
    from 0 (one per depth map) and each launch held against the plain
    version; gen_img_custom's grids held to `reference` (DEMO_* bounds);
    the depth and the profile of the example image timed. Returns (the
    record, {"gen_img_custom": its launch's (args, kwargs), "gen_imgs":
    its first launch's})."""
    import numpy as np
    import torch
    from behindthescenes_tpu_torch import inference
    from behindthescenes_tpu_torch.ops import kernels
    from behindthescenes_tpu_torch.scripts import (gen_img_custom, gen_imgs,
                                                   inference_setup as iset)
    from behindthescenes_tpu_torch.utils.io import read_image
    from behindthescenes_tpu_torch.datasets.png import resize_linear
    out = {"card": card}
    model, checkpoint = image_model
    device = ["--device", str(dev)]
    with tempfile.TemporaryDirectory(prefix="demos_") as tmp:
        t = time.perf_counter()
        kernels.reset_launch_counts()
        with recorded_kernel_args() as (_, state):
            state["mode"], state["calls"] = "gen_img_custom", []
            res = gen_img_custom.main([
                "--img", DEMO_IMAGE, "--model", model, "--checkpoint",
                checkpoint, "--out", os.path.join(tmp, "img"), *device,
                *extra])
            custom_calls = state["calls"]
        custom = kernels.launch_counts()
        written = sorted(os.listdir(os.path.join(tmp, "img")))
        kernels.reset_launch_counts()
        with recorded_kernel_args() as (_, state):
            state["mode"], state["calls"] = "gen_imgs", []
            depths = gen_imgs.main([
                "-cn", imgs_run[0], "--checkpoint", imgs_run[1],
                "--indices", *map(str, DEMO_IMGS_INDICES), "--out",
                os.path.join(tmp, "imgs"), *device, *extra])
            imgs_calls = state["calls"]
        imgs = kernels.launch_counts()
        written_imgs = sorted(os.listdir(os.path.join(tmp, "imgs")))
    n_imgs = len(DEMO_IMGS_INDICES)
    want_custom = {k: 1 if k == "jitter_density" else 0 for k in custom}
    want_imgs = {k: n_imgs if k == "jitter_density" else 0 for k in imgs}
    if custom != want_custom or imgs != want_imgs \
            or len(written) != 3 or len(written_imgs) != 3 * n_imgs:
        raise AssertionError(f"demos: launches {custom} and {imgs} (want "
                             f"{want_custom}, {want_imgs}); files "
                             f"{written}, {written_imgs}")
    errs = [against_plain("jitter_density", name, args, kwargs,
                          f"demo launch {i}")[0]
            for i, (name, args, kwargs) in enumerate(custom_calls
                                                     + imgs_calls)]
    out["launches"] = {"gen_img_custom": custom, "gen_imgs": imgs}
    out["max_abs_err"] = errs
    out["launch_shapes"] = [list(args[0].shape) for _, args, _ in
                            custom_calls + imgs_calls]
    ref = np.load(reference)
    cells = float(np.mean(np.abs(res["profile"] - ref["profile"])
                          <= DEMO_PROFILE_ATOL))
    sigma_rel = float(np.linalg.norm(res["sigma"] - ref["sigma"])
                      / np.linalg.norm(ref["sigma"]))
    ref_depth = ref["depth"].astype(np.float32)
    depth_rel = float(np.median(np.abs(res["depth"] - ref_depth)
                                / ref_depth))
    out["vs_jax"] = {"profile_cells_equal": cells, "sigma_rel": sigma_rel,
                     "depth_median_rel": depth_rel}
    if not (cells >= DEMO_CELLS_EQUAL and sigma_rel <= DEMO_SIGMA_RTOL
            and depth_rel <= DEMO_DEPTH_MEDIAN_REL
            and np.isfinite(res["depth"]).all()
            and all(np.isfinite(d).all() for d, _ in depths)):
        raise AssertionError(f"gen_img_custom vs the JAX demo: "
                             f"{out['vs_jax']}")
    print(f"[chip_smoke] gen_img_custom --model {model} ({card}): "
          f"jitter_density launches {custom['jitter_density']} on "
          f"{out['launch_shapes'][0]} (max abs deviation from the plain "
          f"version {max(errs):.3e}); against the JAX demo on the CPU: "
          f"profile cells within {DEMO_PROFILE_ATOL} {100 * cells:.2f}% "
          f"(min {100 * DEMO_CELLS_EQUAL:.0f}%), sigma relative error "
          f"{sigma_rel:.2e} (max {DEMO_SIGMA_RTOL}), depth median relative "
          f"difference {depth_rel:.2e} (max {DEMO_DEPTH_MEDIAN_REL}); "
          f"gen_imgs -cn {imgs_run[0]}: {imgs['jitter_density']} "
          f"jitter_density launches; {len(written) + len(written_imgs)} "
          "PNGs written", flush=True)
    log("phase 23 demos", "the demos ran through jitter_density and agree "
        "with the JAX demo", t)
    # The example image's depth and profile, timed on the card.
    t = time.perf_counter()
    net, rcfg, config = iset.setup_model(model, checkpoint, device=dev)
    h, w = iset.DEFAULT_RESOLUTION[model]
    img = resize_linear(read_image(DEMO_IMAGE), (h, w))
    mc = config["model_conf"]
    with torch.no_grad():
        grid = iset.encode_image(net, img, *iset.DEFAULT_INTRINSICS[model])
        gen = torch.Generator(device=torch.device(dev))
        gen.manual_seed(0)
        if torch.device(dev).type == "cuda":
            out["depth_ms"] = cuda_ms(lambda: inference.render_depth_selfview(
                net, grid, h, w, rcfg, mc["z_near"], mc["z_far"],
                generator=gen), iters=timed)
            out["profile_ms"] = cuda_ms(lambda: inference.render_profile(
                net, grid), iters=timed)
            out["encode_ms"] = cuda_ms(lambda: iset.encode_image(
                net, img, *iset.DEFAULT_INTRINSICS[model]), iters=timed)
        else:
            out["depth_ms"] = out["profile_ms"] = out["encode_ms"] = None
    fmt = {k: "not measured" if out[k] is None else f"{out[k]:.3f} ms"
           for k in ("depth_ms", "profile_ms", "encode_ms")}
    print(f"[chip_smoke] gen_img_custom frame ({card}), {h}x{w}x"
          f"{rcfg.n_coarse} bf16: depth {fmt['depth_ms']}, BEV profile "
          f"(180 x 180 cells) {fmt['profile_ms']}, encode "
          f"{fmt['encode_ms']}", flush=True)
    log("phase 23 timing", card, t)
    return out, {"gen_img_custom": custom_calls[0][1:],
                 "gen_imgs": imgs_calls[0][1:]}


def parallel_layout(world: int = PARALLEL_WORLD):
    """(backend, each rank's device, what was chosen): NCCL over a card a
    rank where there are enough cards, else gloo with every rank on
    cuda:0."""
    import torch
    n = torch.cuda.device_count()
    if n >= world:
        return "nccl", [f"cuda:{r}" for r in range(world)], \
            f"NCCL, one card a rank ({n} cards)"
    return "gloo", ["cuda:0"] * world, \
        (f"gloo, the {world} ranks share cuda:0 ({n} card; NCCL refuses "
         "two ranks on one card, so its path is not run here)")


def parallel_work(job: dict) -> dict:
    """Phase 24's work (see PARALLEL_WORLD) on this process's rank of the
    launcher's group, or at world 1 where none is joined, on
    job["devices"][rank]. Returns the rank's results, tensors on the
    host."""
    import numpy as np
    import torch
    from behindthescenes_tpu_torch import eval_depth
    from behindthescenes_tpu_torch.ops import kernels
    from behindthescenes_tpu_torch.parallel import mesh
    from behindthescenes_tpu_torch.training.wrapper import draw_rows
    group = mesh.default_group()
    rank, world = mesh.rank_world(group)
    dev = job["devices"][rank]
    conf, weights = job["conf"], job["weights"]
    n = job["batch"]["imgs"].shape[0] // world
    batch = mesh.shard_batch(job["batch"], group)
    draws = draw_rows(job["draws"], rank * n, (rank + 1) * n)
    out = {"rank": rank, "world": world, "device": dev}

    # (a) the f32 step (and at world 1 the same step on images scaled by
    # one ulp: the gradient's own sensitivity), then the bf16 steps.
    scales = {"step": 1.0}
    if world == 1:
        scales["nudged"] = 1.0 + 2.0 ** -23
    for name, scale in scales.items():
        trainer = make_trainer(conf, weights, dev, torch.float32)
        tb, td = on_device(dict(batch, imgs=batch["imgs"] * np.float32(scale)),
                           draws, dev)
        kernels.reset_launch_counts()
        loss = float(trainer.train_step(tb, td)["loss"])
        out[name] = {
            "loss": loss, "launches": kernels.launch_counts(),
            "grads": {k: p.grad.detach().cpu() for k, p in
                      trainer.net.named_parameters() if p.grad is not None},
            "state": {k: v.detach().cpu() for k, v in
                      trainer.net.state_dict().items()}}
        del trainer
    bf16 = train_steps(conf, weights, batch, draws, dev, True,
                       cuda_clock() if dev.startswith("cuda")
                       else host_clock(), steps=job["timed"],
                       timed_from=PARALLEL_TIMED_FROM)
    out["bf16"] = {"median_ms": bf16["median_ms"], "losses": bf16["losses"]}

    # (b) general-path depth and NVS, per frame, in f32.
    net = eval_depth.load_model(job["depth_weights"], device=dev)
    ev = eval_depth.DepthEvaluator(
        net, eval_depth.FLAGSHIP_RENDERER,
        dict(eval_depth.FLAGSHIP_MODEL_CONF, eval_selfview=False))
    gen = torch.Generator(device=dev)
    gen.manual_seed(eval_depth.SEED)
    out["depth_sharded"] = ev.group is not None
    out["depth"] = [ev.evaluate(b, generator=gen) for b in job["scenes"]]
    del net, ev
    name, checkpoint, overrides = job["nvs"]
    _, _, calls = config_eval(name, checkpoint, dev, overrides)
    out["nvs_sharded"] = all(e.group is not None for e, _, _ in calls)
    out["nvs"] = [m for _, _, m in calls]

    # (c) the LiDAR runs, the kernels' launches counted on this rank.
    out["occupancy"] = []
    for _, name, split, keyframes, overrides, record in job["occ_runs"]:
        kernels.reset_launch_counts()
        _, means, calls = config_eval(name, K360_WEIGHTS, dev, (
            f"data.data_path={job['tree']}",
            f"data.pose_path={os.path.join(job['tree'], 'data_poses')}",
            f"data.split_path={os.path.join(job['tree'], split)}",
            "data.is_preprocessed=true", *overrides, *job["occ_extra"]))
        out["occupancy"].append({
            "record": record, "keyframes": len(keyframes), "means": means,
            "launches": kernels.launch_counts(),
            "sharded": all(e.group is not None for e, _, _ in calls)})
    if dev.startswith("cuda"):
        torch.cuda.synchronize(dev)
    return out


def parallel_rank(rank: int, world: int, job: dict) -> dict:  # noqa: ARG001
    """A rank's body for run_ranks."""
    return parallel_work(job)


def parallel_compare(one: dict, ranks: list, lr: float,
                     count_launches: bool) -> dict:
    """Holds every rank to world 1 (see PARALLEL_WORLD); raises where one
    is outside. Returns the worst gaps."""
    import math
    import torch
    gaps = {"loss_rel": 0.0, "grad_over_bound": 0.0,
            "grad_rel_max_without_sensitivity": 0.0, "stats": 0.0,
            "param_max_over_lr": 0.0, "param_moved_share": 0.0,
            "depth_rel": 0.0, "nvs_rel": 0.0, "occupancy": 0.0}
    base, nudged = one["step"], one["nudged"]
    for r, res in enumerate(ranks):
        got = res["step"]
        rel = abs(got["loss"] - base["loss"]) / max(1.0, abs(base["loss"]))
        gaps["loss_rel"] = max(gaps["loss_rel"], rel)
        if not rel <= PARALLEL_LOSS_RTOL:
            raise AssertionError(f"rank {r}: loss {got['loss']} vs world 1 "
                                 f"{base['loss']}")
        if set(got["grads"]) != set(base["grads"]):
            raise AssertionError(f"rank {r}: gradients of other tensors")
        for k, g1 in base["grads"].items():
            g1 = g1.double()
            diff = (got["grads"][k].double() - g1).abs()
            top = g1.abs().max().item()
            plain = PARALLEL_GRAD_RTOL * g1.abs() \
                + PARALLEL_GRAD_ATOL_OF_MAX * top
            bound = plain + (nudged["grads"][k].double() - g1).abs() + 1e-30
            gaps["grad_over_bound"] = max(gaps["grad_over_bound"],
                                          (diff / bound).max().item())
            if top > 0:
                gaps["grad_rel_max_without_sensitivity"] = max(
                    gaps["grad_rel_max_without_sensitivity"],
                    (diff - PARALLEL_GRAD_RTOL * g1.abs()).max().item()
                    / top)
            if not bool((diff <= bound).all()):
                raise AssertionError(f"rank {r}: gradient of {k} outside "
                                     "its bound")
        total = moved = 0
        for k, v in base["state"].items():
            w = got["state"][k]
            if "running_" in k:
                d = ((w.double() - v.double()).abs()
                     / v.double().abs().clamp_min(1.0)).max().item()
                gaps["stats"] = max(gaps["stats"], d)
                if not d <= PARALLEL_STATS_RTOL:
                    raise AssertionError(f"rank {r}: {k} {d:.3e} from "
                                         "world 1")
            elif k in base["grads"]:
                d = (w.double() - v.double()).abs()
                total += d.numel()
                moved += int((d > 0.5 * lr).sum())
                gaps["param_max_over_lr"] = max(gaps["param_max_over_lr"],
                                                d.max().item() / lr)
        gaps["param_moved_share"] = max(gaps["param_moved_share"],
                                        moved / total)
        if not (gaps["param_max_over_lr"] < 3
                and gaps["param_moved_share"] < 5e-3):
            raise AssertionError(f"rank {r}: the step's parameters "
                                 f"{gaps['param_max_over_lr']:.3f} lr and "
                                 f"{gaps['param_moved_share']:.2e} moved "
                                 "from world 1")
        for k, v in ranks[0]["step"]["state"].items():
            if not torch.equal(v, got["state"][k]):
                raise AssertionError(f"rank {r}: {k} differs from rank 0")
        for part in ("depth", "nvs"):
            if not res[f"{part}_sharded"]:
                raise AssertionError(f"rank {r}: {part} was not sharded")
            if len(res[part]) != len(one[part]):
                raise AssertionError(f"rank {r}: {part} frames")
            for i, (a, b) in enumerate(zip(res[part], one[part])):
                for k, want in b.items():
                    rel = abs(a[k] - want) / max(1.0, abs(want))
                    gaps[f"{part}_rel"] = max(gaps[f"{part}_rel"], rel)
                    if not rel <= PARALLEL_METRIC_RTOL:
                        raise AssertionError(
                            f"rank {r}: {part} frame {i} {k} {a[k]} vs "
                            f"world 1 {want}")
        for occ, occ1 in zip(res["occupancy"], one["occupancy"]):
            if not occ["sharded"]:
                raise AssertionError(f"rank {r}: {occ['record']} query "
                                     "was not sharded")
            for k in PARALLEL_OCC_METRICS:
                d = abs(occ["means"][k] - occ1["means"][k])
                gaps["occupancy"] = max(gaps["occupancy"], d)
                if not (math.isfinite(d) and d <= PARALLEL_OCC_ATOL):
                    raise AssertionError(
                        f"rank {r}: {occ['record']} {k} "
                        f"{occ['means'][k]} vs world 1 {occ1['means'][k]}")
            kernel = OCC_RECORDS[occ["record"]]
            want = {k: occ["keyframes"] if k == kernel else 0
                    for k in occ["launches"]}
            if count_launches and occ["launches"] != want:
                raise AssertionError(f"rank {r}: {occ['record']} launches "
                                     f"{occ['launches']}, want {want}")
        if count_launches and any(got["launches"].values()):
            raise AssertionError(f"rank {r}: the train step launched "
                                 f"decode kernels: {got['launches']}")
    return gaps


def parallel_phase(dev, card: str, conf: dict, weights: str,
                   batch: dict, draws, scenes, tree: str,
                   depth_weights: str = WEIGHTS, nvs=(PARALLEL_NVS[0], WEIGHTS,
                                                      PARALLEL_NVS[1]),
                   occ_runs=None, occ_extra=(), layout=None,
                   timed: int = PARALLEL_TIMED,
                   count_launches: bool = True, threads=None) -> dict:
    """Phase 24 (see PARALLEL_WORLD): parallel_work at world 1 on `dev`,
    then on PARALLEL_WORLD ranks laid out by `layout` (backend, devices,
    what; default `parallel_layout()`), each held to world 1 by
    parallel_compare, printing the backend, the world size, the card
    count, the gaps, the timings and each rank's launches beside the
    card. threads: each rank's intra-op threads (None: torch's default).
    Raises where a rank fails or disagrees. Returns the phase's record."""
    import torch
    from behindthescenes_tpu_torch.parallel.launch import run_ranks
    t = time.perf_counter()
    backend, devices, what = layout or parallel_layout()
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(f"[chip_smoke] phase 24 backend {backend}, world "
          f"{PARALLEL_WORLD}, cuda device count {cards}: {what}",
          flush=True)
    job = {"conf": conf, "weights": weights, "batch": batch, "draws": draws,
           "scenes": scenes, "tree": tree, "depth_weights": depth_weights,
           "nvs": nvs, "occ_runs": occ_runs or OCC_RUNS[:2],
           "occ_extra": tuple(occ_extra), "timed": timed}
    one = parallel_work(dict(job, devices=[str(dev)]))
    log("phase 24 world 1", f"on {dev}", t)
    t = time.perf_counter()
    ranks = run_ranks(parallel_rank, PARALLEL_WORLD,
                      (dict(job, devices=devices),), backend=backend,
                      timeout=PARALLEL_TIMEOUT, threads=threads)
    log(f"phase 24 world {PARALLEL_WORLD}", f"{backend} on {devices}", t)
    gaps = parallel_compare(one, ranks, conf.get("learning_rate", 1e-4),
                            count_launches)
    med = {"world 1": one["bf16"]["median_ms"]} | {
        f"world {PARALLEL_WORLD} rank {r}": res["bf16"]["median_ms"]
        for r, res in enumerate(ranks)}
    print(f"[chip_smoke] phase 24 ({card}): world {PARALLEL_WORLD} against "
          "world 1 (" + backend + "): " + ", ".join(
              f"{k} {v:.3e}" for k, v in gaps.items())
          + f"; bf16 step and stage median ms (steps {PARALLEL_TIMED_FROM}"
          f"-{timed - 1}, recorded only) " + json.dumps(
              {k: {s: round(v, 3) for s, v in m.items()}
               for k, m in med.items()})
          + "; LiDAR launches per rank " + json.dumps(
              [[o["launches"] for o in res["occupancy"]] for res in ranks]),
          flush=True)
    return {"backend": backend, "world": PARALLEL_WORLD,
            "device_count": cards, "devices": devices, "gaps": gaps,
            "bf16_step_ms": med,
            "occupancy_means": [o["means"] for o in one["occupancy"]],
            "launches_per_rank": [[o["launches"] for o in res["occupancy"]]
                                  for res in ranks]}


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
    configs, fine, row_launches = config_phases(dev, card, cuda_clock)

    # -- 14, 15: KITTI-360 occupancy on the gate drive ---------------------
    from behindthescenes_tpu_torch.datasets.gen_synthetic_kitti_360 import \
        GATE_FRAMES, make_gate_tree
    # The drive lives until phase 24 has read it too.
    k360_tree = tempfile.TemporaryDirectory(prefix="k360_gate_")
    tree = k360_tree.name
    t = time.perf_counter()
    make_gate_tree(tree)
    write_occupancy_splits(tree, GATE_FRAMES)
    log("phase 14 tree", "the occupancy gate's drive generated and "
        "preprocessed on the host", t)
    occupancy = occupancy_phases(tree, dev, card, cuda_clock)

    # -- 16: the exp_kitti_360 training run on the same drive --------------
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
    t = time.perf_counter()
    for name, (args, kwargs) in row_launches.items():
        kernel, rec, h = KERNEL_ROWS[name]
        res = next(c for c in configs if c["config"] == name)
        piece = shared_z_bf16_piece(h, args[1].shape[0])
        found = [v for k, v in ptxas.items() if piece in k]
        if len(found) != 1:
            raise AssertionError(f"ptxas report: {len(found)} kernels match "
                                 f"{piece}")
        records.append(kernel_record(
            f"{rec}_h{h}", rec, kernel, args, kwargs,
            res["launches"][kernel], max(res["max_abs_err"]), name,
            found[0]))
    log("phase 12 timing", f"{sorted(row_launches)}'s kernel, {card}", t)

    # -- 17: the fast training profiles ------------------------------------
    fast = fast_training_phase(dev, card, cuda_clock)

    # -- 18-20: KITTI raw depth and RealEstate10K NVS, with training -------
    disk, (args, kwargs) = disk_phases(dev, card, cuda_clock)
    t = time.perf_counter()
    kernel, rec, h = KERNEL_ROWS["eval_depth"]
    piece = shared_z_bf16_piece(h, args[1].shape[0])
    found = [v for k, v in ptxas.items() if piece in k]
    if len(found) != 1:
        raise AssertionError(f"ptxas report: {len(found)} kernels match "
                             f"{piece}")
    records.append(kernel_record(
        "shared_z_bf16_kitti_raw", rec, kernel, args, kwargs,
        disk["eval_depth"]["launches"][kernel],
        max(disk["eval_depth"]["max_abs_err"]), "eval_depth", found[0]))
    log("phase 18 timing", f"eval_depth's kernel, {card}", t)

    # -- 21-23: sweep serving, the tile fetch, the image demos -----------
    sweep_res = sweep_phase(dev, card, cuda_clock, {
        c["config"]: c["frame_ms"] for c in configs if "frame_ms" in c})
    tile_res = tile_phase(dev, card, cuda_clock)
    demos, demo_launches = demo_phase(dev, card)
    t = time.perf_counter()
    for script, name, mode in (
            ("gen_img_custom", "jitter_density_demo",
             "gen_img_custom kitti_raw"),
            ("gen_imgs", "jitter_density_demo_h32", "gen_imgs exp_synthetic")):
        args, kwargs = demo_launches[script]
        piece = f"jitter_density_kernelILi{args[1].shape[1]}E"
        found = [v for k, v in ptxas.items() if piece in k]
        if len(found) != 1:
            raise AssertionError(f"ptxas report: {len(found)} kernels match "
                                 f"{piece}")
        records.append(kernel_record(
            name, "jitter_density", "jitter_density", args, kwargs,
            demos["launches"][script]["jitter_density"],
            max(demos["max_abs_err"]), mode, found[0]))
    log("phase 23 kernel timing", f"the demos' kernel, {card}", t)

    # -- 24: two ranks on torch.distributed against one --------------------
    t = time.perf_counter()
    parallel = parallel_phase(dev, card, conf, WEIGHTS, batch, draws,
                              batches, tree)
    k360_tree.cleanup()
    log("phase 24 multi-GPU", f"world {PARALLEL_WORLD} ({parallel['backend']}"
        ") within its bounds of world 1", t)

    print(json.dumps({"frame_ms": frame_ms, "encode_ms": encode_ms,
                      "serving": serving, "general_path": general["means"],
                      "train_parity": parity, "training": training,
                      "configs": configs, "fine_pass": fine,
                      "occupancy": [res for res, _ in occupancy],
                      "k360_training": k360_run, "fast_training": fast,
                      "disk_benchmarks": disk, "sweep": sweep_res,
                      "tile_fetch": tile_res, "demos": demos,
                      "parallel": parallel}),
          flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
