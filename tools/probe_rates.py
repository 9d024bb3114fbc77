"""Issue-rate probes of the card for the shared_z kernels' inner loops.

    python3 tools/probe_rates.py        # from the repo root, on the card

Times, with CUDA events, small kernels that run only the arithmetic of one
element of the shared_z decode tail, with no memory traffic, and prints one
JSON line of the measured rates and of the time the flagship shape's work
(B = 122,880 rays, K = 64 samples, H = 64 hidden units) would take at each
rate. A rate is one probe's measurement, not the card's peak:
- `ffma`: fused multiply-adds alone, the card's f32 issue rate;
- `add_relu_fma`: the f32 kernel's element, FADD + FMNMX + FFMA;
- `mma_bf16`: mma.sync m16n8k16 bf16 -> f32, the bf16 kernel's projection
  (one per 16 samples x 16 hidden units);
- `add_relu_bf16x2`: fma.rn.relu.bf16x2, the bf16 kernel's add and relu
  (one per two elements).
The probe source is compiled with nvcc at run time into the port's build
directory, beside the kernel library. Needs one CUDA device. A diagnostic
for PERF.md, on no serving path.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from behindthescenes_tpu_torch.ops.kernels import _build  # noqa: E402

SOURCE = r'''
#include <cstdint>
#include <cuda_runtime.h>
#define EXPORT extern "C" __attribute__((visibility("default")))

// 32 independent chains per thread; `d` moves every step so that nothing
// is hoisted out of the loop.
template <int MODE>
__global__ void __launch_bounds__(128) f32_probe(float* out, float seed,
                                                 int iters) {
  float acc[32], h[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    acc[i] = 0.0f;
    h[i] = seed * (float)(i + 1) - 1.0f;
  }
  float d = seed, w = 1.0001f * seed;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      acc[i] = MODE == 0 ? fmaf(w, h[i], acc[i])
                         : fmaf(w, fmaxf(h[i] + d, 0.0f), acc[i]);
    d += 1e-7f;
  }
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s += acc[i];
  out[blockIdx.x * 128 + threadIdx.x] = s;
}

// 8 independent accumulators per warp.
__global__ void __launch_bounds__(128) mma_probe(float* out, int iters) {
  const uint32_t a0 = threadIdx.x, a1 = threadIdx.x * 3u, a2 = 7u, a3 = 9u;
  const uint32_t b0 = 0x3f803f80u, b1 = threadIdx.x;
  float acc[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};\n"
          : "+f"(acc[i][0]), "+f"(acc[i][1]), "+f"(acc[i][2]),
            "+f"(acc[i][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    s += acc[i][0] + acc[i][1] + acc[i][2] + acc[i][3];
  out[blockIdx.x * 128 + threadIdx.x] = s;
}

// 32 independent pairs per thread, each step adding a moving bf16 pair.
__global__ void __launch_bounds__(128) bf16x2_probe(float* out, int iters) {
  uint32_t x[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = 0x3f803f80u + threadIdx.x + i;
  uint32_t c = 0x3c003c00u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      asm("fma.rn.relu.bf16x2 %0, %1, %2, %3;\n"
          : "=r"(x[i]) : "r"(x[i]), "r"(0x3f803f80u), "r"(c));
    c ^= 0x00010001u;
  }
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) s ^= x[i];
  out[blockIdx.x * 128 + threadIdx.x] = (float)s;
}

EXPORT int probe(int mode, void* out, int blocks, int iters, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0) f32_probe<0><<<blocks, 128, 0, s>>>((float*)out, 0.5f, iters);
  if (mode == 1) f32_probe<1><<<blocks, 128, 0, s>>>((float*)out, 0.5f, iters);
  if (mode == 2) mma_probe<<<blocks, 128, 0, s>>>((float*)out, iters);
  if (mode == 3) bf16x2_probe<<<blocks, 128, 0, s>>>((float*)out, iters);
  return (int)cudaGetLastError();
}
'''

# (name, mode, operations per thread per step, unit)
PROBES = (("ffma", 0, 32, "lane instructions"),
          ("add_relu_fma", 1, 32, "elements"),
          ("mma_bf16", 2, 8 / 32, "warp mma"),
          ("add_relu_bf16x2", 3, 32, "lane instructions"))
# The flagship shape of the shared_z decode tail.
FLAGSHIP_ELEMENTS = 122_880 * 64 * 64


def build() -> ctypes.CDLL:
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "probe_rates.cu")
    lib = os.path.join(_build.BUILD_DIR, "libprobe_rates.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    proc = subprocess.run([_build._nvcc(), *flags, "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {proc.stderr}")
    so = ctypes.CDLL(lib)
    so.probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_int, ctypes.c_void_p]
    so.probe.restype = ctypes.c_int
    return so


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_rates: no CUDA device found")
    so = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = sms * 16, 4096
    out = torch.empty(blocks * 128, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rates = {}
    for name, mode, per_step, unit in PROBES:
        for _ in range(2):
            if so.probe(mode, out.data_ptr(), blocks, iters, stream):
                raise RuntimeError(f"{name}: launch failed")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            so.probe(mode, out.data_ptr(), blocks, iters, stream)
        end.record()
        torch.cuda.synchronize()
        seconds = start.elapsed_time(end) / 5 / 1e3
        rates[name] = {"per_s": blocks * 128 * iters * per_step / seconds,
                       "unit": unit}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "card": card, "rates": rates,
        "flagship_ms_at_rate": {
            "f32_add_relu_fma": FLAGSHIP_ELEMENTS
            / rates["add_relu_fma"]["per_s"] * 1e3,
            "bf16_mma": FLAGSHIP_ELEMENTS / 256
            / rates["mma_bf16"]["per_s"] * 1e3,
            "bf16_add_relu": FLAGSHIP_ELEMENTS / 2
            / rates["add_relu_bf16x2"]["per_s"] * 1e3}}))


if __name__ == "__main__":
    main()
