// Shared helpers of the port's CUDA kernels (plain C interface, no PyTorch
// headers: the library is built with one nvcc call and loaded with ctypes).
#pragma once
#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define BTS_EXPORT extern "C" __attribute__((visibility("default")))

// Dynamic shared memory a block may take without opting in to more; a
// launcher whose shapes need more returns cudaErrorInvalidValue.
constexpr size_t kMaxSmem = 48 * 1024;

// Round a float to the nearest bf16 and back (round to nearest even), the
// rounding XLA applies where the JAX reference stores a bf16 result.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// jax.nn.softplus: log(1 + exp(x)) = max(x, 0) + log1p(exp(-|x|)).
__device__ __forceinline__ float softplus_f32(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// The 32 bits of a bf16 pair.
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two floats rounded to bf16, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bits(__floats2bfloat162_rn(lo, hi));
}

// Two bf16 values from memory, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return bits(__halves2bfloat162(lo, hi));
}

// relu(a + c) on two bf16 pairs in one instruction: fma.rn.relu with b = 1
// rounds a * 1 + c = a + c once, to nearest even, and clamps at 0. That is
// bf16(f32(a) + f32(c)), the add of two bf16 arrays in torch and XLA (the
// f32 sum of two bf16 values is exact unless their exponents differ by more
// than 16, and then both round to the larger one), followed by the relu.
__device__ __forceinline__ uint32_t add_relu_bf16x2(uint32_t a, uint32_t c) {
  uint32_t d;
  asm("fma.rn.relu.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(a), "r"(0x3f803f80u), "r"(c));
  return d;
}

// d += a . b on the tensor cores: a 16x16 bf16 (row), b 16x8 bf16 (col),
// d 16x8 f32, in the fragment layouts of the PTX ISA for m16n8k16. Lane
// (g = lane / 4, t = lane % 4) holds a at rows g, g + 8 and columns 2t,
// 2t+1, 2t+8, 2t+9 (a[0]: row g, columns 2t, 2t+1; a[1]: row g + 8; a[2],
// a[3]: the same rows at columns 2t+8, 2t+9), b at rows 2t, 2t+1 (b0) and
// 2t+8, 2t+9 (b1) of column g, and d at rows g (d[0], d[1]) and g + 8
// (d[2], d[3]), columns 2t, 2t+1.
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Blocks of a grid-stride kernel: as many as are resident on the current
// device at once (SMs times blocks per SM), never more than `work_blocks`.
// Returns the CUDA error of a query the runtime refuses.
template <typename Kernel>
inline cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem,
                                   long long work_blocks, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  const long long resident = (long long)sms * per_sm;
  *blocks = (int)(work_blocks < resident ? work_blocks : resident);
  return *blocks > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}
