// Shared helpers of the port's CUDA kernels (plain C interface, no PyTorch
// headers: the library is built with one nvcc call and loaded with ctypes).
#pragma once
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
