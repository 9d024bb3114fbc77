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
