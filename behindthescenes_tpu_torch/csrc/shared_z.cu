// Deterministic self-view decode tail:
//   out[b, k] = sum_j w[j] * relu(hs[b, j] + hd[k, j]) + b_out
// in f32, or with hs and hd in bf16: then hs + hd rounds to bf16 before the
// relu, as shared_z_tail_jnp adds two bf16 arrays (the JAX package's default
// evaluation runs at bf16), and the projection sums in f32.
//
// Replaces the Pallas kernel behindthescenes_tpu/ops/pallas/shared_z.py
// (shared_z_tail -> _tail_pallas, body _kernel at :41-50). hs (B, H) is the
// per-ray static hidden, hd (K, H) the per-sample hidden table that every
// ray shares (one camera-z ladder), D = 1. Inference only, no backward.
//
// What bounds it on an H100: written as plain tensors the (B, K, H)
// rectified sum reaches device memory (2 GB at the flagship's B = 122,880
// rays, K = 64, H = 64). The function itself must only read hs (B*H f32)
// and write out (B*K f32), 63 MB; its 4*B*K*H FLOP (add, max, fused
// multiply-add) on the f32 CUDA cores weigh more (about 30 us at
// 67 TFLOP/s against 19 us for the bytes), so it is bound by operations.
//
// Design: one block per tile of 32 rays. The tile's hs rows, the whole hd
// table (stored transposed, [j][k]) and w sit in shared memory; the
// (B, K, H) intermediate lives only in registers. Threads run along k (64
// lanes, so a warp reads 32 consecutive hd entries and writes 32
// consecutive outputs, and every hs read is a broadcast); each thread
// keeps 8 rays' accumulators in registers and loops over H. Each output
// sums in f32 over four interleaved chains (j mod 4) added pairwise at the
// end, which keeps its rounding near one ulp. The bf16 variant reads half the
// bytes of hs and hd and keeps them in shared memory as f32 copies of their
// bf16 values; the f32 sum of two bf16 values rounded to bf16 is the bf16
// sum (the f32 sum is exact unless the exponents differ by more than 16).
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRays = 32;                        // rays per block
constexpr int kLanes = 64;                       // threads along k
constexpr int kSlots = kThreads / kLanes;        // ray slots per block pass
constexpr int kRaysPerThread = kRays / kSlots;   // rays per thread
constexpr int kParts = 4;                        // partial sums per output

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
shared_z_tail_kernel(const T* __restrict__ hs, const T* __restrict__ hd,
                     const float* __restrict__ w,
                     const float* __restrict__ b_out,
                     float* __restrict__ out, int B, int K, int H) {
  extern __shared__ float smem[];
  float* hs_s = smem;                    // kRays x H
  float* hdT_s = hs_s + kRays * H;       // H x K (transposed)
  float* w_s = hdT_s + H * K;            // H
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kRays;

  for (int i = tid; i < kRays * H; i += kThreads) {
    const int b = b0 + i / H;
    hs_s[i] = b < B ? to_f32(hs[(size_t)b0 * H + i]) : 0.0f;
  }
  // Transpose while loading: consecutive threads write consecutive smem
  // words (no bank conflicts); the strided reads hit the 16 KB table in L1.
  for (int i = tid; i < H * K; i += kThreads) {
    const int j = i / K, k = i % K;
    hdT_s[i] = to_f32(hd[k * H + j]);
  }
  for (int j = tid; j < H; j += kThreads) w_s[j] = w[j];
  __syncthreads();

  const float bias = *b_out;
  const int slot = tid / kLanes;
  for (int k = tid % kLanes; k < K; k += kLanes) {
    // kParts partial sums per output (j mod kParts), added pairwise at
    // the end: a sum of 64 terms run in one chain loses ~3 ulp at the
    // flagship's |out| ~ 34; four chains of 16 keep it near 1 ulp.
    float acc[kRaysPerThread][kParts];
#pragma unroll
    for (int i = 0; i < kRaysPerThread; ++i)
#pragma unroll
      for (int q = 0; q < kParts; ++q) acc[i][q] = 0.0f;
    for (int j0 = 0; j0 < H; j0 += kParts) {
#pragma unroll
      for (int q = 0; q < kParts; ++q) {
        const int j = j0 + q;
        if (j < H) {
          const float d = hdT_s[j * K + k];
          const float wj = w_s[j];
#pragma unroll
          for (int i = 0; i < kRaysPerThread; ++i) {
            float x = hs_s[(slot + i * kSlots) * H + j] + d;
            if constexpr (!std::is_same_v<T, float>) x = bf16_round(x);
            x = fmaxf(x, 0.0f);
            acc[i][q] = fmaf(wj, x, acc[i][q]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRaysPerThread; ++i) {
      const int b = b0 + slot + i * kSlots;
      if (b < B)
        out[(size_t)b * K + k] =
            ((acc[i][0] + acc[i][1]) + (acc[i][2] + acc[i][3])) + bias;
    }
  }
}

}  // namespace

static size_t shared_z_tail_smem(int K, int H) {
  return (size_t)(kRays * H + H * K + H) * sizeof(float);
}

template <typename T>
static int launch_shared_z_tail(const void* hs, const void* hd, const void* w,
                                const void* b_out, void* out, int B, int K,
                                int H, void* stream) {
  const size_t smem = shared_z_tail_smem(K, H);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  shared_z_tail_kernel<T><<<(B + kRays - 1) / kRays, kThreads, smem,
                            (cudaStream_t)stream>>>(
      (const T*)hs, (const T*)hd, (const float*)w, (const float*)b_out,
      (float*)out, B, K, H);
  return (int)cudaGetLastError();
}

// hs (B, H), hd (K, H), w (H,), b_out (1,), out (B, K): f32, contiguous,
// on the device. Returns cudaGetLastError() after the launch.
BTS_EXPORT int bts_shared_z_tail(const void* hs, const void* hd,
                                 const void* w, const void* b_out, void* out,
                                 int B, int K, int H, void* stream) {
  return launch_shared_z_tail<float>(hs, hd, w, b_out, out, B, K, H, stream);
}

// As bts_shared_z_tail with hs and hd in bf16 (w, b_out and out stay f32).
BTS_EXPORT int bts_shared_z_tail_bf16(const void* hs, const void* hd,
                                      const void* w, const void* b_out,
                                      void* out, int B, int K, int H,
                                      void* stream) {
  return launch_shared_z_tail<__nv_bfloat16>(hs, hd, w, b_out, out, B, K, H,
                                             stream);
}

BTS_EXPORT const char* bts_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
