// Jittered self-view density decode in f32, per ray b and sample k:
//   sigma[b, k] = softplus(w_out . relu(W_z . code(c[b, k]) + h_static[b]
//                                       + b_in) + b_out)
//   code(c) = [c, sin(f_1 c) .. sin(f_F c), cos(f_1 c) .. cos(f_F c)],
//   f_i = freq_factor * 2^(i-1), F = 6 (13 code dims, grouped order).
//
// Replaces the Pallas kernel behindthescenes_tpu/ops/pallas/selfview.py::
// selfview_density_fused (call at :109, body _kernel at :39-75). In the
// port it serves the jittered decode of f32 models; inference only.
// Everything is f32, sin/cos are the precise sincosf (arguments reach
// 48 rad), softplus is jax.nn.softplus's max(x, 0) + log1p(exp(-|x|)).
//
// What bounds it on an H100: it must read c (B*K f32) and h_static (B*H
// f32) and write sigma (B*K f32): 94 MB at the flagship's B = 122,880,
// K = 64, H = 64, 28 us at 3.35 TB/s. Its 15.3 GFLOP in exact f32 run on
// the CUDA cores (no TF32: the reference is exact f32), 228 us at
// 67 TFLOP/s, so it is bound by operations.
//
// Design: as the bf16 kernel (jitter_density.cu) — one block per tile of
// 32 rays, h_static rows and the small weights in shared memory, threads
// over (ray, sample) pairs with k fastest, the code and the hidden in
// registers only, f32 sums over the 13 code dims and then over H (in four
// interleaved partial sums).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRays = 32;

template <int NF>
__global__ void __launch_bounds__(kThreads)
selfview_density_kernel(const float* __restrict__ hs,
                        const float* __restrict__ coord,
                        const float* __restrict__ wz,
                        const float* __restrict__ b_in,
                        const float* __restrict__ w_out,
                        const float* __restrict__ b_out,
                        float* __restrict__ sigma, int B, int K, int H,
                        float freq_factor) {
  constexpr int NC = 1 + 2 * NF;
  extern __shared__ float smem[];
  float* hs_s = smem;                 // kRays x H
  float* wz_s = hs_s + kRays * H;     // NC x H, grouped code order
  float* bin_s = wz_s + NC * H;       // H
  float* wout_s = bin_s + H;          // H
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kRays;
  const int n_rays = min(kRays, B - b0);

  for (int i = tid; i < n_rays * H; i += kThreads)
    hs_s[i] = hs[(size_t)b0 * H + i];
  for (int i = tid; i < NC * H; i += kThreads) wz_s[i] = wz[i];
  for (int j = tid; j < H; j += kThreads) {
    bin_s[j] = b_in[j];
    wout_s[j] = w_out[j];
  }
  __syncthreads();

  const float bias = *b_out;
  for (int p = tid; p < n_rays * K; p += kThreads) {
    const int r = p / K;
    const size_t idx = (size_t)b0 * K + p;
    const float c = coord[idx];
    float code[NC];
    code[0] = c;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      float s, co;
      sincosf(c * (freq_factor * (float)(1 << f)), &s, &co);
      code[1 + f] = s;
      code[1 + NF + f] = co;
    }
    const float* hrow = hs_s + r * H;
    // Four interleaved partial sums over H (j mod 4), added pairwise:
    // the rounding of the projection stays near one ulp.
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int j0 = 0; j0 < H; j0 += 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + q;
        if (j < H) {
          float h = 0.0f;
#pragma unroll
          for (int i = 0; i < NC; ++i) h = fmaf(code[i], wz_s[i * H + j], h);
          acc[q] = fmaf(fmaxf(h + hrow[j] + bin_s[j], 0.0f), wout_s[j],
                        acc[q]);
        }
      }
    }
    sigma[idx] = softplus_f32(((acc[0] + acc[1]) + (acc[2] + acc[3]))
                              + bias);
  }
}

}  // namespace

static size_t selfview_density_smem(int H, int n_freqs) {
  return (size_t)(kRays * H + (1 + 2 * n_freqs) * H + 2 * H) * sizeof(float);
}

// hs (B, H) f32; coord (B, K) f32; wz (1 + 2F, H) f32 in grouped code order;
// b_in, w_out (H,) f32; b_out (1,) f32; sigma (B, K) f32. All contiguous on
// the device. Only F = 6 is built; other F return cudaErrorInvalidValue.
// Returns cudaGetLastError() after the launch.
BTS_EXPORT int bts_selfview_density(const void* hs, const void* coord,
                                    const void* wz, const void* b_in,
                                    const void* w_out, const void* b_out,
                                    void* sigma, int B, int K, int H,
                                    int n_freqs, float freq_factor,
                                    void* stream) {
  if (n_freqs != 6) return (int)cudaErrorInvalidValue;
  const size_t smem = selfview_density_smem(H, n_freqs);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  selfview_density_kernel<6><<<(B + kRays - 1) / kRays, kThreads, smem,
                               (cudaStream_t)stream>>>(
      (const float*)hs, (const float*)coord, (const float*)wz,
      (const float*)b_in, (const float*)w_out, (const float*)b_out,
      (float*)sigma, B, K, H, freq_factor);
  return (int)cudaGetLastError();
}
