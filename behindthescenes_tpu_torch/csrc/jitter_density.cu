// Jittered self-view density decode in bf16, per ray b and sample k:
//   logit[b, k] = w_out . relu(h_static[b] + W_d . code(c[b, k]) + b_in)
//                 + b_out
//   code(c) = [c, sin(f_1 c), cos(f_1 c), ..., sin(f_F c), cos(f_F c)],
//   f_i = freq_factor * 2^(i-1), F = 6 (13 code dims, interleaved order).
//
// Replaces the Pallas kernel behindthescenes_tpu/ops/pallas/
// jitter_density.py::jitter_density_pallas (call at :232, body _kernel at
// :98-163). Inference only, no backward; returns logits before softplus.
//
// Rounding: bf16 at the same places as the JAX formulation
// jitter_density_jnp (:166-181): the code, W_d, h_static, b_in and w_out
// are bf16; the code . W_d product is summed in f32 and rounded to bf16;
// h_static + h_dyn and then + b_in are rounded to bf16; the projection is
// summed in f32, rounded to bf16, and b_out is added in f32. sin/cos are
// the precise sincosf (no fast math): arguments reach 1.5 * 2^5 = 48 rad.
//
// What bounds it on an H100: the function must read c (B*K f32) and
// h_static (B*H bf16) and write the logits (B*K f32): 79 MB at the
// flagship's B = 122,880, K = 64, H = 64, about 24 us at 3.35 TB/s. Its
// 15.3 GFLOP would take 15 us on the bf16 tensor cores, so the bound is
// the bytes. Written as plain tensors, the (B, K, 13) code and the
// (B, K, H) hidden reach device memory (about 1.4 GB).
//
// Design (simple first): one block per tile of 32 rays; the tile's
// h_static rows and the small weights (W_d, b_in, w_out) sit in shared
// memory as f32 copies of their bf16 values. Threads run over the tile's
// (ray, sample) pairs with k fastest, so coord loads and logit stores are
// coalesced and each shared-memory read is a broadcast. Each thread builds
// its 13-value code in registers and loops over H on the f32 CUDA cores:
// neither the code nor the hidden leaves registers. The products run on
// CUDA cores, not tensor cores, so the kernel sits far from its byte
// bound; wgmma tiles are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRays = 32;

template <int NF>
__global__ void __launch_bounds__(kThreads)
jitter_density_kernel(const float* __restrict__ coord,
                      const __nv_bfloat16* __restrict__ hs,
                      const __nv_bfloat16* __restrict__ wd,
                      const __nv_bfloat16* __restrict__ b_in,
                      const __nv_bfloat16* __restrict__ w_out,
                      const float* __restrict__ b_out,
                      float* __restrict__ out, int B, int K, int H,
                      float freq_factor) {
  constexpr int NC = 1 + 2 * NF;
  extern __shared__ float smem[];
  float* hs_s = smem;                 // kRays x H
  float* wd_s = hs_s + kRays * H;     // NC x H, interleaved code order
  float* bin_s = wd_s + NC * H;       // H
  float* wout_s = bin_s + H;          // H
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kRays;
  const int n_rays = min(kRays, B - b0);

  for (int i = tid; i < n_rays * H; i += kThreads)
    hs_s[i] = __bfloat162float(hs[(size_t)b0 * H + i]);
  for (int i = tid; i < NC * H; i += kThreads)
    wd_s[i] = __bfloat162float(wd[i]);
  for (int j = tid; j < H; j += kThreads) {
    bin_s[j] = __bfloat162float(b_in[j]);
    wout_s[j] = __bfloat162float(w_out[j]);
  }
  __syncthreads();

  const float bias = *b_out;
  for (int p = tid; p < n_rays * K; p += kThreads) {
    const int r = p / K;
    const size_t idx = (size_t)b0 * K + p;
    const float c = coord[idx];
    float code[NC];
    code[0] = bf16_round(c);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      float s, co;
      sincosf(c * (freq_factor * (float)(1 << f)), &s, &co);
      code[1 + 2 * f] = bf16_round(s);
      code[2 + 2 * f] = bf16_round(co);
    }
    const float* hrow = hs_s + r * H;
    float acc = 0.0f;
    for (int j = 0; j < H; ++j) {
      float hd = 0.0f;
#pragma unroll
      for (int i = 0; i < NC; ++i) hd = fmaf(code[i], wd_s[i * H + j], hd);
      float x = bf16_round(hrow[j] + bf16_round(hd));
      x = bf16_round(x + bin_s[j]);
      acc = fmaf(fmaxf(x, 0.0f), wout_s[j], acc);
    }
    out[idx] = bf16_round(acc) + bias;
  }
}

}  // namespace

static size_t jitter_density_smem(int H, int n_freqs) {
  return (size_t)(kRays * H + (1 + 2 * n_freqs) * H + 2 * H) * sizeof(float);
}

// coord (B, K) f32; hs (B, H) bf16; wd (1 + 2F, H) bf16 in interleaved code
// order; b_in, w_out (H,) bf16; b_out (1,) f32; out (B, K) f32. All
// contiguous on the device. Only F = 6 is built; other F return
// cudaErrorInvalidValue. Returns cudaGetLastError() after the launch.
BTS_EXPORT int bts_jitter_density(const void* coord, const void* hs,
                                  const void* wd, const void* b_in,
                                  const void* w_out, const void* b_out,
                                  void* out, int B, int K, int H, int n_freqs,
                                  float freq_factor, void* stream) {
  if (n_freqs != 6) return (int)cudaErrorInvalidValue;
  const size_t smem = jitter_density_smem(H, n_freqs);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  jitter_density_kernel<6><<<(B + kRays - 1) / kRays, kThreads, smem,
                             (cudaStream_t)stream>>>(
      (const float*)coord, (const __nv_bfloat16*)hs,
      (const __nv_bfloat16*)wd, (const __nv_bfloat16*)b_in,
      (const __nv_bfloat16*)w_out, (const float*)b_out, (float*)out, B, K, H,
      freq_factor);
  return (int)cudaGetLastError();
}
