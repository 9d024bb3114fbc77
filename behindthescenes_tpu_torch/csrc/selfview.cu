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
// 67 TFLOP/s, so it is bound by operations: about 13 * 64 fused
// multiply-adds per sample, plus 6 sincosf.
//
// Design: register tiling on the CUDA cores with the hidden width a
// template parameter, built for H = 32 and H = 64 (the widths of the
// shipped configs whose decoder fuses), so the loops over H unroll and the
// weight reads vectorise: with one sample per thread and H a runtime value,
// every multiply-add pays its own shared-memory load, and an SM serves one
// warp-wide load per clock against four warp-wide FMAs. Each thread decodes
// kS = 4 consecutive samples of one ray: c comes in as one float4 and sigma
// goes out as one float4; the thread walks H in chunks of 4 and reads
// W_z[i][j..j+3] as one float4 from shared memory, which feeds 4 * kS
// multiply-adds (one 16-byte broadcast load per 16 FMAs); the walk over H
// unrolls fully, so every shared-memory offset is an immediate (faster on
// the H100 than unrolling by 2). h_static + b_in starts each FMA chain.
// Each output keeps four interleaved partial sums over j (j mod 4), added
// pairwise at the end, which holds its rounding near one ulp of the
// float64 value. Threads walk the (ray, group of kS samples) space
// grid-stride, with as many blocks as are resident, so the weights are
// staged in shared memory once per block.
#include "common.cuh"

namespace {

constexpr int kNF = 6;              // octaves of the z code
constexpr int kNC = 1 + 2 * kNF;    // code dims
constexpr int kS = 4;               // consecutive samples per thread
constexpr int kThreads = 256;

template <int kH>
__global__ void __launch_bounds__(kThreads, 2)
selfview_density_kernel(const float* __restrict__ hs,
                        const float* __restrict__ coord,
                        const float* __restrict__ wz,
                        const float* __restrict__ b_in,
                        const float* __restrict__ w_out,
                        const float* __restrict__ b_out,
                        float* __restrict__ sigma, long long n_groups,
                        int groups_per_ray, float freq_factor) {
  __shared__ __align__(16) float wz_s[kNC * kH];   // grouped code order
  __shared__ __align__(16) float bin_s[kH];
  __shared__ __align__(16) float wout_s[kH];
  for (int i = threadIdx.x; i < kNC * kH; i += kThreads) wz_s[i] = wz[i];
  for (int j = threadIdx.x; j < kH; j += kThreads) {
    bin_s[j] = b_in[j];
    wout_s[j] = w_out[j];
  }
  __syncthreads();
  const float4* wz4 = reinterpret_cast<const float4*>(wz_s);
  const float4* bin4 = reinterpret_cast<const float4*>(bin_s);
  const float4* wout4 = reinterpret_cast<const float4*>(wout_s);

  const float bias = *b_out;
  for (long long grp = (long long)blockIdx.x * kThreads + threadIdx.x;
       grp < n_groups; grp += (long long)gridDim.x * kThreads) {
    const long long ray = grp / groups_per_ray;
    // K = kS * groups_per_ray, so the group's samples start at kS * grp.
    const float4 c4 = __ldg(reinterpret_cast<const float4*>(coord) + grp);
    const float c[kS] = {c4.x, c4.y, c4.z, c4.w};
    float code[kS][kNC];
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      code[s][0] = c[s];
#pragma unroll
      for (int f = 0; f < kNF; ++f) {
        float sn, cs;
        sincosf(c[s] * (freq_factor * (float)(1 << f)), &sn, &cs);
        code[s][1 + f] = sn;
        code[s][1 + kNF + f] = cs;
      }
    }
    const float4* hrow = reinterpret_cast<const float4*>(hs + ray * kH);
    float acc[kS][4];
#pragma unroll
    for (int s = 0; s < kS; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[s][q] = 0.0f;
#pragma unroll
    for (int jc = 0; jc < kH / 4; ++jc) {
      const float4 h4 = __ldg(hrow + jc);
      const float4 bi = bin4[jc];
      const float base[4] = {h4.x + bi.x, h4.y + bi.y, h4.z + bi.z,
                             h4.w + bi.w};
      float h[kS][4];
#pragma unroll
      for (int s = 0; s < kS; ++s)
#pragma unroll
        for (int q = 0; q < 4; ++q) h[s][q] = base[q];
#pragma unroll
      for (int i = 0; i < kNC; ++i) {
        const float4 w = wz4[i * (kH / 4) + jc];
#pragma unroll
        for (int s = 0; s < kS; ++s) {
          h[s][0] = fmaf(code[s][i], w.x, h[s][0]);
          h[s][1] = fmaf(code[s][i], w.y, h[s][1]);
          h[s][2] = fmaf(code[s][i], w.z, h[s][2]);
          h[s][3] = fmaf(code[s][i], w.w, h[s][3]);
        }
      }
      const float4 wo = wout4[jc];
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        acc[s][0] = fmaf(fmaxf(h[s][0], 0.0f), wo.x, acc[s][0]);
        acc[s][1] = fmaf(fmaxf(h[s][1], 0.0f), wo.y, acc[s][1]);
        acc[s][2] = fmaf(fmaxf(h[s][2], 0.0f), wo.z, acc[s][2]);
        acc[s][3] = fmaf(fmaxf(h[s][3], 0.0f), wo.w, acc[s][3]);
      }
    }
    float o[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s)
      o[s] = softplus_f32(((acc[s][0] + acc[s][1]) + (acc[s][2] + acc[s][3]))
                          + bias);
    reinterpret_cast<float4*>(sigma)[grp] = make_float4(o[0], o[1], o[2],
                                                        o[3]);
  }
}

template <int kH>
cudaError_t launch(const void* hs, const void* coord, const void* wz,
                   const void* b_in, const void* w_out, const void* b_out,
                   void* sigma, int B, int K, float freq_factor,
                   cudaStream_t stream) {
  const long long n_groups = (long long)B * (K / kS);
  int blocks = 0;
  const cudaError_t err =
      resident_blocks(selfview_density_kernel<kH>, kThreads, 0,
                      (n_groups + kThreads - 1) / kThreads, &blocks);
  if (err != cudaSuccess) return err;
  selfview_density_kernel<kH><<<blocks, kThreads, 0, stream>>>(
      (const float*)hs, (const float*)coord, (const float*)wz,
      (const float*)b_in, (const float*)w_out, (const float*)b_out,
      (float*)sigma, n_groups, K / kS, freq_factor);
  return cudaGetLastError();
}

}  // namespace

// hs (B, H) f32; coord (B, K) f32; wz (1 + 2F, H) f32 in grouped code order;
// b_in, w_out (H,) f32; b_out (1,) f32; sigma (B, K) f32. All contiguous on
// the device, h_static and coord 16-byte aligned. Built for H = 32 and 64
// and F = 6 with K a multiple of 4; other shapes return
// cudaErrorInvalidValue (the wrapper raises before). Returns
// cudaGetLastError() after the launch.
BTS_EXPORT int bts_selfview_density(const void* hs, const void* coord,
                                    const void* wz, const void* b_in,
                                    const void* w_out, const void* b_out,
                                    void* sigma, int B, int K, int H,
                                    int n_freqs, float freq_factor,
                                    void* stream) {
  if (n_freqs != kNF || K % kS != 0 || B <= 0 || K <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (H == 64)
    return (int)launch<64>(hs, coord, wz, b_in, w_out, b_out, sigma, B, K,
                           freq_factor, s);
  if (H == 32)
    return (int)launch<32>(hs, coord, wz, b_in, w_out, b_out, sigma, B, K,
                           freq_factor, s);
  return (int)cudaErrorInvalidValue;
}
