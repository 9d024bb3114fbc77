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
// operations, each at its type's peak, weigh about as much: the products
// (14.1 GFLOP) take 14 us on the bf16 tensor cores, the bf16 add and relu
// (1.0 GFLOP) 7.5 us at the 134 TFLOP/s of bf16 outside the tensor cores,
// the code (0.2 GFLOP) 3 us in f32: 25 us, so the bound is the
// operations. What the card actually spends is instruction throughput on
// the CUDA cores: the 6 precise sincosf of each sample and the bf16
// elementwise chain of each (sample, hidden unit).
//
// Design: both products run on the tensor cores, as the TPU kernel ran
// them on the MXU, with mma.sync m16n8k16 (bf16 in, f32 sums) from
// registers. The hidden width is a template parameter, built for H = 32
// and H = 64 (the widths of the shipped configs whose decoder fuses).
// One warp decodes one ray at a time, in tiles of 16 samples, so h_static
// is the same for every row of a tile; rows past K in a last partial tile
// read c = 0 and store nothing (the bounds checks cost no time measured at
// K = 64 against an unmasked copy of the step for full pairs of tiles,
// whose extra code made ptxas spill). It takes the tiles two at a time,
// so that one tile's trig and mma latencies overlap the other's (a last
// odd tile goes alone).
//  - A = the code, 16 samples x 16 columns, built in registers directly in
//    the A-fragment layout. Lane (g = lane / 4, t = lane % 4) holds rows
//    g and g + 8 and columns 2t, 2t+1, 2t+8, 2t+9. Lanes t = 0, 1, 2 put
//    sin and cos of octaves 2t and 2t+1 there (4 sincosf per lane per
//    tile, no lane repeats another's trig); lanes t = 3 put c in column 6
//    and zeros in 7, 14, 15. W_d's rows are permuted to this column order
//    on the host (ops/kernels/jitter_density.py::mma_code_columns).
//  - B = W_d, 16 x H bf16: H / 8 n = 8 tiles held in registers for the
//    warp's lifetime.
//  - Epilogue on each f32 accumulator fragment: round to bf16x2, + h_static
//    in bf16x2, + b_in and the relu in one fma.rn.relu.bf16x2 (each add
//    rounded; common.cuh::add_relu_bf16x2). The packed m16n8 results
//    of two neighbouring n-tiles are exactly the A fragment of the next
//    m16n8k16, so four more mma against w_out (an n = 8 B tile with only
//    column 0 non-zero) give the density column, summed in f32.
//  - Column 0 of that result lives in lanes t = 0; two shuffles gather a
//    tile's 16 logits into lanes 0-15, which store 64 contiguous bytes.
// Warps walk the rays grid-stride, with as many blocks as are resident.
#include "common.cuh"

namespace {

constexpr int kNF = 6;              // octaves of the z code
constexpr int kTile = 16;           // samples per mma tile (rows of A)
constexpr int kWarps = 4;           // warps per block
constexpr unsigned kFull = 0xffffffffu;

// Weights and per-ray values a lane holds in registers (see the kernel),
// for hidden width kH: kNT n = 8 tiles of the hidden product, kKC k = 16
// chunks of the projection.
template <int kH>
struct LaneWeights {
  static constexpr int kNT = kH / 8;
  static constexpr int kKC = kH / 16;
  uint32_t bw[kNT][2];          // B fragments of W_d
  uint32_t bo[kKC][2];          // B fragments of the projection (w_out)
  uint32_t bin2[kNT];           // b_in at the lane's accumulator columns
  __nv_bfloat162 hs2[kNT];      // h_static of the current ray, likewise
};

// Decodes kT tiles of 16 samples of one ray, starting at sample k0: their
// trig and products are independent, so the warp overlaps their latencies.
// Samples at K and past it are decoded from c = 0 and not stored.
template <int kH, int kT>
__device__ __forceinline__ void decode_tiles(const LaneWeights<kH>& w,
                                             const float* crow, float* orow,
                                             int k0, int K, int lane,
                                             float f_lo, float f_hi,
                                             float bias) {
  constexpr int kKC = LaneWeights<kH>::kKC;
  const int g = lane >> 2, t = lane & 3;
  // A fragments of the code: rows g (sample k0 + 16u + g) and g + 8.
  float c[kT][2];
#pragma unroll
  for (int u = 0; u < kT; ++u) {
    const int k = k0 + kTile * u + g;
    c[u][0] = k < K ? __ldg(crow + k) : 0.0f;
    c[u][1] = k + 8 < K ? __ldg(crow + k + 8) : 0.0f;
  }
  uint32_t a[kT][4];
#pragma unroll
  for (int u = 0; u < kT; ++u) {
    if (t < 3) {
      float s00, c00, s10, c10, s01, c01, s11, c11;
      sincosf(c[u][0] * f_lo, &s00, &c00);
      sincosf(c[u][1] * f_lo, &s10, &c10);
      sincosf(c[u][0] * f_hi, &s01, &c01);
      sincosf(c[u][1] * f_hi, &s11, &c11);
      a[u][0] = pack_bf16(s00, c00);   // row g,     columns 2t, 2t+1
      a[u][1] = pack_bf16(s10, c10);   // row g + 8, columns 2t, 2t+1
      a[u][2] = pack_bf16(s01, c01);   // row g,     columns 2t+8, 2t+9
      a[u][3] = pack_bf16(s11, c11);   // row g + 8, columns 2t+8, 2t+9
    } else {
      a[u][0] = pack_bf16(c[u][0], 0.0f);   // column 6 = c, 7 = pad
      a[u][1] = pack_bf16(c[u][1], 0.0f);
      a[u][2] = 0u;                         // columns 14, 15: pad
      a[u][3] = 0u;
    }
  }
  __syncwarp();                             // mma.sync needs the whole warp
  float o[kT][4];
#pragma unroll
  for (int u = 0; u < kT; ++u) o[u][0] = o[u][1] = o[u][2] = o[u][3] = 0.0f;
#pragma unroll
  for (int kc = 0; kc < kKC; ++kc) {
#pragma unroll
    for (int u = 0; u < kT; ++u) {
      // Hidden units 16 kc .. 16 kc + 15: n-tiles 2 kc and 2 kc + 1.
      uint32_t x[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nt = 2 * kc + half;
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(d, a[u], w.bw[nt][0], w.bw[nt][1]);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(d[0], d[1]);  // g
        const __nv_bfloat162 hi = __floats2bfloat162_rn(d[2], d[3]);  // g+8
        x[2 * half] = add_relu_bf16x2(bits(__hadd2(w.hs2[nt], lo)),
                                      w.bin2[nt]);
        x[2 * half + 1] = add_relu_bf16x2(bits(__hadd2(w.hs2[nt], hi)),
                                          w.bin2[nt]);
      }
      mma_bf16(o[u], x, w.bo[kc][0], w.bo[kc][1]);
    }
  }
  // Column 0: rows g in o[0], rows g + 8 in o[2] of lanes t = 0.
#pragma unroll
  for (int u = 0; u < kT; ++u) {
    const float v_lo = __shfl_sync(kFull, o[u][0], (lane & 7) * 4);
    const float v_hi = __shfl_sync(kFull, o[u][2], (lane & 7) * 4);
    const int k = k0 + kTile * u + lane;
    if (lane < kTile && k < K)
      orow[k] = bf16_round(lane < 8 ? v_lo : v_hi) + bias;
  }
}

template <int kH>
__global__ void __launch_bounds__(kWarps * 32)
jitter_density_kernel(const float* __restrict__ coord,
                      const __nv_bfloat16* __restrict__ hs,
                      const __nv_bfloat16* __restrict__ wd,
                      const __nv_bfloat16* __restrict__ b_in,
                      const __nv_bfloat16* __restrict__ w_out,
                      const float* __restrict__ b_out,
                      float* __restrict__ out, int B, int K,
                      float freq_factor) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  constexpr int kNT = LaneWeights<kH>::kNT;
  constexpr int kKC = LaneWeights<kH>::kKC;
  LaneWeights<kH> w;
  // B fragments of W_d (16 x kH, rows in the code's column order): rows
  // 2t, 2t+1 and 2t+8, 2t+9 of column nt * 8 + g.
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int n = nt * 8 + g;
    w.bw[nt][0] = pack_bf16(wd[(2 * t) * kH + n], wd[(2 * t + 1) * kH + n]);
    w.bw[nt][1] = pack_bf16(wd[(2 * t + 8) * kH + n],
                            wd[(2 * t + 9) * kH + n]);
  }
  // B fragments of the projection: w_out in column 0 (lanes g = 0).
#pragma unroll
  for (int kc = 0; kc < kKC; ++kc) {
    const int j = kc * 16 + 2 * t;
    w.bo[kc][0] = g == 0 ? pack_bf16(w_out[j], w_out[j + 1]) : 0u;
    w.bo[kc][1] = g == 0 ? pack_bf16(w_out[j + 8], w_out[j + 9]) : 0u;
  }
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
    w.bin2[nt] = *reinterpret_cast<const uint32_t*>(b_in + nt * 8 + 2 * t);
  const float bias = *b_out;
  // This lane's two octaves (lanes t = 3 hold c and the pad columns).
  const float f_lo = freq_factor * (float)(1 << (2 * t));
  const float f_hi = freq_factor * (float)(1 << (2 * t + 1));

  const int n_warps = gridDim.x * kWarps;
  for (int ray = blockIdx.x * kWarps + (threadIdx.x >> 5); ray < B;
       ray += n_warps) {
    const __nv_bfloat16* hrow = hs + (size_t)ray * kH;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
      w.hs2[nt] = *reinterpret_cast<const __nv_bfloat162*>(hrow + nt * 8 +
                                                           2 * t);
    const float* crow = coord + (size_t)ray * K;
    float* orow = out + (size_t)ray * K;
    int k0 = 0;
    for (; k0 + kTile < K; k0 += 2 * kTile)
      decode_tiles<kH, 2>(w, crow, orow, k0, K, lane, f_lo, f_hi, bias);
    if (k0 < K)
      decode_tiles<kH, 1>(w, crow, orow, k0, K, lane, f_lo, f_hi, bias);
  }
}

template <int kH>
cudaError_t launch(const void* coord, const void* hs, const void* wd,
                   const void* b_in, const void* w_out, const void* b_out,
                   void* out, int B, int K, float freq_factor,
                   cudaStream_t stream) {
  int blocks = 0;
  const cudaError_t err =
      resident_blocks(jitter_density_kernel<kH>, kWarps * 32, 0,
                      ((long long)B + kWarps - 1) / kWarps, &blocks);
  if (err != cudaSuccess) return err;
  jitter_density_kernel<kH><<<blocks, kWarps * 32, 0, stream>>>(
      (const float*)coord, (const __nv_bfloat16*)hs,
      (const __nv_bfloat16*)wd, (const __nv_bfloat16*)b_in,
      (const __nv_bfloat16*)w_out, (const float*)b_out, (float*)out, B, K,
      freq_factor);
  return cudaGetLastError();
}

// The runtime-shape kernel, for the hidden widths and octave counts the mma
// kernel is not built for (the wrapper picks it from the shapes before the
// launch). It is the first, simple version of this decode, with the
// octave count a runtime value up to kMaxNF: one block per tile of kAnyRays
// rays;
// the tile's h_static rows and the small weights (W_d in the interleaved
// code order, b_in, w_out) sit in shared memory as f32 copies of their
// bf16 values; each thread decodes one (ray, sample) pair at a time, k
// fastest, builds the code in registers (bf16-rounded) and loops over H on
// the f32 CUDA cores with the same rounding points as the mma kernel.
constexpr int kAnyThreads = 256;
constexpr int kAnyRays = 32;
constexpr int kMaxNF = 16;          // code dims up to 1 + 2 * kMaxNF

__global__ void __launch_bounds__(kAnyThreads)
jitter_density_any_kernel(const float* __restrict__ coord,
                          const __nv_bfloat16* __restrict__ hs,
                          const __nv_bfloat16* __restrict__ wd,
                          const __nv_bfloat16* __restrict__ b_in,
                          const __nv_bfloat16* __restrict__ w_out,
                          const float* __restrict__ b_out,
                          float* __restrict__ out, int B, int K, int H,
                          int NF, float freq_factor) {
  const int NC = 1 + 2 * NF;
  extern __shared__ float smem[];
  float* hs_s = smem;                 // kAnyRays x H
  float* wd_s = hs_s + kAnyRays * H;  // NC x H, interleaved code order
  float* bin_s = wd_s + NC * H;       // H
  float* wout_s = bin_s + H;          // H
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kAnyRays;
  const int n_rays = min(kAnyRays, B - b0);

  for (int i = tid; i < n_rays * H; i += kAnyThreads)
    hs_s[i] = __bfloat162float(hs[(size_t)b0 * H + i]);
  for (int i = tid; i < NC * H; i += kAnyThreads)
    wd_s[i] = __bfloat162float(wd[i]);
  for (int j = tid; j < H; j += kAnyThreads) {
    bin_s[j] = __bfloat162float(b_in[j]);
    wout_s[j] = __bfloat162float(w_out[j]);
  }
  __syncthreads();

  const float bias = *b_out;
  for (int p = tid; p < n_rays * K; p += kAnyThreads) {
    const int r = p / K;
    const size_t idx = (size_t)b0 * K + p;
    const float c = coord[idx];
    float code[1 + 2 * kMaxNF];
    code[0] = bf16_round(c);
#pragma unroll
    for (int f = 0; f < kMaxNF; ++f) {
      float sn = 0.0f, cs = 0.0f;
      if (f < NF) sincosf(c * (freq_factor * (float)(1 << f)), &sn, &cs);
      code[1 + 2 * f] = bf16_round(sn);
      code[2 + 2 * f] = bf16_round(cs);
    }
    const float* hrow = hs_s + r * H;
    float acc = 0.0f;
    for (int j = 0; j < H; ++j) {
      float hd = 0.0f;
#pragma unroll
      for (int i = 0; i < 1 + 2 * kMaxNF; ++i)
        if (i < NC) hd = fmaf(code[i], wd_s[i * H + j], hd);
      float x = bf16_round(hrow[j] + bf16_round(hd));
      x = bf16_round(x + bin_s[j]);
      acc = fmaf(fmaxf(x, 0.0f), wout_s[j], acc);
    }
    out[idx] = bf16_round(acc) + bias;
  }
}

}  // namespace

// coord (B, K) f32; hs (B, H) bf16; wd (16, H) bf16, W_d's rows in the
// kernel's code column order with zero pad rows; b_in, w_out (H,) bf16;
// b_out (1,) f32; out (B, K) f32. All contiguous on the device, h_static
// rows and b_in 4-byte aligned. Built for H = 32 and 64 and F = 6, any K;
// other shapes return cudaErrorInvalidValue (the wrapper raises before).
// Returns cudaGetLastError() after the launch.
BTS_EXPORT int bts_jitter_density(const void* coord, const void* hs,
                                  const void* wd, const void* b_in,
                                  const void* w_out, const void* b_out,
                                  void* out, int B, int K, int H, int n_freqs,
                                  float freq_factor, void* stream) {
  if (n_freqs != kNF || B <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (H == 64)
    return (int)launch<64>(coord, hs, wd, b_in, w_out, b_out, out, B, K,
                           freq_factor, s);
  if (H == 32)
    return (int)launch<32>(coord, hs, wd, b_in, w_out, b_out, out, B, K,
                           freq_factor, s);
  return (int)cudaErrorInvalidValue;
}

// As bts_jitter_density, for any H and 1 <= n_freqs <= 16 (the runtime-shape
// kernel), with wd (1 + 2F, H) bf16 in the interleaved code order as the
// model holds it. Returns cudaErrorInvalidValue where the shapes need more
// shared memory than a block takes by default.
BTS_EXPORT int bts_jitter_density_any(const void* coord, const void* hs,
                                      const void* wd, const void* b_in,
                                      const void* w_out, const void* b_out,
                                      void* out, int B, int K, int H,
                                      int n_freqs, float freq_factor,
                                      void* stream) {
  if (n_freqs < 1 || n_freqs > kMaxNF || B <= 0 || K <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(kAnyRays * H + (1 + 2 * n_freqs) * H + 2 * H) * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  jitter_density_any_kernel<<<(B + kAnyRays - 1) / kAnyRays, kAnyThreads,
                              smem, (cudaStream_t)stream>>>(
      (const float*)coord, (const __nv_bfloat16*)hs,
      (const __nv_bfloat16*)wd, (const __nv_bfloat16*)b_in,
      (const __nv_bfloat16*)w_out, (const float*)b_out, (float*)out, B, K, H,
      n_freqs, freq_factor);
  return (int)cudaGetLastError();
}
