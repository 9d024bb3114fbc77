// Deterministic self-view decode tail:
//   out[b, k] = sum_j w[j] * relu(hs[b, j] + hd[k, j]) + b_out
// in f32, or with hs, hd and w in bf16: then hs + hd rounds to bf16 before
// the relu, as shared_z_tail_jnp adds two bf16 arrays (the JAX package's
// default evaluation runs at bf16), and the projection sums the products of
// bf16 values in f32.
//
// Replaces the Pallas kernel behindthescenes_tpu/ops/pallas/shared_z.py
// (shared_z_tail -> _tail_pallas, body _kernel at :41-50). hs (B, H) is the
// per-ray static hidden, hd (K, H) the per-sample hidden table that every
// ray shares (one camera-z ladder), D = 1. Inference only, no backward.
// Written as plain tensors the (B, K, H) rectified sum reaches device
// memory (2 GB at the flagship's B = 122,880 rays, K = 64, H = 64); here it
// lives only in registers.
//
// What bounds it on an H100, at the flagship shape:
//  - f32: it must read hs and write out, 63 MB (19 us at 3.35 TB/s); its
//    4*B*K*H FLOP (add, max, fused multiply-add) on the f32 CUDA cores take
//    30 us at 67 TFLOP/s, so it is bound by operations. Counted as
//    instructions it is 3 per element (FADD, FMNMX, FFMA): 1.51 G lane
//    instructions, 45 us at the card's 33.5 T a second. Issued back to
//    back with no memory traffic, the card runs that element at 6.7 T a
//    second (an H100 80GB HBM3 at 700 W, probe_rates.py), which puts a
//    floor of 75 us under any kernel of this formulation.
//  - bf16: it must move 47.2 MB (14 us); the add and relu are 1.0 GFLOP at
//    the 134 TFLOP/s of bf16 outside the tensor cores (7.5 us) and the
//    projection 1.0 GFLOP on the tensor cores (1 us), so it is bound by
//    bytes. Of the tensor cores it uses one column in 8: its 1.97 M
//    mma.sync m16n8k16 take 12.5 us at the 157 G a second that the probe
//    measures, and its 252 M fma.rn.relu.bf16x2 15 us at 16.6 T a second.
//
// f32 design (shared_z_f32_kernel): register tiles on the CUDA cores. A
// block of 128 threads owns a tile of 32 rays by 64 samples; each thread
// owns 4 rays by 4 consecutive samples. The tile's hs rows sit in shared
// memory as [ray][j], a 64-sample chunk of the hd table as [j][k], and w;
// per 4 hidden units a thread reads 4 float4 of hs (one per ray, a
// broadcast within each quarter warp), 4 float4 of hd (one per j, 128
// contiguous bytes per quarter warp, no bank conflicts) and one of w, and
// issues 3 * 4 * 4 * 4 = 192 FP32 instructions: the FP32 pipe, not the
// shared-memory pipe, sets the pace (this kernel reaches about 70% of the
// probe's element rate above). Each output keeps four interleaved
// partial sums over j (j mod 4), added pairwise at the end, which holds its
// rounding near one ulp of the float64 value (a 64-term chain is 1.3e-5
// off at the flagship's |out| ~ 34). The four samples of a thread go out
// as one float4 (a quarter warp writes 128 contiguous bytes). Blocks are
// persistent (as many as are resident) and walk the ray tiles grid-stride,
// so the hd chunk is staged once per block; K longer than 64 is walked in
// chunks, a last partial chunk masked.
//
// bf16 design (shared_z_bf16_kernel): the projection on the tensor cores.
// One warp owns up to four tiles of 16 samples (all 64 at the flagship's K)
// and walks rays. For each ray and tile it builds the 16 x H rectified sum
// directly as the A fragments of mma.sync m16n8k16 (rows: the 16 samples,
// columns: hidden units), one fma.rn.relu.bf16x2 per pair of elements
// (common.cuh::add_relu_bf16x2: the bf16 add and the relu of
// shared_z_tail_jnp, bit for bit); the B fragment holds the bf16 w in
// column 0, so column 0 of the f32 result is the 16 outputs. bf16 products
// are exact in f32; each 16-wide chunk of hidden units sums into its own
// accumulator, and the chunks are added pairwise in f32. The hidden units
// are assigned to the fragment's columns so that lane t of each quad holds
// hs[ray][t*H/4 .. t*H/4 + H/4) (16-byte loads): the sum over j does not
// depend on the order, and w takes the same assignment. The warp keeps its
// samples' hd fragments and the B fragments in registers for all its rays,
// and loads the next ray's hs while it computes the current one; more
// tiles per warp amortise that load and the loop over more work (one tile
// per warp ran markedly slower at the flagship shape). Rows past K in a
// last partial tile hold hd = 0 and are not stored.
//
// Both are built for H = 32 and H = 64 (a template constant: the hidden
// widths of every shipped config). For any other H the wrapper launches the
// runtime-H kernel (shared_z_any_kernel), the first, simple version of this
// kernel: 8 rays per thread, one shared-memory load per element.
#include <type_traits>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------- f32
constexpr int kF32Threads = 128;
constexpr int kKT = 16;                        // threads along k
constexpr int kRT = kF32Threads / kKT;         // threads along rays
constexpr int kTR = 4;                         // rays per thread
constexpr int kTS = 4;                         // samples per thread
constexpr int kTileRays = kRT * kTR;           // 32 rays per tile
constexpr int kChunk = kKT * kTS;              // 64 samples per chunk

template <int kH>
__global__ void __launch_bounds__(kF32Threads, 4)
shared_z_f32_kernel(const float* __restrict__ hs, const float* __restrict__ hd,
                    const float* __restrict__ w,
                    const float* __restrict__ b_out,
                    float* __restrict__ out, int B, int K) {
  __shared__ __align__(16) float hd_s[kH * kChunk];      // [j][k], a chunk
  __shared__ __align__(16) float hs_s[kTileRays * kH];   // [ray][j]
  __shared__ __align__(16) float w_s[kH];
  const int tid = threadIdx.x;
  const int kt = tid % kKT, rt = tid / kKT;
  const int n_tiles = (B + kTileRays - 1) / kTileRays;
  const int n_chunks = (K + kChunk - 1) / kChunk;
  for (int j = tid; j < kH; j += kF32Threads) w_s[j] = w[j];
  const float bias = *b_out;
  const float4* hs4 = reinterpret_cast<const float4*>(hs);
  const float4* hs_s4 = reinterpret_cast<const float4*>(hs_s);
  const float4* hd_s4 = reinterpret_cast<const float4*>(hd_s);
  const float4* w_s4 = reinterpret_cast<const float4*>(w_s);

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int kc0 = ch * kChunk;
    __syncthreads();                   // the last chunk's reads of hd_s
    // Transpose while loading: consecutive threads write consecutive words;
    // the strided reads hit the small table in L1 and L2.
    for (int i = tid; i < kH * kChunk; i += kF32Threads) {
      const int k = kc0 + i % kChunk;
      hd_s[i] = k < K ? hd[(size_t)k * kH + i / kChunk] : 0.0f;
    }
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int b0 = tile * kTileRays;
      __syncthreads();                 // the last tile's reads of hs_s
      for (int i = tid; i < kTileRays * kH / 4; i += kF32Threads) {
        const int b = b0 + i / (kH / 4);
        reinterpret_cast<float4*>(hs_s)[i] =
            b < B ? __ldg(hs4 + (size_t)b0 * (kH / 4) + i)
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      __syncthreads();

      float acc[kTR][kTS][4];
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int s = 0; s < kTS; ++s)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][s][q] = 0.0f;
#pragma unroll
      for (int jc = 0; jc < kH / 4; ++jc) {
        const float4 wv = w_s4[jc];
        const float wq[4] = {wv.x, wv.y, wv.z, wv.w};
        float h[kTR][4];
#pragma unroll
        for (int i = 0; i < kTR; ++i) {
          const float4 v = hs_s4[(rt * kTR + i) * (kH / 4) + jc];
          h[i][0] = v.x; h[i][1] = v.y; h[i][2] = v.z; h[i][3] = v.w;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 v = hd_s4[(4 * jc + q) * (kChunk / 4) + kt];
          const float d[kTS] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int i = 0; i < kTR; ++i)
#pragma unroll
            for (int s = 0; s < kTS; ++s)
              acc[i][s][q] = fmaf(wq[q], fmaxf(h[i][q] + d[s], 0.0f),
                                  acc[i][s][q]);
        }
      }

      const int k = kc0 + kTS * kt;
#pragma unroll
      for (int i = 0; i < kTR; ++i) {
        const int b = b0 + rt * kTR + i;
        if (b >= B) continue;
        float o[kTS];
#pragma unroll
        for (int s = 0; s < kTS; ++s)
          o[s] = ((acc[i][s][0] + acc[i][s][1]) +
                  (acc[i][s][2] + acc[i][s][3])) + bias;
        float* orow = out + (size_t)b * K;
        if (K % kTS == 0 && k + kTS <= K) {
          *reinterpret_cast<float4*>(orow + k) =
              make_float4(o[0], o[1], o[2], o[3]);
        } else {
#pragma unroll
          for (int s = 0; s < kTS; ++s)
            if (k + s < K) orow[k + s] = o[s];
        }
      }
    }
  }
}

// --------------------------------------------------------------- bf16
constexpr int kBfWarps = 4;                    // warps per block
constexpr int kTile = 16;                      // samples per mma tile (rows)

// 32 bits of bf16 pair memory.
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// kT consecutive tiles of 16 samples per warp (the launcher picks kT from
// K: 4 at the flagship's K = 64, so one warp decodes whole rays).
template <int kH, int kT>
__global__ void __launch_bounds__(kBfWarps * 32)
shared_z_bf16_kernel(const __nv_bfloat16* __restrict__ hs,
                     const __nv_bfloat16* __restrict__ hd,
                     const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ b_out,
                     float* __restrict__ out, int B, int K) {
  constexpr int kKC = kH / 16;                 // mma k chunks of 16 units
  constexpr int kQ = kH / 4;                   // hidden units of a lane
  constexpr int kV = kQ / 8;                   // its 16-byte loads per ray
  static_assert(kKC == 2 || kKC == 4, "built for H = 32 and H = 64");
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_groups = (K + kT * kTile - 1) / (kT * kTile);
  const int gw = blockIdx.x * kBfWarps + (threadIdx.x >> 5);
  const int per_group = gridDim.x * kBfWarps / n_groups;  // warps per group
  if (gw >= per_group * n_groups) return;
  const int k0 = (gw % n_groups) * kT * kTile;

  // Tile u, chunk c, lane (g, t): rows k0 + 16u + g and + 8; columns 2t,
  // 2t+1 hold hidden units j = kQ t + 4c, +1 and columns 2t+8, 2t+9 hold
  // j + 2, j + 3.
  uint32_t a_hd[kT][kKC][4], bw[kKC][2];
#pragma unroll
  for (int c = 0; c < kKC; ++c) {
    const int j = kQ * t + 4 * c;
#pragma unroll
    for (int u = 0; u < kT; ++u) {
      const int r0 = k0 + kTile * u + g, r1 = r0 + 8;
      a_hd[u][c][0] = r0 < K ? load_pair(hd + (size_t)r0 * kH + j) : 0u;
      a_hd[u][c][1] = r1 < K ? load_pair(hd + (size_t)r1 * kH + j) : 0u;
      a_hd[u][c][2] = r0 < K ? load_pair(hd + (size_t)r0 * kH + j + 2) : 0u;
      a_hd[u][c][3] = r1 < K ? load_pair(hd + (size_t)r1 * kH + j + 2) : 0u;
    }
    bw[c][0] = g == 0 ? load_pair(w + j) : 0u;        // column 0 only
    bw[c][1] = g == 0 ? load_pair(w + j + 2) : 0u;
  }
  const float bias = *b_out;

  int ray = gw / n_groups;
  uint4 cur[kV];
  if (ray < B) {
#pragma unroll
    for (int v = 0; v < kV; ++v)
      cur[v] = __ldg(reinterpret_cast<const uint4*>(
                         hs + (size_t)ray * kH + kQ * t) + v);
  }
  for (; ray < B; ray += per_group) {
    // The next ray's hs, loaded while this one computes.
    const int next = ray + per_group;
    uint4 nxt[kV];
#pragma unroll
    for (int v = 0; v < kV; ++v)
      nxt[v] = next < B ? __ldg(reinterpret_cast<const uint4*>(
                                    hs + (size_t)next * kH + kQ * t) + v)
                        : cur[v];
    float* orow = out + (size_t)ray * K;
#pragma unroll
    for (int u = 0; u < kT; ++u) {
      float acc[kKC][4];
#pragma unroll
      for (int c = 0; c < kKC; ++c) {
        const uint32_t h_lo = word(cur[(2 * c) / 4], (2 * c) % 4);
        const uint32_t h_hi = word(cur[(2 * c + 1) / 4], (2 * c + 1) % 4);
        const uint32_t a[4] = {add_relu_bf16x2(h_lo, a_hd[u][c][0]),
                               add_relu_bf16x2(h_lo, a_hd[u][c][1]),
                               add_relu_bf16x2(h_hi, a_hd[u][c][2]),
                               add_relu_bf16x2(h_hi, a_hd[u][c][3])};
        acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.0f;
        mma_bf16(acc[c], a, bw[c][0], bw[c][1]);
      }
      if (t == 0) {                    // column 0: rows g (acc 0), g + 8 (2)
        float lo = acc[0][0] + acc[1][0], hi = acc[0][2] + acc[1][2];
        if constexpr (kKC == 4) {
          lo += acc[2][0] + acc[3][0];
          hi += acc[2][2] + acc[3][2];
        }
        const int r0 = k0 + kTile * u + g;
        if (r0 < K) orow[r0] = lo + bias;
        if (r0 + 8 < K) orow[r0 + 8] = hi + bias;
      }
    }
#pragma unroll
    for (int v = 0; v < kV; ++v) cur[v] = nxt[v];
  }
}

// ------------------------------------------------------- any H (runtime)
constexpr int kAnyThreads = 256;
constexpr int kAnyRays = 32;                         // rays per block
constexpr int kLanes = 64;                           // threads along k
constexpr int kSlots = kAnyThreads / kLanes;         // ray slots per pass
constexpr int kRaysPerThread = kAnyRays / kSlots;    // rays per thread
constexpr int kParts = 4;                            // partial sums

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One block per tile of 32 rays; the tile's hs rows, the whole hd table
// (transposed, [j][k]) and w sit in shared memory as f32 (copies of the
// bf16 values for bf16 inputs); threads run along k, each keeps 8 rays'
// accumulators (four interleaved partial sums each) and loops over H. The
// bf16 sum rounds hs + hd to bf16 (the exact bf16 sum) before the relu.
template <typename T>
__global__ void __launch_bounds__(kAnyThreads)
shared_z_any_kernel(const T* __restrict__ hs, const T* __restrict__ hd,
                    const T* __restrict__ w, const float* __restrict__ b_out,
                    float* __restrict__ out, int B, int K, int H) {
  extern __shared__ float smem[];
  float* hs_s = smem;                    // kAnyRays x H
  float* hdT_s = hs_s + kAnyRays * H;    // H x K (transposed)
  float* w_s = hdT_s + H * K;            // H
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kAnyRays;

  for (int i = tid; i < kAnyRays * H; i += kAnyThreads) {
    const int b = b0 + i / H;
    hs_s[i] = b < B ? to_f32(hs[(size_t)b0 * H + i]) : 0.0f;
  }
  for (int i = tid; i < H * K; i += kAnyThreads) {
    const int j = i / K, k = i % K;
    hdT_s[i] = to_f32(hd[k * H + j]);
  }
  for (int j = tid; j < H; j += kAnyThreads) w_s[j] = to_f32(w[j]);
  __syncthreads();

  const float bias = *b_out;
  const int slot = tid / kLanes;
  for (int k = tid % kLanes; k < K; k += kLanes) {
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

template <int kH>
cudaError_t launch_f32(const void* hs, const void* hd, const void* w,
                       const void* b_out, void* out, int B, int K,
                       cudaStream_t stream) {
  int blocks = 0;
  const cudaError_t err =
      resident_blocks(shared_z_f32_kernel<kH>, kF32Threads, 0,
                      ((long long)B + kTileRays - 1) / kTileRays, &blocks);
  if (err != cudaSuccess) return err;
  shared_z_f32_kernel<kH><<<blocks, kF32Threads, 0, stream>>>(
      (const float*)hs, (const float*)hd, (const float*)w,
      (const float*)b_out, (float*)out, B, K);
  return cudaGetLastError();
}

template <int kH, int kT>
cudaError_t launch_bf16(const void* hs, const void* hd, const void* w,
                        const void* b_out, void* out, int B, int K,
                        cudaStream_t stream) {
  // Enough warps for every group of kT sample tiles to get one.
  const long long groups = ((long long)K + kT * kTile - 1) / (kT * kTile);
  int blocks = 0;
  const cudaError_t err =
      resident_blocks(shared_z_bf16_kernel<kH, kT>, kBfWarps * 32, 0,
                      ((long long)B * groups + kBfWarps - 1) / kBfWarps,
                      &blocks);
  if (err != cudaSuccess) return err;
  if ((long long)blocks * kBfWarps < groups) return cudaErrorInvalidValue;
  shared_z_bf16_kernel<kH, kT><<<blocks, kBfWarps * 32, 0, stream>>>(
      (const __nv_bfloat16*)hs, (const __nv_bfloat16*)hd,
      (const __nv_bfloat16*)w, (const float*)b_out, (float*)out, B, K);
  return cudaGetLastError();
}

// Tiles of 16 samples per warp: as many as divide the sample tiles of K,
// up to 4 (more tiles per warp amortise each ray's loads and loop).
template <int kH>
cudaError_t launch_bf16_tiles(const void* hs, const void* hd, const void* w,
                              const void* b_out, void* out, int B, int K,
                              cudaStream_t stream) {
  const int tiles = (K + kTile - 1) / kTile;
  if (tiles % 4 == 0)
    return launch_bf16<kH, 4>(hs, hd, w, b_out, out, B, K, stream);
  if (tiles % 2 == 0)
    return launch_bf16<kH, 2>(hs, hd, w, b_out, out, B, K, stream);
  return launch_bf16<kH, 1>(hs, hd, w, b_out, out, B, K, stream);
}

template <typename T>
int launch_any(const void* hs, const void* hd, const void* w,
               const void* b_out, void* out, int B, int K, int H,
               void* stream) {
  if (B <= 0 || K <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(kAnyRays * H + H * K + H) * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  shared_z_any_kernel<T><<<(B + kAnyRays - 1) / kAnyRays, kAnyThreads, smem,
                           (cudaStream_t)stream>>>(
      (const T*)hs, (const T*)hd, (const T*)w, (const float*)b_out,
      (float*)out, B, K, H);
  return (int)cudaGetLastError();
}

}  // namespace

// hs (B, H), hd (K, H), w (H,), b_out (1,), out (B, K): f32, contiguous,
// on the device, hs 16-byte aligned. Built for H = 32 and 64, any B and K;
// other H return cudaErrorInvalidValue (the wrapper launches
// bts_shared_z_tail_any for them). Returns cudaGetLastError() after the
// launch.
BTS_EXPORT int bts_shared_z_tail(const void* hs, const void* hd,
                                 const void* w, const void* b_out, void* out,
                                 int B, int K, int H, void* stream) {
  if (B <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (H == 64) return (int)launch_f32<64>(hs, hd, w, b_out, out, B, K, s);
  if (H == 32) return (int)launch_f32<32>(hs, hd, w, b_out, out, B, K, s);
  return (int)cudaErrorInvalidValue;
}

// As bts_shared_z_tail with hs, hd and w in bf16 (b_out and out stay f32),
// hs 16-byte and hd and w 4-byte aligned.
BTS_EXPORT int bts_shared_z_tail_bf16(const void* hs, const void* hd,
                                      const void* w, const void* b_out,
                                      void* out, int B, int K, int H,
                                      void* stream) {
  if (B <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (H == 64)
    return (int)launch_bf16_tiles<64>(hs, hd, w, b_out, out, B, K, s);
  if (H == 32)
    return (int)launch_bf16_tiles<32>(hs, hd, w, b_out, out, B, K, s);
  return (int)cudaErrorInvalidValue;
}

// The runtime-H kernel, f32 and bf16 (same arguments, no alignment needed).
// Returns cudaErrorInvalidValue where K * H needs more shared memory than a
// block takes by default.
BTS_EXPORT int bts_shared_z_tail_any(const void* hs, const void* hd,
                                     const void* w, const void* b_out,
                                     void* out, int B, int K, int H,
                                     void* stream) {
  return launch_any<float>(hs, hd, w, b_out, out, B, K, H, stream);
}

BTS_EXPORT int bts_shared_z_tail_any_bf16(const void* hs, const void* hd,
                                          const void* w, const void* b_out,
                                          void* out, int B, int K, int H,
                                          void* stream) {
  return launch_any<__nv_bfloat16>(hs, hd, w, b_out, out, B, K, H, stream);
}

BTS_EXPORT const char* bts_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
