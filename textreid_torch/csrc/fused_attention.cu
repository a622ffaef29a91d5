// fused_attention_fwd / fused_attention_bwd: multi-head attention over the
// fused [q | k | v] projection, forward and backward, with the [S, S]
// scores kept out of device memory in both directions.
//
// Replaces: textreid_tpu/ops/attention_pallas.py:fused_attention (K5, body
// _attention_kernel) and :fused_attention_bwd (K6, body
// _attention_bwd_kernel).  Same contract and the same rounding points:
//   forward   s = (q k^T) * scale in f32, causal -inf above the diagonal,
//             m = rowmax(s), e = exp(s - m), l = rowsum(e),
//             o = (e cast to T) v with f32 accumulation, THEN o / l, cast
//             to T;
//   backward  p = e / rowsum(e) in f32, dv = (p cast to T)^T g,
//             dp = g v^T in f32, ds = p (dp - rowsum(dp p)) scale,
//             dq = (ds cast to T) k, dk = (ds cast to T)^T q, all with f32
//             accumulation; masked columns have p = 0, so ds = 0 there.
// qkv is [B, S, 3W] (T = f32 or bf16); head h reads columns h*D, W + h*D
// and 2W + h*D of each row, with no split or transpose.  The forward
// writes [B, S, W]; the backward writes dqkv [B, S, 3W] in the same head
// slabs.  The TPU kernels' pair/fused/split block layouts are Mosaic
// workarounds and have no counterpart here.
//
// Two families of kernels live here.  bf16 inputs, which every training,
// encoding and serving path uses, run on the tensor cores (`*_mma` below).
// f32 inputs (the f32 step check and the int8 calibration pass) keep the
// FP32-core kernels of the first version: TF32 would not hold their 1e-5
// agreement with the plain version.
//
// What bounds the bf16 kernels on the H100: at the ViT-B/16 shape (B=128,
// S=193, H=12, D=64) the forward must move 152 MB (qkv read, out written:
// 45 us at 3.35 TB/s) and do 14.6 GFLOP (15 us at the tensor cores' bf16
// peak), so bytes bind; the backward moves 266 MB (79 us).  The first
// version ran every product as f32 FMAs and staged a head's K and V once
// per 64-row query tile, element by element: 1.34 ms forward and 4.58 ms
// backward.  Measured now (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py):
// forward 0.111 ms, backward 0.322 ms, against 0.094-0.105 and 0.342-0.369
// ms for scaled_dot_product_attention and its autograd backward; at the
// served causal text shape (B=256, S=100, W=512) 0.050 and 0.117 ms
// against 0.049 and 0.215.  The copies alone take 0.041 ms of the forward
// (tools/attention_variants.py), so what is left is the work inside an SM:
// the tensor pipe, the ldmatrix reads (one x4 load feeds only two mma, as a
// warp owns one 16-row tile), the softmax's ALU work and its exp (one
// special-function result a lane a clock: 19 us of the forward) each take
// 20-40 us, and with 8 warps an SM (the score row in registers costs ~200 a
// thread) they overlap only partly.
//
// Design of the bf16 kernels, and why:
// * One block per (sample, head): 1,536 blocks at the ViT shape.  Q, K, V
//   (and G in the backward) of the head are each read from device memory
//   once, by `cp.async` in 16-byte pieces (a head's row is 128 contiguous
//   bytes at D=64), into shared memory rows padded with zeros to whole
//   groups of four 16-key tiles.  Forward: 3 x 208 x 128 B = 80 KB at
//   S=193, two blocks an SM, so one block's copies overlap the other's
//   products; K and Q are committed first and QK^T of a warp's first row
//   tile runs while V is in flight.  cp.async was taken over TMA: the rows
//   are short, the box would run past a sample's last row into the next
//   sample, and a tensor map would have to be encoded at run time.
// * Shared memory is XOR-swizzled (the 16-byte piece c of row r sits at
//   piece c ^ (r & 7) at D=64, c ^ ((r >> 1) & 3) at D=32), so the eight
//   row addresses of every `ldmatrix` fall in eight different bank groups,
//   plain or transposed, with no padding.
// * Every product is `mma.sync.m16n8k16` on bf16 with f32 accumulators.  A
//   warp owns 16 query rows and keeps their whole score row in accumulator
//   registers (8 f32 a thread per 16 keys: 104 at S=193, 144 at S=288), so
//   the softmax is the whole-row softmax of the contract (max, exp, sum,
//   cast to bf16, divide after the product), not an online one.  The
//   accumulator layout of QK^T is the A-operand layout of PV, so the
//   probabilities go from one product to the next in registers.  mma.sync
//   was taken over wgmma because its 16-row tile pads S=193 to 208 where a
//   64-row tile pads to 256, and the work is bound by bytes.  The kernels
//   are instantiated for 7, 13 and 18 key tiles (S <= 112, 208, 288) so the
//   ViT and text shapes do not pay S=288's registers (200 and 240 a thread,
//   forward and backward, at 13 tiles; no instantiation spills).
// * The loops over key tiles are unrolled (the score registers need
//   constant indices), and how they are guarded decides the speed: with a
//   guard per tile (`if (kt < kt_hi)`) no load or mma moves across a tile
//   boundary and the first build took 0.260 / 0.564 ms.  So tiles go in
//   groups of four under one guard, and a forward row tile that sees every
//   key tile of the instantiation takes a copy with no guards at all (in the
//   backward that copy spills, so it is left out).
// * Backward, one launch, no scratch in device memory.  Phase 1 (a warp per
//   16 query rows): S and the normalised p in registers, then dP tile by
//   tile for delta = rowsum(dP p), then dP again for dS and dQ = dS K; each
//   row's (max, 1/sum, delta) goes to shared memory.  Phase 2, after one
//   __syncthreads (a warp per 16 keys): S^T = K Q^T and dP^T = V G^T tile by
//   tile, p and dS rebuilt from the row statistics, dV += P^T G and
//   dK += dS^T Q in registers.  That is eight products: one more than the
//   two passes of the first version, because delta needs a whole row of dP
//   before any dS exists and S=288 columns of both p and dP do not fit a
//   thread's 255 registers.  Five products would need dQ summed across
//   warps in 53-74 KB of f32 shared memory, which halves the blocks an SM
//   holds at S=193.  Each block owns all outputs of its head: no atomics.
// * Causal: a row tile stops at the group holding its diagonal (forward,
//   phase 1), a key tile starts at its own row tile (phase 2); inside the
//   diagonal tile, past S, and in padded rows, masked scores are -inf
//   before the max (p = 0 exactly; key 0 is visible to every row, so no
//   row's max is -inf and nothing is NaN).
// * Epilogues: the four threads that share an output row swap 4-byte
//   pieces by shuffle so that each stores 16 contiguous bytes.
// * f32-level freedoms taken: p = exp(s - m) * (1 / l) instead of a
//   division, and exp as 2^((s - m) log2 e) on the special-function unit;
//   both are within an f32 ulp or two, far under the bf16 roundings the
//   contract fixes.
//
// The f32 kernels (first version, unchanged): one block (8 warps) per
// (query tile of 64 rows, head, sample), K and V of the head in shared
// memory with an odd-word row stride, a warp carries 4 query rows with
// lane j holding the scores of keys j, j+32, ... (S <= 288 = 9 chunks);
// the backward is two launches that hand each row's (max, sum, delta)
// over through a [B, H, S, 4] f32 scratch.
// Limits, both families: head_dim 32 or 64, 1 <= S <= 288 (ViT-L/14 at 224
// is S=257).  Shared memory, worst case: bf16 backward at S=288, D=64,
// 151 KB; f32 pass 2 186 KB, of the 227 KB a block may use.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 4;                    // rows a warp carries at once
constexpr int kRowsPerWarp = 8;              // two groups per warp
constexpr int kTile = kWarps * kRowsPerWarp; // rows per block
constexpr int kChunks = 9;                   // 32 keys per chunk
constexpr int kMaxSeq = kChunks * 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
// v rounded to T and back: the kernels' casts of p and ds
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return make_float2(p[0], p[1]);
}

// Row stride of a staged [rows, D] matrix: an odd number of 32-bit words.
template <typename T, int D> __host__ __device__ constexpr int padded_ld() {
  return sizeof(T) == 4 ? D + 1 : D + 2;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// dst[r, c] (stride LD, type T) = src[r * stride + c] for r < rows, zero
// for rows <= r < padded_rows.
template <typename T, int D>
__device__ void stage(T* dst, const T* src, long stride, int rows,
                      int padded_rows) {
  constexpr int LD = padded_ld<T, D>();
  for (int idx = threadIdx.x; idx < padded_rows * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    dst[r * LD + c] = r < rows ? src[r * stride + c] : zero<T>();
  }
}

// dst[r, c] (f32, stride D) for the kTile rows of a tile, zero past rows.
template <typename T, int D>
__device__ void stage_tile(float* dst, const T* src, long stride, int rows) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    dst[idx] = r < rows ? to_float(src[r * stride + c]) : 0.f;
  }
}

// acc[r][c] = sum_d a[r][d] * m[lane + 32 c][d] for chunks c_lo <= c < c_hi
// (others 0): a warp's kGroup rows of a (f32 [kGroup][D], broadcast)
// against the staged rows of m, one row per lane and chunk.
template <typename T, int D>
__device__ __forceinline__ void dots(const float* a, const T* m, int c_lo,
                                     int c_hi, float (&acc)[kGroup][kChunks]) {
  constexpr int LD = padded_ld<T, D>();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kGroup; ++r)
#pragma unroll
    for (int c = 0; c < kChunks; ++c) acc[r][c] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 2) {
    float2 av[kGroup];
#pragma unroll
    for (int r = 0; r < kGroup; ++r)
      av[r] = *reinterpret_cast<const float2*>(a + r * D + d);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (c >= c_lo && c < c_hi) {
        const float2 mv = load_pair(m + (lane + 32 * c) * LD + d);
#pragma unroll
        for (int r = 0; r < kGroup; ++r)
          acc[r][c] = fmaf(av[r].y, mv.y, fmaf(av[r].x, mv.x, acc[r][c]));
      }
    }
  }
}

// acc[r][e] = sum_j w[r][j] * m[j][lane + 32 e] over the rows j of chunks
// c_lo <= c < c_hi, where lane l of chunk c holds w[r][32 c + l].
template <typename T, int D>
__device__ __forceinline__ void weighted_rows(
    const float (&w)[kGroup][kChunks], const T* m, int c_lo, int c_hi,
    float (&acc)[kGroup][D / 32]) {
  constexpr int LD = padded_ld<T, D>();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kGroup; ++r)
#pragma unroll
    for (int e = 0; e < D / 32; ++e) acc[r][e] = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (c >= c_lo && c < c_hi) {  // uniform across the warp
#pragma unroll 4
      for (int src = 0; src < 32; ++src) {
        float wv[kGroup];
#pragma unroll
        for (int r = 0; r < kGroup; ++r)
          wv[r] = __shfl_sync(kFull, w[r][c], src);
        const T* row = m + (32 * c + src) * LD;
#pragma unroll
        for (int e = 0; e < D / 32; ++e) {
          const float mv = to_float(row[lane + 32 * e]);
#pragma unroll
          for (int r = 0; r < kGroup; ++r) acc[r][e] = fmaf(wv[r], mv, acc[r][e]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- forward

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    attention_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                         int seq, int width, float scale, int causal) {
  constexpr int LD = padded_ld<T, D>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int s_pad = (seq + 31) / 32 * 32;
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + s_pad * LD;
  float* q_t = reinterpret_cast<float*>(v_s + s_pad * LD);

  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kTile;
  const long stride = 3L * width;
  const T* base = qkv + static_cast<long>(b) * seq * stride;
  stage<T, D>(k_s, base + width + h * D, stride, seq, s_pad);
  stage<T, D>(v_s, base + 2 * width + h * D, stride, seq, s_pad);
  stage_tile<T, D>(q_t, base + row0 * stride + h * D, stride,
                   min(kTile, seq - row0));
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_chunks = s_pad / 32;
  for (int grp = 0; grp < kRowsPerWarp / kGroup; ++grp) {
    const int local = warp * kRowsPerWarp + grp * kGroup;
    const int i0 = row0 + local;
    if (i0 >= seq) break;
    const int c_hi =
        causal ? min(n_chunks, (i0 + kGroup - 1) / 32 + 1) : n_chunks;
    float s[kGroup][kChunks];
    dots<T, D>(q_t + local * D, k_s, 0, c_hi, s);
    float l[kGroup];
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      float m = -INFINITY;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int j = lane + 32 * c;
        const bool ok = c < c_hi && j < seq && !(causal && j > i0 + r);
        s[r][c] = ok ? __fmul_rn(s[r][c], scale) : -INFINITY;
        m = fmaxf(m, s[r][c]);
      }
      m = warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float e = expf(s[r][c] - m);
        sum += e;
        s[r][c] = round_to<T>(e);  // p cast to v's dtype before PV
      }
      l[r] = warp_sum(sum);
    }
    float o[kGroup][D / 32];
    weighted_rows<T, D>(s, v_s, 0, c_hi, o);
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      const int i = i0 + r;
      if (i >= seq) break;
      T* dst = out + (static_cast<long>(b) * seq + i) * width + h * D;
#pragma unroll
      for (int e = 0; e < D / 32; ++e) store(dst + lane + 32 * e, o[r][e] / l[r]);
    }
  }
}

// ------------------------------------------------- backward pass 1: dq

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    attention_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ g,
                            T* __restrict__ dqkv, float* __restrict__ stats,
                            int seq, int width, int heads, float scale,
                            int causal) {
  constexpr int LD = padded_ld<T, D>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int s_pad = (seq + 31) / 32 * 32;
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + s_pad * LD;
  float* q_t = reinterpret_cast<float*>(v_s + s_pad * LD);
  float* g_t = q_t + kTile * D;

  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kTile;
  const long stride = 3L * width;
  const T* base = qkv + static_cast<long>(b) * seq * stride;
  const T* g_base = g + static_cast<long>(b) * seq * width;
  const int rows = min(kTile, seq - row0);
  stage<T, D>(k_s, base + width + h * D, stride, seq, s_pad);
  stage<T, D>(v_s, base + 2 * width + h * D, stride, seq, s_pad);
  stage_tile<T, D>(q_t, base + row0 * stride + h * D, stride, rows);
  stage_tile<T, D>(g_t, g_base + static_cast<long>(row0) * width + h * D,
                   width, rows);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_chunks = s_pad / 32;
  float* st = stats + (static_cast<long>(b) * heads + h) * seq * 4;
  for (int grp = 0; grp < kRowsPerWarp / kGroup; ++grp) {
    const int local = warp * kRowsPerWarp + grp * kGroup;
    const int i0 = row0 + local;
    if (i0 >= seq) break;
    const int c_hi =
        causal ? min(n_chunks, (i0 + kGroup - 1) / 32 + 1) : n_chunks;
    float p[kGroup][kChunks], dp[kGroup][kChunks];
    dots<T, D>(q_t + local * D, k_s, 0, c_hi, p);
    dots<T, D>(g_t + local * D, v_s, 0, c_hi, dp);
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      float m = -INFINITY;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int j = lane + 32 * c;
        const bool ok = c < c_hi && j < seq && !(causal && j > i0 + r);
        p[r][c] = ok ? __fmul_rn(p[r][c], scale) : -INFINITY;
        m = fmaxf(m, p[r][c]);
      }
      m = warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        p[r][c] = expf(p[r][c] - m);
        sum += p[r][c];
      }
      const float l = warp_sum(sum);
      float pdp = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        p[r][c] = p[r][c] / l;
        pdp += dp[r][c] * p[r][c];
      }
      const float delta = warp_sum(pdp);
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        dp[r][c] = round_to<T>(p[r][c] * (dp[r][c] - delta) * scale);
      if (lane == 0 && i0 + r < seq) {
        float* row = st + (i0 + r) * 4;
        row[0] = m;
        row[1] = l;
        row[2] = delta;
      }
    }
    float dq[kGroup][D / 32];
    weighted_rows<T, D>(dp, k_s, 0, c_hi, dq);
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      const int i = i0 + r;
      if (i >= seq) break;
      T* dst = dqkv + (static_cast<long>(b) * seq + i) * 3 * width + h * D;
#pragma unroll
      for (int e = 0; e < D / 32; ++e) store(dst + lane + 32 * e, dq[r][e]);
    }
  }
}

// --------------------------------------------- backward pass 2: dk, dv

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    attention_bwd_dkv_kernel(const T* __restrict__ qkv,
                             const T* __restrict__ g,
                             const float* __restrict__ stats,
                             T* __restrict__ dqkv, int seq, int width,
                             int heads, float scale, int causal) {
  constexpr int LD = padded_ld<T, D>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int s_pad = (seq + 31) / 32 * 32;
  T* q_s = reinterpret_cast<T*>(smem);
  T* g_s = q_s + s_pad * LD;
  float* k_t = reinterpret_cast<float*>(g_s + s_pad * LD);
  float* v_t = k_t + kTile * D;
  float* m_s = v_t + kTile * D;
  float* l_s = m_s + s_pad;
  float* delta_s = l_s + s_pad;

  const int b = blockIdx.z, h = blockIdx.y, col0 = blockIdx.x * kTile;
  const long stride = 3L * width;
  const T* base = qkv + static_cast<long>(b) * seq * stride;
  const int cols = min(kTile, seq - col0);
  stage<T, D>(q_s, base + h * D, stride, seq, s_pad);
  stage<T, D>(g_s, g + static_cast<long>(b) * seq * width + h * D, width, seq,
              s_pad);
  stage_tile<T, D>(k_t, base + col0 * stride + width + h * D, stride, cols);
  stage_tile<T, D>(v_t, base + col0 * stride + 2 * width + h * D, stride,
                   cols);
  const float* st = stats + (static_cast<long>(b) * heads + h) * seq * 4;
  for (int i = threadIdx.x; i < s_pad; i += kThreads) {
    const bool ok = i < seq;
    m_s[i] = ok ? st[i * 4] : 0.f;
    l_s[i] = ok ? st[i * 4 + 1] : 1.f;
    delta_s[i] = ok ? st[i * 4 + 2] : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_chunks = s_pad / 32;
  for (int grp = 0; grp < kRowsPerWarp / kGroup; ++grp) {
    const int local = warp * kRowsPerWarp + grp * kGroup;
    const int j0 = col0 + local;
    if (j0 >= seq) break;
    const int c_lo = causal ? j0 / 32 : 0;  // rows i < j0 see no key j >= j0
    float p[kGroup][kChunks], ds[kGroup][kChunks];
    dots<T, D>(k_t + local * D, q_s, c_lo, n_chunks, p);
    dots<T, D>(v_t + local * D, g_s, c_lo, n_chunks, ds);
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int i = lane + 32 * c;
        const bool ok = c >= c_lo && c < n_chunks && i < seq &&
                        !(causal && j0 + r > i);
        const int ii = min(i, s_pad - 1);
        const float pv = ok ? expf(__fmul_rn(p[r][c], scale) - m_s[ii]) / l_s[ii] : 0.f;
        ds[r][c] = round_to<T>(pv * (ds[r][c] - delta_s[ii]) * scale);
        p[r][c] = round_to<T>(pv);
      }
    }
    float dk[kGroup][D / 32], dv[kGroup][D / 32];
    weighted_rows<T, D>(p, g_s, c_lo, n_chunks, dv);
    weighted_rows<T, D>(ds, q_s, c_lo, n_chunks, dk);
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      const int j = j0 + r;
      if (j >= seq) break;
      T* dst = dqkv + (static_cast<long>(b) * seq + j) * 3 * width + h * D;
#pragma unroll
      for (int e = 0; e < D / 32; ++e) {
        store(dst + width + lane + 32 * e, dk[r][e]);
        store(dst + 2 * width + lane + 32 * e, dv[r][e]);
      }
    }
  }
}

// ===================================================== bf16: tensor cores

using bf16 = __nv_bfloat16;

constexpr int kKeyTile = 16;  // keys (and query rows) per mma tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// c += a b: a is 16x16 (row), b 16x8 (col), c 16x8, bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two f32 rounded to bf16, lo in the low half: one register of a fragment
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

constexpr float kLog2e = 1.4426950408889634f;
// 2^x on the special-function unit; 2^-inf = 0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Element offset of the 16-byte piece `piece` of row `row` in a staged
// [rows, D] bf16 matrix: XOR-swizzled so that 8 consecutive rows of one
// piece lie in 8 different bank groups.
template <int D> __device__ __forceinline__ int swizzled(int row, int piece) {
  const int x = D == 64 ? (row & 7) : ((row >> 1) & 3);
  return row * D + ((piece ^ x) << 3);
}

// dst (swizzled [s_pad, D]) = the head's rows of src, zero past seq.  The
// copies are asynchronous: commit and wait outside.
template <int D>
__device__ __forceinline__ void stage_async(bf16* dst, const bf16* src,
                                            long stride, int seq, int s_pad) {
  constexpr int kPieces = D / 8;
  for (int idx = threadIdx.x; idx < s_pad * kPieces; idx += blockDim.x) {
    const int r = idx / kPieces, c = idx % kPieces;
    bf16* d = dst + swizzled<D>(r, c);
    if (r < seq)
      cp_async16(d, src + r * stride + c * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// A operand: rows row0..row0+15 of a staged matrix, all D/16 k-steps.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], uint32_t base,
                                       int row0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    ldmatrix_x4(a[ks], base + 2 * swizzled<D>(row0 + (lane & 15),
                                              2 * ks + (lane >> 4)));
}
// B operand of x m^T for 16 rows of m (two n-tiles of 8) at k-step ks:
// b[0], b[1] belong to rows row0..+7, b[2], b[3] to rows row0+8..+15.
template <int D>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], uint32_t base,
                                       int row0, int ks) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(b, base + 2 * swizzled<D>(row0 + (lane & 7) + ((lane >> 4) << 3),
                                        2 * ks + ((lane >> 3) & 1)));
}
// B operand of x m for the 16 rows row0.. of m (the k dimension) and its
// columns 16 nc..16 nc + 15: b[0], b[1] the first n-tile, b[2], b[3] the
// second.
template <int D>
__device__ __forceinline__ void load_bt(uint32_t (&b)[4], uint32_t base,
                                        int row0, int nc) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(
      b, base + 2 * swizzled<D>(row0 + (lane & 15), 2 * nc + (lane >> 4)));
}

// acc (two n-tiles) = a (16 rows, all of D) times the transpose of the 16
// rows row0.. of the staged matrix at base.
template <int D>
__device__ __forceinline__ void tile_abt(float (&acc0)[4], float (&acc1)[4],
                                         const uint32_t (&a)[D / 16][4],
                                         uint32_t base, int row0) {
#pragma unroll
  for (int j = 0; j < 4; ++j) acc0[j] = acc1[j] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t b[4];
    load_b<D>(b, base, row0, ks);
    mma_bf16(acc0, a[ks], b[0], b[1]);
    mma_bf16(acc1, a[ks], b[2], b[3]);
  }
}
// acc [16, D] += a (16 x 16, from registers) times the 16 rows row0.. of
// the staged matrix at base.
template <int D>
__device__ __forceinline__ void tile_ab(float (&acc)[D / 8][4],
                                        const uint32_t (&a)[4], uint32_t base,
                                        int row0) {
#pragma unroll
  for (int nc = 0; nc < D / 16; ++nc) {
    uint32_t b[4];
    load_bt<D>(b, base, row0, nc);
    mma_bf16(acc[2 * nc], a, b[0], b[1]);
    mma_bf16(acc[2 * nc + 1], a, b[2], b[3]);
  }
}

// The four threads of a quad each hold v[0..3]; afterwards thread t holds
// in v[a] what thread a held in v[t].
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int t) {
  const bool odd = t & 1, high = t & 2;
  uint32_t r;
  r = __shfl_xor_sync(kFull, odd ? v[0] : v[1], 1);
  if (odd) v[0] = r; else v[1] = r;
  r = __shfl_xor_sync(kFull, odd ? v[2] : v[3], 1);
  if (odd) v[2] = r; else v[3] = r;
  r = __shfl_xor_sync(kFull, high ? v[0] : v[2], 2);
  if (high) v[0] = r; else v[2] = r;
  r = __shfl_xor_sync(kFull, high ? v[1] : v[3], 2);
  if (high) v[1] = r; else v[3] = r;
}

// Store a warp's [16, D] accumulator tile, times mul0 (rows g) and mul1
// (rows g + 8), as bf16 rows row0.. of dst (row stride `stride`, rows past
// seq dropped).  A quad swaps its 4-byte pieces so that each thread stores
// 16 contiguous bytes.
template <int D>
__device__ __forceinline__ void store_tile(bf16* dst, long stride,
                                           const float (&acc)[D / 8][4],
                                           float mul0, float mul1, int row0,
                                           int seq) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    const float mul = half ? mul1 : mul0;
#pragma unroll
    for (int blk = 0; blk < D / 32; ++blk) {
      uint32_t v[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        v[a] = pack_bf16(acc[a + 4 * blk][2 * half] * mul,
                         acc[a + 4 * blk][2 * half + 1] * mul);
      quad_transpose(v, t);
      if (row < seq)
        *reinterpret_cast<uint4*>(dst + row * stride + (t + 4 * blk) * 8) =
            make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// Key tiles are walked in groups of kTileGroup under one guard: inside a
// group nothing branches, so the compiler overlaps the tiles' ldmatrix
// and mma chains (a guard per tile leaves every tile's loads and its
// dependent chain of D/16 mma exposed: the backward at S=193 then takes
// 0.400 ms instead of 0.322, tools/attention_variants.py).  A group's
// tiles past the last live one score masked keys (p = 0) against staged
// zero rows.
constexpr int kTileGroup = 4;
__host__ __device__ constexpr int group_end(int g0, int nkt) {
  return g0 + kTileGroup < nkt ? g0 + kTileGroup : nkt;
}
// Rows staged for a sequence: whole groups of key tiles, at most nkt tiles.
__host__ __device__ constexpr int staged_rows(int seq, int nkt) {
  const int tiles = (seq + kKeyTile - 1) / kKeyTile;
  const int whole = (tiles + kTileGroup - 1) / kTileGroup * kTileGroup;
  return (whole < nkt ? whole : nkt) * kKeyTile;
}

// Scores of a warp's 16 query rows (fragments qa) against key tiles
// 0..kt_hi-1 (rounded up to a group; all NKT, with no guard, if kAll), then
// the whole-row softmax in registers: on return s holds
// e = exp(s * scale - rowmax) (0 where masked) for rows g (s[.][0..1]) and
// g + 8 (s[.][2..3]), row_max and row_sum the rows' statistics.
template <int D, int NKT, bool kAll>
__device__ __forceinline__ void score_rows(
    float (&s)[2 * NKT][4], const uint32_t (&qa)[D / 16][4], uint32_t k_base,
    int row0, int kt_hi, int seq, float scale, int causal, float (&row_max)[2],
    float (&row_sum)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // key n * 8 + 2 t + (j & 1) is visible to row half h iff
  // n * 8 + (j & 1) <= last[h]
  int last[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    last[h] = (causal ? min(seq - 1, row0 + g + 8 * h) : seq - 1) - 2 * t;
  row_max[0] = row_max[1] = -INFINITY;
#pragma unroll
  for (int g0 = 0; g0 < NKT; g0 += kTileGroup) {
    if (kAll || g0 < kt_hi) {
#pragma unroll
      for (int kt = g0; kt < group_end(g0, NKT); ++kt)
        tile_abt<D>(s[2 * kt], s[2 * kt + 1], qa, k_base, kt * 16);
#pragma unroll
      for (int n = 2 * g0; n < 2 * group_end(g0, NKT); ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[n][j] = n * 8 + (j & 1) <= last[j >> 1] ? __fmul_rn(s[n][j], scale)
                                                    : -INFINITY;
          row_max[j >> 1] = fmaxf(row_max[j >> 1], s[n][j]);
        }
      }
    }
  }
  row_max[0] = quad_max(row_max[0]);
  row_max[1] = quad_max(row_max[1]);
  const float shift[2] = {row_max[0] * kLog2e, row_max[1] * kLog2e};
  row_sum[0] = row_sum[1] = 0.f;
#pragma unroll
  for (int g0 = 0; g0 < NKT; g0 += kTileGroup) {
    if (kAll || g0 < kt_hi) {
#pragma unroll
      for (int n = 2 * g0; n < 2 * group_end(g0, NKT); ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[n][j] = fast_exp2(fmaf(s[n][j], kLog2e, -shift[j >> 1]));
          row_sum[j >> 1] += s[n][j];
        }
      }
    }
  }
  row_sum[0] = quad_sum(row_sum[0]);
  row_sum[1] = quad_sum(row_sum[1]);
}

// One row tile of the forward: scores, softmax, e v, the store.  Returns
// after waiting once (per warp) for V.
template <int D, int NKT, bool kAll>
__device__ __forceinline__ void fwd_row_tile(uint32_t q_base, uint32_t k_base,
                                             uint32_t v_base, bf16* out_head,
                                             int width, int row0, int kt_hi,
                                             int seq, float scale, int causal,
                                             bool& v_ready) {
  float s[2 * NKT][4], row_max[2], row_sum[2];
  {
    uint32_t qa[D / 16][4];
    load_a<D>(qa, q_base, row0);
    score_rows<D, NKT, kAll>(s, qa, k_base, row0, kt_hi, seq, scale, causal,
                             row_max, row_sum);
  }
  if (!v_ready) {  // every warp passes this barrier exactly once
    cp_async_wait<0>();
    __syncthreads();
    v_ready = true;
  }
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[n][j] = 0.f;
#pragma unroll
  for (int g0 = 0; g0 < NKT; g0 += kTileGroup) {
    if (kAll || g0 < kt_hi) {
#pragma unroll
      for (int kt = g0; kt < group_end(g0, NKT); ++kt) {
        // e cast to bf16: the A operand of e v
        const uint32_t pa[4] = {pack_bf16(s[2 * kt][0], s[2 * kt][1]),
                                pack_bf16(s[2 * kt][2], s[2 * kt][3]),
                                pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                                pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
        tile_ab<D>(o, pa, v_base, kt * 16);
      }
    }
  }
  store_tile<D>(out_head, width, o, 1.f / row_sum[0], 1.f / row_sum[1], row0,
                seq);
}

// One block per (head, sample); a warp per 16 query rows, in turns.
template <int D, int NKT>
__global__ void __launch_bounds__(128, 2)
    attention_fwd_mma(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                      int seq, int width, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_kt = (seq + kKeyTile - 1) / kKeyTile;
  const int s_rows = staged_rows(seq, NKT);
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + s_rows * D;
  bf16* v_s = k_s + s_rows * D;

  const int h = blockIdx.x, b = blockIdx.y;
  const long stride = 3L * width;
  const bf16* base = qkv + static_cast<long>(b) * seq * stride + h * D;
  stage_async<D>(k_s, base + width, stride, seq, s_rows);
  stage_async<D>(q_s, base, stride, seq, s_rows);
  cp_async_commit();
  stage_async<D>(v_s, base + 2 * width, stride, seq, s_rows);
  cp_async_commit();
  cp_async_wait<1>();  // Q and K have landed; V is still in flight
  __syncthreads();

  const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const uint32_t q_base = smem_addr(q_s), k_base = smem_addr(k_s),
                 v_base = smem_addr(v_s);
  bf16* out_head = out + static_cast<long>(b) * seq * width + h * D;
  bool v_ready = false;
#pragma unroll 1
  for (int rt = warp; rt < n_kt; rt += n_warps) {
    const int row0 = rt * kKeyTile;
    const int kt_hi = causal ? min(n_kt, rt + 1) : n_kt;
    // a row tile that sees every key tile of the instantiation takes the
    // copy without guards
    if (kt_hi == NKT)
      fwd_row_tile<D, NKT, true>(q_base, k_base, v_base, out_head, width,
                                 row0, kt_hi, seq, scale, causal, v_ready);
    else
      fwd_row_tile<D, NKT, false>(q_base, k_base, v_base, out_head, width,
                                  row0, kt_hi, seq, scale, causal, v_ready);
  }
  if (!v_ready) {
    cp_async_wait<0>();
    __syncthreads();
  }
}

// Phase 1 of the backward for one row tile: the rows' statistics into
// shared memory (shift = rowmax * log2(e), 1 / rowsum(e), delta) and dq.
template <int D, int NKT>
__device__ __forceinline__ void bwd_row_tile(
    uint32_t q_base, uint32_t k_base, uint32_t v_base, uint32_t g_base,
    float* shift_s, float* rsum_s, float* delta_s, bf16* dq_head, long stride,
    int row0, int kt_hi, int seq, float scale, int causal, bool& vg_ready) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  float p[2 * NKT][4], row_max[2], row_sum[2];
  {
    uint32_t qa[D / 16][4];
    load_a<D>(qa, q_base, row0);
    score_rows<D, NKT, false>(p, qa, k_base, row0, kt_hi, seq, scale, causal,
                             row_max, row_sum);
  }
  const float rsum[2] = {1.f / row_sum[0], 1.f / row_sum[1]};
  if (!vg_ready) {  // every warp passes this barrier exactly once
    cp_async_wait<0>();
    __syncthreads();
    vg_ready = true;
  }
  uint32_t ga[D / 16][4];
  load_a<D>(ga, g_base, row0);
  float delta[2] = {0.f, 0.f};
#pragma unroll
  for (int g0 = 0; g0 < NKT; g0 += kTileGroup) {
    if (g0 < kt_hi) {
#pragma unroll
      for (int kt = g0; kt < group_end(g0, NKT); ++kt) {
        float dp[2][4];
        tile_abt<D>(dp[0], dp[1], ga, v_base, kt * 16);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            p[2 * kt + n][j] *= rsum[j >> 1];  // e -> normalised p
            delta[j >> 1] += dp[n][j] * p[2 * kt + n][j];
          }
      }
    }
  }
  delta[0] = quad_sum(delta[0]);
  delta[1] = quad_sum(delta[1]);
  if (t == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + gr + 8 * half;
      shift_s[row] = row_max[half] * kLog2e;
      rsum_s[row] = rsum[half];
      delta_s[row] = delta[half];
    }
  }
  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) dq[n][j] = 0.f;
#pragma unroll
  for (int g0 = 0; g0 < NKT; g0 += kTileGroup) {
    if (g0 < kt_hi) {
#pragma unroll
      for (int kt = g0; kt < group_end(g0, NKT); ++kt) {
        float dp[2][4];
        tile_abt<D>(dp[0], dp[1], ga, v_base, kt * 16);
        uint32_t dsa[4];  // ds cast to bf16: the A operand of ds k
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            dsa[2 * n + half] = pack_bf16(
                p[2 * kt + n][2 * half] * (dp[n][2 * half] - delta[half]) *
                    scale,
                p[2 * kt + n][2 * half + 1] *
                    (dp[n][2 * half + 1] - delta[half]) * scale);
        tile_ab<D>(dq, dsa, k_base, kt * 16);
      }
    }
  }
  store_tile<D>(dq_head, stride, dq, 1.f, 1.f, row0, seq);
}

// One block per (head, sample).  Phase 1, a warp per 16 query rows: row
// statistics and dq.  Phase 2, a warp per 16 keys: dk and dv.
template <int D, int NKT, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, WARPS == 4 ? 2 : 1)
    attention_bwd_mma(const bf16* __restrict__ qkv, const bf16* __restrict__ g,
                      bf16* __restrict__ dqkv, int seq, int width, float scale,
                      int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_kt = (seq + kKeyTile - 1) / kKeyTile;
  const int s_rows = staged_rows(seq, NKT);
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + s_rows * D;
  bf16* v_s = k_s + s_rows * D;
  bf16* g_s = v_s + s_rows * D;
  float* shift_s = reinterpret_cast<float*>(g_s + s_rows * D);
  float* rsum_s = shift_s + s_rows;
  float* delta_s = rsum_s + s_rows;

  const int h = blockIdx.x, b = blockIdx.y;
  const long stride = 3L * width;
  const bf16* base = qkv + static_cast<long>(b) * seq * stride + h * D;
  stage_async<D>(k_s, base + width, stride, seq, s_rows);
  stage_async<D>(q_s, base, stride, seq, s_rows);
  cp_async_commit();
  stage_async<D>(v_s, base + 2 * width, stride, seq, s_rows);
  stage_async<D>(g_s, g + static_cast<long>(b) * seq * width + h * D, width,
                 seq, s_rows);
  cp_async_commit();
  cp_async_wait<1>();  // Q and K have landed; V and G are still in flight
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const uint32_t q_base = smem_addr(q_s), k_base = smem_addr(k_s),
                 v_base = smem_addr(v_s), g_base = smem_addr(g_s);
  bf16* dq_head = dqkv + static_cast<long>(b) * seq * stride + h * D;
  bool vg_ready = false;
#pragma unroll 1
  for (int rt = warp; rt < n_kt; rt += WARPS) {
    const int row0 = rt * kKeyTile;
    const int kt_hi = causal ? min(n_kt, rt + 1) : n_kt;
    // (the copy without guards that the forward takes spills here)
    bwd_row_tile<D, NKT>(q_base, k_base, v_base, g_base, shift_s, rsum_s,
                         delta_s, dq_head, stride, row0, kt_hi, seq, scale,
                         causal, vg_ready);
  }
  if (!vg_ready) {  // a warp without a row tile: the same two barriers
    cp_async_wait<0>();
    __syncthreads();
  }
  __syncthreads();  // every row's statistics are in shared memory

#pragma unroll 1
  for (int kt = warp; kt < n_kt; kt += WARPS) {
    const int key0 = kt * kKeyTile;
    uint32_t ka[D / 16][4], va[D / 16][4];
    load_a<D>(ka, k_base, key0);
    load_a<D>(va, v_base, key0);
    float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) dk[n][j] = dv[n][j] = 0.f;
    // query qi meets this thread's key of half h iff first[h] <= qi < seq
    int first[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = key0 + gr + 8 * half;
      first[half] = key >= seq ? seq : (causal ? key : 0);
    }
#pragma unroll 1
    for (int qt = causal ? kt : 0; qt < n_kt; ++qt) {
      const int q0 = qt * kKeyTile;
      float st[2][4], dpt[2][4];  // S^T and dP^T: rows are keys, columns q
      tile_abt<D>(st[0], st[1], ka, q_base, q0);
      tile_abt<D>(dpt[0], dpt[1], va, g_base, q0);
      uint32_t pa[4], dsa[4];  // p^T and ds^T cast to bf16: A operands
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int q = q0 + 8 * n + 2 * t;
        const float2 h2 = *reinterpret_cast<const float2*>(shift_s + q);
        const float2 r2 = *reinterpret_cast<const float2*>(rsum_s + q);
        const float2 d2 = *reinterpret_cast<const float2*>(delta_s + q);
        float pv[4], ds[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qi = q + (j & 1);
          const bool ok = qi >= first[j >> 1] && qi < seq;
          const float e = fast_exp2(fmaf(__fmul_rn(st[n][j], scale), kLog2e,
                                         (j & 1) ? -h2.y : -h2.x));
          pv[j] = ok ? e * ((j & 1) ? r2.y : r2.x) : 0.f;
          ds[j] = pv[j] * (dpt[n][j] - ((j & 1) ? d2.y : d2.x)) * scale;
        }
        pa[2 * n] = pack_bf16(pv[0], pv[1]);
        pa[2 * n + 1] = pack_bf16(pv[2], pv[3]);
        dsa[2 * n] = pack_bf16(ds[0], ds[1]);
        dsa[2 * n + 1] = pack_bf16(ds[2], ds[3]);
      }
      tile_ab<D>(dv, pa, g_base, q0);
      tile_ab<D>(dk, dsa, q_base, q0);
    }
    store_tile<D>(dq_head + width, stride, dk, 1.f, 1.f, key0, seq);
    store_tile<D>(dq_head + 2 * width, stride, dv, 1.f, 1.f, key0, seq);
  }
}

// ------------------------------------------------------------------ host

template <typename T, int D> size_t staged_bytes(int s_pad) {
  return 2 * static_cast<size_t>(s_pad) * padded_ld<T, D>() * sizeof(T);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
cudaError_t launch_fwd(const void* qkv, void* out, int batch, int seq,
                       int width, int heads, float scale, int causal,
                       cudaStream_t stream) {
  const int s_pad = (seq + 31) / 32 * 32;
  const size_t smem = staged_bytes<T, D>(s_pad) + kTile * D * sizeof(float);
  cudaError_t err = allow_smem(attention_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kTile - 1) / kTile, heads, batch);
  attention_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), seq, width, scale,
      causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd(const void* qkv, const void* g, void* dqkv,
                       void* stats, int batch, int seq, int width, int heads,
                       float scale, int causal, cudaStream_t stream) {
  const int s_pad = (seq + 31) / 32 * 32;
  const dim3 grid((seq + kTile - 1) / kTile, heads, batch);
  const size_t smem_dq =
      staged_bytes<T, D>(s_pad) + 2 * kTile * D * sizeof(float);
  cudaError_t err = allow_smem(attention_bwd_dq_kernel<T, D>, smem_dq);
  if (err != cudaSuccess) return err;
  attention_bwd_dq_kernel<T, D><<<grid, kThreads, smem_dq, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(g),
      static_cast<T*>(dqkv), static_cast<float*>(stats), seq, width, heads,
      scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem_dkv = smem_dq + 3 * s_pad * sizeof(float);
  err = allow_smem(attention_bwd_dkv_kernel<T, D>, smem_dkv);
  if (err != cudaSuccess) return err;
  attention_bwd_dkv_kernel<T, D><<<grid, kThreads, smem_dkv, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(g),
      static_cast<const float*>(stats), static_cast<T*>(dqkv), seq, width,
      heads, scale, causal);
  return cudaGetLastError();
}

// The key-tile count a bf16 kernel is instantiated for: the smallest of 7,
// 13 and 18 that holds ceil(seq / 16).
template <int D, int NKT>
cudaError_t launch_fwd_mma(const void* qkv, void* out, int batch, int seq,
                           int width, int heads, float scale, int causal,
                           cudaStream_t stream) {
  const size_t smem =
      3 * static_cast<size_t>(staged_rows(seq, NKT)) * D * sizeof(bf16);
  cudaError_t err = allow_smem(attention_fwd_mma<D, NKT>, smem);
  if (err != cudaSuccess) return err;
  attention_fwd_mma<D, NKT><<<dim3(heads, batch), 128, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), seq, width,
      scale, causal);
  return cudaGetLastError();
}

template <int D, int NKT, int WARPS>
cudaError_t launch_bwd_mma(const void* qkv, const void* g, void* dqkv,
                           int batch, int seq, int width, int heads,
                           float scale, int causal, cudaStream_t stream) {
  const int s_rows = staged_rows(seq, NKT);
  const size_t smem = 4 * static_cast<size_t>(s_rows) * D * sizeof(bf16) +
                      3 * s_rows * sizeof(float);
  cudaError_t err = allow_smem(attention_bwd_mma<D, NKT, WARPS>, smem);
  if (err != cudaSuccess) return err;
  attention_bwd_mma<D, NKT, WARPS>
      <<<dim3(heads, batch), WARPS * 32, smem, stream>>>(
          static_cast<const bf16*>(qkv), static_cast<const bf16*>(g),
          static_cast<bf16*>(dqkv), seq, width, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t fwd_mma(const void* qkv, void* out, int batch, int seq, int width,
                    int heads, float scale, int causal, cudaStream_t s) {
  const int n_kt = (seq + kKeyTile - 1) / kKeyTile;
  if (n_kt <= 7)
    return launch_fwd_mma<D, 7>(qkv, out, batch, seq, width, heads, scale,
                                causal, s);
  if (n_kt <= 13)
    return launch_fwd_mma<D, 13>(qkv, out, batch, seq, width, heads, scale,
                                 causal, s);
  return launch_fwd_mma<D, 18>(qkv, out, batch, seq, width, heads, scale,
                               causal, s);
}

template <int D>
cudaError_t bwd_mma(const void* qkv, const void* g, void* dqkv, int batch,
                    int seq, int width, int heads, float scale, int causal,
                    cudaStream_t s) {
  const int n_kt = (seq + kKeyTile - 1) / kKeyTile;
  if (n_kt <= 7)
    return launch_bwd_mma<D, 7, 4>(qkv, g, dqkv, batch, seq, width, heads,
                                   scale, causal, s);
  if (n_kt <= 13)
    return launch_bwd_mma<D, 13, 4>(qkv, g, dqkv, batch, seq, width, heads,
                                    scale, causal, s);
  // one block an SM at this size: 8 warps keep it busy
  return launch_bwd_mma<D, 18, 8>(qkv, g, dqkv, batch, seq, width, heads,
                                  scale, causal, s);
}

bool supported(int batch, int seq, int width, int heads) {
  if (batch < 1 || batch > 65535 || seq < 1 || seq > kMaxSeq || heads < 1 ||
      heads > 65535 || width % heads)
    return false;
  const int d = width / heads;
  return d == 32 || d == 64;
}

}  // namespace

// qkv [B, S, 3W] -> out [B, S, W]; bf16 (tensor cores) if is_bf16, else
// f32 (FP32 cores).
extern "C" int fused_attention_fwd(const void* qkv, void* out, int batch,
                                   int seq, int width, int heads, float scale,
                                   int causal, int is_bf16, void* stream) {
  if (!supported(batch, seq, width, heads))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = width / heads;
  cudaError_t err;
  if (is_bf16)
    err = d == 64 ? fwd_mma<64>(qkv, out, batch, seq, width, heads, scale,
                                causal, s)
                  : fwd_mma<32>(qkv, out, batch, seq, width, heads, scale,
                                causal, s);
  else
    err = d == 64 ? launch_fwd<float, 64>(qkv, out, batch, seq, width, heads,
                                          scale, causal, s)
                  : launch_fwd<float, 32>(qkv, out, batch, seq, width, heads,
                                          scale, causal, s);
  return static_cast<int>(err);
}

// qkv [B, S, 3W], g [B, S, W] -> dqkv [B, S, 3W].  bf16 is one launch and
// ignores stats; f32 is two launches that share stats, a [B, H, S, 4] f32
// scratch.
extern "C" int fused_attention_bwd(const void* qkv, const void* g, void* dqkv,
                                   void* stats, int batch, int seq, int width,
                                   int heads, float scale, int causal,
                                   int is_bf16, void* stream) {
  if (!supported(batch, seq, width, heads))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = width / heads;
  cudaError_t err;
  if (is_bf16)
    err = d == 64 ? bwd_mma<64>(qkv, g, dqkv, batch, seq, width, heads, scale,
                                causal, s)
                  : bwd_mma<32>(qkv, g, dqkv, batch, seq, width, heads, scale,
                                causal, s);
  else if (stats == nullptr)
    err = cudaErrorInvalidValue;
  else
    err = d == 64 ? launch_bwd<float, 64>(qkv, g, dqkv, stats, batch, seq,
                                          width, heads, scale, causal, s)
                  : launch_bwd<float, 32>(qkv, g, dqkv, stats, batch, seq,
                                          width, heads, scale, causal, s);
  return static_cast<int>(err);
}
