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
// What bounds it on the H100: at the ViT-B/16 shape (B=128, S=193, H=12,
// D=64) a head's K and V are 193 x 64, small enough to stay in shared
// memory (24.7 KB each in bf16, 49 KB in f32).  One [S, S] x D product
// over all heads and samples is 7.3 GFLOP; the forward runs two (14.6
// GFLOP), the backward's two passes seven (51 GFLOP).  Written here on the
// FP32 cores (no mma/wgmma yet), the kernels are bound by the FMA rate and
// shared-memory reads, not by device memory: qkv (114 MB in bf16) is read
// about once from HBM.  Measured (bf16, H100 SXM at 700 W): forward
// 1.34 ms, 10.9 TFLOP/s, 16% of the FP32 cores' 67 TFLOP/s; backward
// 4.6 ms, 11 TFLOP/s.  Tensor cores (mma/wgmma on bf16) are the next step.
//
// Design (simple first; wgmma and TMA are later work):
// * Forward: one block (8 warps) per (query tile of 64 rows, head,
//   sample).  The head's K and V are staged in shared memory in the input
//   type, rows padded to a multiple of 32 with zeros and the row stride
//   padded to an odd number of 32-bit words, so a warp reading one column
//   of 32 rows hits 32 banks.  A warp carries 4 query rows at a time: lane
//   j holds the scores of keys j, j+32, ... in registers (S <= 288 = 9
//   chunks), the row max and sum are warp shuffles, and the PV product
//   broadcasts each probability by shuffle while lanes own output columns.
// * Backward, two passes that never hold an [S, S] tile in memory:
//   pass 1, one block per (query tile, head, sample), stages K and V,
//   recomputes s, p and dp row by row, writes dq and each row's
//   (max, sum, rowsum(dp p)) to a [B, H, S, 4] f32 scratch;
//   pass 2, one block per (key tile, head, sample), stages Q and G and
//   the row statistics, recomputes p and ds column by column (the dot
//   products run in the same order as pass 1, so p is the same number)
//   and writes dk and dv.  Each block owns its outputs: no atomics.
// * Causal: a row group stops at the chunk holding its last visible key
//   (forward, pass 1); a key group starts at the chunk of its first
//   visible row (pass 2).
// Limits: head_dim 32 or 64, 1 <= S <= 288 (ViT-L/14 at 224 is S=257).
// Shared memory, worst case (pass 2, f32, S=288, D=64): 186 KB of the
// 227 KB a block may use, so every kernel opts in above 48 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}
// v rounded to T and back: the kernels' casts of p and ds
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return make_float2(p[0], p[1]);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
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

bool supported(int batch, int seq, int width, int heads) {
  if (batch < 1 || batch > 65535 || seq < 1 || seq > kMaxSeq || heads < 1 ||
      heads > 65535 || width % heads)
    return false;
  const int d = width / heads;
  return d == 32 || d == 64;
}

}  // namespace

// qkv [B, S, 3W] -> out [B, S, W]; T = bf16 if is_bf16 else f32.
extern "C" int fused_attention_fwd(const void* qkv, void* out, int batch,
                                   int seq, int width, int heads, float scale,
                                   int causal, int is_bf16, void* stream) {
  if (!supported(batch, seq, width, heads))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = width / heads;
  cudaError_t err;
  if (is_bf16)
    err = d == 64 ? launch_fwd<__nv_bfloat16, 64>(qkv, out, batch, seq, width,
                                                  heads, scale, causal, s)
                  : launch_fwd<__nv_bfloat16, 32>(qkv, out, batch, seq, width,
                                                  heads, scale, causal, s);
  else
    err = d == 64 ? launch_fwd<float, 64>(qkv, out, batch, seq, width, heads,
                                          scale, causal, s)
                  : launch_fwd<float, 32>(qkv, out, batch, seq, width, heads,
                                          scale, causal, s);
  return static_cast<int>(err);
}

// qkv [B, S, 3W], g [B, S, W] -> dqkv [B, S, 3W]; stats is a [B, H, S, 4]
// f32 scratch the two passes share.
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
    err = d == 64 ? launch_bwd<__nv_bfloat16, 64>(qkv, g, dqkv, stats, batch,
                                                  seq, width, heads, scale,
                                                  causal, s)
                  : launch_bwd<__nv_bfloat16, 32>(qkv, g, dqkv, stats, batch,
                                                  seq, width, heads, scale,
                                                  causal, s);
  else
    err = d == 64 ? launch_bwd<float, 64>(qkv, g, dqkv, stats, batch, seq,
                                          width, heads, scale, causal, s)
                  : launch_bwd<float, 32>(qkv, g, dqkv, stats, batch, seq,
                                          width, heads, scale, causal, s);
  return static_cast<int>(err);
}
