// topk_similarity_f32: streaming top-k of queries @ gallery^T in float32,
// without materialising the [Q, G] score matrix.
//
// Replaces: textreid_tpu/ops/ranking_pallas.py:topk_similarity (Pallas
// kernel from _make_kernel, merge _fold_tile), f32 compute.  Contract:
//   vals[q, :], idx[q, :] = the k best (score, row) pairs of row q of
//   Q @ G^T over gallery rows < valid_gallery, sorted under the order
//   (score desc, row desc): on an exact tie the larger row wins.  Slots
//   past the number of valid rows hold NEG_INF (-3e38) and row -1.
// Q [Q, D] and G [G, D] f32 row-major, 1 <= k <= 64, D % 4 == 0.
//
// What bounds it on the H100: every query must meet every gallery row, so
// the gallery (G * D * 4 bytes: 100 MB at G = 98,304, D = 256) streams
// once per query tile, and the dot products run on the FP32 CUDA cores
// (no TF32, so scores agree with a float32 matmul).  The running top-k
// must not cost a sort per tile.
//
// Design: the grid is (query tiles of 8, gallery splits); a block of 8
// warps holds its 8 queries in shared memory and streams its split of the
// gallery in tiles of 64 rows, staged through shared memory with float4
// loads (rows padded by 4 floats, so a warp's float4 reads of 32 rows are
// free of bank conflicts).  Each thread scores one gallery row against two
// queries.  Warp w then owns query w: its running top-k lives in
// registers, two entries per lane (slots lane and lane + 32), sorted.  A
// candidate enters only if it beats the k-th entry (one ballot per 32
// candidates); the few that do are inserted one at a time with a ballot
// count for the position and a shuffle for the shift.  After the first
// tiles almost no candidate passes the threshold, so the merge costs one
// compare per score.  With more than one split, each block writes its
// sorted list to scratch and a second kernel merges a query's lists with
// the same insertion, so the top-k never goes through a sort.  The
// wrapper picks the splits to fill the card (about two blocks per SM):
// without them Q = 256 gave only 32 blocks, 9.8 ms at G = 98,304 on an
// H100 SXM at 700 W against 2.6 ms for matmul + sort.  cp.async/TMA
// double buffering of the tiles and tensor-core scoring are later work.
//
// topk_similarity_int8: the same streaming top-k over an int8 gallery with
// per-row scales.
//
// Replaces: textreid_tpu/ops/ranking_pallas.py:topk_similarity_quantized
// (Pallas kernel from _make_quant_kernel, merge _fold_tile).  Contract
// (ops/quant.py:quantized_scores, then the order above):
//   score[q, g] = (sum_d float(bf16(Q[q, d])) * float(G[g, d])) * scales[g]
// accumulated in f32; a bf16 times an int8 is exact in f32, so only the
// order of the sum differs from a matrix product's.  Q [Q, D] f32, G [G, D]
// int8, scales [G] f32, 1 <= k <= 64, D % 16 == 0.
//
// What bounds it on the H100: the gallery is a quarter of the f32 kernel's
// bytes (25 MB at G = 98,304, D = 256: 7.5 us at 3.35 TB/s), so the dot
// products on the FP32 cores bind (Q G D FMAs: 6.4 G at Q = 256, about
// 0.2 ms at 67 TFLOP/s), and beside them the int8 -> f32 conversions.
//
// Design: the f32 kernel's grid (query tiles of 8, gallery splits), its
// running top-k in registers and its merge kernel, with a scoring stage
// made for int8 rows: tiles of 128 rows staged as bytes (rows padded by 16
// bytes, so a warp's 16-byte reads are free of bank conflicts), each thread
// scoring one row against four queries, so a row's 16 bytes are converted
// once for 64 FMAs.  The conversion avoids the quarter-rate I2F: a byte
// permute builds the float 2^23 + (v + 128) and one subtraction gives v.
// The queries are rounded to bf16 once, when the block stages them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kQueries = 8;   // queries per block = warps per block
constexpr int kRowsTile = 64;  // gallery rows per staged tile
constexpr int kThreads = kQueries * 32;
constexpr float kNegInf = -3.0e38f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool ranks_above(float v, int i, float cv, int ci) {
  return v > cv || (v == cv && i > ci);
}

// Offer one candidate per lane, (v, row) where `valid`, to the warp's
// running top-k: slots lane (v0, i0) and lane + 32 (v1, i1), so k <= 64.
// Only candidates that beat the k-th entry are inserted, one at a time:
// a ballot count gives the position, a shuffle shifts the tail.
__device__ __forceinline__ void offer(float v, int row, bool valid, int k,
                                      int lane, float& v0, int& i0,
                                      float& v1, int& i1) {
  const int last_lane = (k - 1) & 31;
  const bool last_hi = (k - 1) >= 32;
  const float tv = __shfl_sync(kFull, last_hi ? v1 : v0, last_lane);
  const int ti = __shfl_sync(kFull, last_hi ? i1 : i0, last_lane);
  unsigned pending = __ballot_sync(kFull, valid && ranks_above(v, row, tv, ti));
  while (pending) {
    const int src = __ffs(pending) - 1;
    pending &= pending - 1;
    const float cv = __shfl_sync(kFull, v, src);
    const int ci = __shfl_sync(kFull, row, src);
    // insertion position = number of kept entries ranking above it
    const int above = (lane < k && ranks_above(v0, i0, cv, ci)) +
                      (lane + 32 < k && ranks_above(v1, i1, cv, ci));
    const int pos = __reduce_add_sync(kFull, above);
    if (pos >= k) continue;  // lost to the entries inserted meanwhile
    // shift slots pos..k-2 one place down, then write slot pos
    const float p0 = __shfl_up_sync(kFull, v0, 1);
    const int j0 = __shfl_up_sync(kFull, i0, 1);
    float p1 = __shfl_up_sync(kFull, v1, 1);
    int j1 = __shfl_up_sync(kFull, i1, 1);
    const float top_v0 = __shfl_sync(kFull, v0, 31);
    const int top_i0 = __shfl_sync(kFull, i0, 31);
    if (lane == 0) {
      p1 = top_v0;
      j1 = top_i0;
    }
    if (lane > pos) {
      v0 = p0;
      i0 = j0;
    } else if (lane == pos) {
      v0 = cv;
      i0 = ci;
    }
    if (lane + 32 > pos) {
      v1 = p1;
      i1 = j1;
    } else if (lane + 32 == pos) {
      v1 = cv;
      i1 = ci;
    }
  }
}

__device__ __forceinline__ void write_list(float* vrow, int* irow, int k,
                                           int lane, float v0, int i0,
                                           float v1, int i1) {
  if (lane < k) {
    vrow[lane] = v0;
    irow[lane] = i0;
  }
  if (lane + 32 < k) {
    vrow[lane + 32] = v1;
    irow[lane + 32] = i1;
  }
}

// Block (query tile, split): the top-k of 8 queries over gallery rows
// [split * rows_per_split, ...) below n_rows, into list (q, split) of
// vals/idx ([n_q, splits, k]; with one split that is the output).
__global__ void __launch_bounds__(kThreads)
topk_similarity_kernel(const float* __restrict__ q,
                       const float* __restrict__ g, float* __restrict__ vals,
                       int* __restrict__ idx, int n_q, int n_rows, int dim,
                       int k, int rows_per_split) {
  extern __shared__ float4 smem4[];
  const int ld = dim + 4;  // padded gallery row stride
  float* q_s = reinterpret_cast<float*>(smem4);  // [kQueries][dim]
  float* g_s = q_s + kQueries * dim;              // [kRowsTile][ld]
  float* s_s = g_s + kRowsTile * ld;              // [kQueries][kRowsTile]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kQueries;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int row_begin = split * rows_per_split;
  const int row_end = min(row_begin + rows_per_split, n_rows);
  const int vec_per_row = dim / 4;

  for (int i = tid; i < kQueries * vec_per_row; i += kThreads) {
    const int r = i / vec_per_row;
    const int c = (i - r * vec_per_row) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < n_q) {
      v = *reinterpret_cast<const float4*>(q + static_cast<size_t>(q0 + r) * dim + c);
    }
    *reinterpret_cast<float4*>(q_s + r * dim + c) = v;
  }

  // running top-k of query `warp`
  float v0 = kNegInf, v1 = kNegInf;
  int i0 = -1, i1 = -1;

  const int my_row = tid % kRowsTile;
  const int my_q = (tid / kRowsTile) * 2;

  for (int base = row_begin; base < row_end; base += kRowsTile) {
    for (int i = tid; i < kRowsTile * vec_per_row; i += kThreads) {
      const int r = i / vec_per_row;
      const int c = (i - r * vec_per_row) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (base + r < row_end) {
        v = *reinterpret_cast<const float4*>(
            g + static_cast<size_t>(base + r) * dim + c);
      }
      *reinterpret_cast<float4*>(g_s + r * ld + c) = v;
    }
    __syncthreads();  // tile staged; previous tile's merge is done

    {
      const float* gr = g_s + my_row * ld;
      const float* qa = q_s + my_q * dim;
      const float* qb = qa + dim;
      float a0 = 0.f, a1 = 0.f;
      for (int d = 0; d < dim; d += 4) {
        const float4 gv = *reinterpret_cast<const float4*>(gr + d);
        const float4 x = *reinterpret_cast<const float4*>(qa + d);
        const float4 y = *reinterpret_cast<const float4*>(qb + d);
        a0 = fmaf(x.x, gv.x, a0);
        a0 = fmaf(x.y, gv.y, a0);
        a0 = fmaf(x.z, gv.z, a0);
        a0 = fmaf(x.w, gv.w, a0);
        a1 = fmaf(y.x, gv.x, a1);
        a1 = fmaf(y.y, gv.y, a1);
        a1 = fmaf(y.z, gv.z, a1);
        a1 = fmaf(y.w, gv.w, a1);
      }
      s_s[my_q * kRowsTile + my_row] = a0;
      s_s[(my_q + 1) * kRowsTile + my_row] = a1;
    }
    __syncthreads();  // score tile complete

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = lane + half * 32;
      const int row = base + col;
      offer(s_s[warp * kRowsTile + col], row, row < row_end, k, lane, v0, i0,
            v1, i1);
    }
  }

  const int qrow = q0 + warp;
  if (qrow < n_q) {
    const size_t at = (static_cast<size_t>(qrow) * splits + split) * k;
    write_list(vals + at, idx + at, k, lane, v0, i0, v1, i1);
  }
}

// One warp per query: merge its `splits` partial lists ([n_q, splits, k])
// into the final top-k ([n_q, k]).  Sentinel entries (row -1) never enter.
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ part_vals,
             const int* __restrict__ part_idx, float* __restrict__ vals,
             int* __restrict__ idx, int n_q, int splits, int k) {
  const int lane = threadIdx.x & 31;
  const int qrow = blockIdx.x * kQueries + (threadIdx.x >> 5);
  if (qrow >= n_q) return;  // whole warps leave together
  const float* pv = part_vals + static_cast<size_t>(qrow) * splits * k;
  const int* pi = part_idx + static_cast<size_t>(qrow) * splits * k;
  float v0 = kNegInf, v1 = kNegInf;
  int i0 = -1, i1 = -1;
  const int total = splits * k;
  for (int base = 0; base < total; base += 32) {
    const int c = base + lane;
    const bool in = c < total;
    const int row = in ? pi[c] : -1;
    offer(in ? pv[c] : kNegInf, row, row >= 0, k, lane, v0, i0, v1, i1);
  }
  const size_t at = static_cast<size_t>(qrow) * k;
  write_list(vals + at, idx + at, k, lane, v0, i0, v1, i1);
}

constexpr int kRowsTileQ = 128;  // int8 gallery rows per staged tile

// 4 int8 packed in `word` (already XORed with 0x80808080: bytes are v + 128)
// to floats: byte i under the exponent of 2^23 is 2^23 + v + 128, exactly.
__device__ __forceinline__ void unpack4(unsigned word, float (&out)[4]) {
  out[0] = __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7540)) - 8388736.0f;
  out[1] = __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7541)) - 8388736.0f;
  out[2] = __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7542)) - 8388736.0f;
  out[3] = __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7543)) - 8388736.0f;
}

// Block (query tile, split) over an int8 gallery: as topk_similarity_kernel,
// with tiles of kRowsTileQ rows and thread (row, group of 4 queries).
__global__ void __launch_bounds__(kThreads)
topk_int8_kernel(const float* __restrict__ q,
                 const signed char* __restrict__ g,
                 const float* __restrict__ scales, float* __restrict__ vals,
                 int* __restrict__ idx, int n_q, int n_rows, int dim, int k,
                 int rows_per_split) {
  extern __shared__ uint4 smem16[];
  const int ld = dim + 16;  // padded gallery row stride, bytes
  float* q_s = reinterpret_cast<float*>(smem16);  // [kQueries][dim]
  unsigned char* g_s =
      reinterpret_cast<unsigned char*>(q_s + kQueries * dim);  // [tile][ld]
  float* s_s = reinterpret_cast<float*>(g_s + kRowsTileQ * ld);
  // s_s: [kQueries][kRowsTileQ]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kQueries;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int row_begin = split * rows_per_split;
  const int row_end = min(row_begin + rows_per_split, n_rows);
  const int vec_per_row = dim / 16;

  for (int i = tid; i < kQueries * dim; i += kThreads) {
    const int r = i / dim;
    float v = 0.f;
    if (q0 + r < n_q) {
      v = __bfloat162float(
          __float2bfloat16(q[static_cast<size_t>(q0 + r) * dim + (i - r * dim)]));
    }
    q_s[i] = v;
  }

  float v0 = kNegInf, v1 = kNegInf;  // running top-k of query `warp`
  int i0 = -1, i1 = -1;

  const int my_row = tid % kRowsTileQ;
  const int my_q = (tid / kRowsTileQ) * 4;

  for (int base = row_begin; base < row_end; base += kRowsTileQ) {
    for (int i = tid; i < kRowsTileQ * vec_per_row; i += kThreads) {
      const int r = i / vec_per_row;
      const int c = (i - r * vec_per_row) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (base + r < row_end) {
        v = *reinterpret_cast<const uint4*>(
            g + static_cast<size_t>(base + r) * dim + c);
      }
      *reinterpret_cast<uint4*>(g_s + r * ld + c) = v;
    }
    __syncthreads();  // tile staged; previous tile's merge is done

    {
      const uint4* gr = reinterpret_cast<const uint4*>(g_s + my_row * ld);
      const float* qa = q_s + my_q * dim;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c = 0; c < vec_per_row; ++c) {
        const uint4 gv = gr[c];
        const unsigned words[4] = {gv.x ^ 0x80808080u, gv.y ^ 0x80808080u,
                                   gv.z ^ 0x80808080u, gv.w ^ 0x80808080u};
#pragma unroll
        for (int wi = 0; wi < 4; ++wi) {
          float gf[4];
          unpack4(words[wi], gf);
#pragma unroll
          for (int qi = 0; qi < 4; ++qi) {
            const float4 x = *reinterpret_cast<const float4*>(
                qa + qi * dim + c * 16 + wi * 4);
            acc[qi] = fmaf(x.x, gf[0], acc[qi]);
            acc[qi] = fmaf(x.y, gf[1], acc[qi]);
            acc[qi] = fmaf(x.z, gf[2], acc[qi]);
            acc[qi] = fmaf(x.w, gf[3], acc[qi]);
          }
        }
      }
      const int row = base + my_row;
      const float sc = row < row_end ? scales[row] : 0.f;
#pragma unroll
      for (int qi = 0; qi < 4; ++qi) {
        s_s[(my_q + qi) * kRowsTileQ + my_row] = acc[qi] * sc;
      }
    }
    __syncthreads();  // score tile complete

#pragma unroll
    for (int part = 0; part < kRowsTileQ / 32; ++part) {
      const int col = lane + part * 32;
      const int row = base + col;
      offer(s_s[warp * kRowsTileQ + col], row, row < row_end, k, lane, v0, i0,
            v1, i1);
    }
  }

  const int qrow = q0 + warp;
  if (qrow < n_q) {
    const size_t at = (static_cast<size_t>(qrow) * splits + split) * k;
    write_list(vals + at, idx + at, k, lane, v0, i0, v1, i1);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  The Python wrapper checks
// dtype, shape, contiguity, k <= 64 and D % 4 == 0, and allocates the
// [n_q, splits, k] partial lists when splits > 1 (they are unused with one
// split).  Rows at or past valid_gallery are never scored.  Returns
// cudaError_t.
extern "C" int topk_similarity_f32(const void* q, const void* g, void* vals,
                                   void* idx, void* part_vals, void* part_idx,
                                   int n_q, int n_g, int dim, int k,
                                   int valid_gallery, int splits,
                                   void* stream) {
  const size_t smem = sizeof(float) * (kQueries * dim +
                                       kRowsTile * (dim + 4) +
                                       kQueries * kRowsTile);
  cudaError_t err = cudaFuncSetAttribute(
      topk_similarity_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_rows = valid_gallery < n_g ? valid_gallery : n_g;
  // splits cover n_rows in whole tiles
  const int tiles = (n_rows + kRowsTile - 1) / kRowsTile;
  const int rows_per_split = ((tiles + splits - 1) / splits) * kRowsTile;
  const int q_tiles = (n_q + kQueries - 1) / kQueries;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* first_vals = static_cast<float*>(splits > 1 ? part_vals : vals);
  int* first_idx = static_cast<int*>(splits > 1 ? part_idx : idx);
  topk_similarity_kernel<<<dim3(q_tiles, splits), kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(g), first_vals,
      first_idx, n_q, n_rows, dim, k, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  merge_kernel<<<q_tiles, kThreads, 0, s>>>(
      first_vals, first_idx, static_cast<float*>(vals),
      static_cast<int*>(idx), n_q, splits, k);
  return static_cast<int>(cudaGetLastError());
}

// Plain C entry point of the int8 kernel (bound with ctypes): as above, with
// an int8 gallery, its per-row f32 scales, and D % 16 == 0.  Returns
// cudaError_t.
extern "C" int topk_similarity_int8(const void* q, const void* g,
                                    const void* scales, void* vals, void* idx,
                                    void* part_vals, void* part_idx, int n_q,
                                    int n_g, int dim, int k, int valid_gallery,
                                    int splits, void* stream) {
  const size_t smem = sizeof(float) * kQueries * dim +
                      static_cast<size_t>(kRowsTileQ) * (dim + 16) +
                      sizeof(float) * kQueries * kRowsTileQ;
  cudaError_t err = cudaFuncSetAttribute(
      topk_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_rows = valid_gallery < n_g ? valid_gallery : n_g;
  const int tiles = (n_rows + kRowsTileQ - 1) / kRowsTileQ;
  const int rows_per_split = ((tiles + splits - 1) / splits) * kRowsTileQ;
  const int q_tiles = (n_q + kQueries - 1) / kQueries;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* first_vals = static_cast<float*>(splits > 1 ? part_vals : vals);
  int* first_idx = static_cast<int*>(splits > 1 ? part_idx : idx);
  topk_int8_kernel<<<dim3(q_tiles, splits), kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const signed char*>(g),
      static_cast<const float*>(scales), first_vals, first_idx, n_q, n_rows,
      dim, k, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  merge_kernel<<<q_tiles, kThreads, 0, s>>>(
      first_vals, first_idx, static_cast<float*>(vals),
      static_cast<int*>(idx), n_q, splits, k);
  return static_cast<int>(cudaGetLastError());
}
