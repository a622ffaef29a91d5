// int8_matmul_requant_rows16 (K8 on a 16-row tile) and int8_ffn (K7):
// int8 x int8 -> int32 products with the decode, quickGELU and per-row
// requant done on the output tile before anything reaches device memory.
// K8's main kernel is int8_mm_sm90.cu (W resident across a cluster, wgmma);
// ops/int8_mm.py:matmul_plan sends the shapes it does not take here.
//
// Replaces: textreid_tpu/ops/int8_mm_pallas.py:fused_int8_matmul_requant
// (Pallas kernel _kernel) and :fused_int8_ffn (_ffn_kernel).  Contract
// (ops/int8_mm.py), exact integer accumulation, then f32:
//   y  = (f32(x @ w) * s_w[n]) * r_row[m] + b[n]   [gelu: y / (1 + exp(-1.702 y))]
//   xn = y * (1 / s_next[n]);  r = max(max_n |xn|, 1e-6) * (1 / 127)
//   q  = truncate(clip(xn * (1 / r) +- 0.5, +-127))                  K8: q, r out
//   z  = (f32(q @ w2) * s_w2[j]) * r;  out = cast(z) + cast(b2[j])   K7: out
// x [rows, K] int8; the weights arrive transposed, w_t [N, K] and
// w2_t [M, N] int8, so each output channel's contraction is contiguous.
// The f32 steps are spelled with __fmul_rn / __fadd_rn: no a*b+c is
// contracted into an FMA.
//
// What bounds it on the H100: operations by the roofline (2 rows K N, or
// 2 rows N (K + M), s8 operations against 1,979 TOP/s), but a kernel whose
// block owns 16 rows is bound by the weights' traffic from L2: every block
// reads every weight once, 32 operations a byte (3.6 GB a call at the ViT's
// c_fc, some 4 TB/s of L2 reads at 0.88 ms).
//
// The 16-row K8 (it serves the shapes int8_mm_sm90.cu does not take, and is
// timed against it), and the 16-row K7 kept for comparison
// (int8_ffn_rows16).  The row's abs-max needs all N outputs of the row
// before one can be rounded, and the value rounded must be the f32 value
// whose max was taken.  A row of f32 is up to 12 KB, so a block owns ONE
// mma.sync row tile of 16 rows and keeps its whole f32 middle [16, N] in
// shared memory (197 KB at N = 3072), with the int8 input tile beside it.  The TPU kernel's resident [K, N]
// weight does not fit an SM: the weights stream from L2 (2.4 MB, or 2 x 1
// MB, stay there across blocks) straight into the B fragments.  16 warps
// split the output columns in groups of 32 (the loads of 16 warps in flight
// hide L2's latency where 8 left it bare: 1.43 -> 0.88 ms at the ViT's
// c_fc); a warp walks K in chunks of 64 with one 16-byte load a lane for A
// (shared memory) and one for each of its B tiles (global), then two
// mma.sync.m16n8k32.s8 a tile.  A fragment's 32 k-slots are filled from 16
// contiguous bytes of a 64-byte chunk, the same ones for A and B: the
// integer sum does not care about the order of k.  The 16-row K7 then
// rounds the middle to int8 in place, row after row, and runs the second
// product from shared memory the same way.  Rows past the end are
// zero-filled and never written.
//
// K7's design (int8_ffn, ffn_cluster_kernel below): the f32 middle of a
// tile of R = 64 rows is split over a thread block cluster, so that each
// weight byte read from L2 serves 64 rows instead of 16.  A cluster of C =
// ceil(N / 512) blocks (4 at the text FFN, 6 at the ViT's) owns the tile;
// block c computes middle columns [512 c, 512 c + 512) for all R rows (its
// f32 slice, 128 KB), takes its partial row maxima of |xn|, and the blocks
// read each other's through distributed shared memory, so each rounds its
// slice with the row scale of the whole row (a max is exact in any order).
// The second product is a sum over the N middle columns: block c forms the
// exact s32 partial q[:, slice c] @ w2[slice c, :] one output slice of M / C
// columns at a time, round a ring (at step i it stages the partial for
// block c + i, and adds the one block c - i staged for it; two stage
// buffers, one cluster barrier a step, split into arrive and wait with the
// next step's partial computed between them), then decodes and stores its
// own M / C columns.  The int8 middle and the integer sums are the 16-row
// kernel's, so the output is the same bit for bit.  16 warps (128
// registers a thread) in two halves of 8, each half on 32 of the rows: a B
// fragment loaded from L2 serves two row tiles of 16 (the two halves load
// it apart, mostly from L1).  The input tile arrives by cp.async, all of it
// in flight at once.  Shared memory at R = 64
// (ops/int8_mm.py:ffn_shared_bytes): 175 KB (text), 191 KB (ViT); the s32
// partials reuse the f32 middle's place, the int8 middle the input's.  The
// weight slices stream from L2 into the B fragments, as in the 16-row
// kernel: more chunks in flight did not help (tools/int8_variants.py), so
// no shared-memory ring is built.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W, bf16 out; chip_smoke.py, in turns
// with the 16-row kernel): text FFN, 25,600 rows, 0.594 ms (16-row 0.785;
// 0.84 GB of L2 weight reads against 3.36); ViT FFN, 24,704 rows, 1.282 ms
// (1.298), where the clusters of 6 leave some 24 of the 132 SMs idle.  The
// first version (8 warps on all 64 rows, full cluster barriers) took 0.777
// and 1.625 ms: the lower L2 traffic alone moved nothing.  Of the 0.59 ms,
// the first product with its epilogue takes ~0.21 (the GELU's exp and
// reciprocal ~0.08), the second ~0.16, and the rest (copies, requant, ring
// exchange, stores) ~0.21 (tools/int8_variants.py, "wrong" variants).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBM = 16;       // rows a block owns
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kNT = 4;        // 8-column tiles a warp carries, first product
constexpr int kMaxQuads = 2;  // N <= 4096: float4s a thread holds of one row
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Padded so that the 8 rows a warp reads 16 bytes a lane from fall into
// different banks.
__device__ __host__ __forceinline__ int int8_stride(int depth) {
  return depth + ((depth % 128 == 0) ? 64 : 0);
}

// acc[t] (16 x 8, the mma.sync C layout) = a_s[16, depth] x w_t[cols of tile
// t, depth]^T for the NT tiles from column n_base on.
template <int NT>
__device__ __forceinline__ void tile_product(
    const int8_t* a_s, int a_stride, const int8_t* __restrict__ w_t,
    int depth, int ncols, int n_base, int lane, int (&acc)[NT][4]) {
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int8_t* a_lo = a_s + gid * a_stride + tig * 16;
  const int8_t* a_hi = a_lo + 8 * a_stride;
  const int8_t* bp[NT];
  bool live[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int col = n_base + t * 8 + gid;
    live[t] = col < ncols;
    bp[t] = w_t + static_cast<size_t>(live[t] ? col : 0) * depth + tig * 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = 0;
  }
#pragma unroll 2
  for (int k = 0; k < depth; k += 64) {
    const uint4 lo = *reinterpret_cast<const uint4*>(a_lo + k);
    const uint4 hi = *reinterpret_cast<const uint4*>(a_hi + k);
    uint4 b[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t)
      b[t] = live[t] ? __ldg(reinterpret_cast<const uint4*>(bp[t] + k))
                     : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      mma_s8(acc[t], lo.x, hi.x, lo.y, hi.y, b[t].x, b[t].y);
      mma_s8(acc[t], lo.z, hi.z, lo.w, hi.w, b[t].z, b[t].w);
    }
  }
}

__device__ __forceinline__ uint32_t quantize(float xn, float inv_r) {
  float v = __fmul_rn(xn, inv_r);
  v = __fadd_rn(v, v >= 0.0f ? 0.5f : -0.5f);
  v = fminf(fmaxf(v, -127.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<int>(v)) & 0xffu;
}

__device__ __forceinline__ uint32_t quantize4(float4 v, float inv_r) {
  return quantize(v.x, inv_r) | (quantize(v.y, inv_r) << 8) |
         (quantize(v.z, inv_r) << 16) | (quantize(v.w, inv_r) << 24);
}

// Shared memory of a block, carved from one dynamic allocation.
struct Tile {
  float* mid;       // [kBM][n + 8] f32: xn, then (K7) the int8 g in place
  int8_t* xs;       // [kBM][int8_stride(k)]
  float* inv_next;  // [n]: 1 / s_next
  float* warp_max;  // [kWarps][kBM]
  float* r_in;      // [kBM]: the input's row scale (0 past the end)
  float* r_mid;     // [kBM]: the middle's row scale
  int mid_stride;
  int xs_stride;
};

__device__ __forceinline__ Tile carve(float4* smem4, int k, int n) {
  Tile t;
  t.mid_stride = n + 8;
  t.xs_stride = int8_stride(k);
  t.mid = reinterpret_cast<float*>(smem4);
  t.inv_next = t.mid + kBM * t.mid_stride;
  t.warp_max = t.inv_next + n;
  t.r_in = t.warp_max + kWarps * kBM;
  t.r_mid = t.r_in + kBM;
  t.xs = reinterpret_cast<int8_t*>(t.r_mid + kBM);
  return t;
}

size_t tile_bytes(int k, int n) {
  return sizeof(float) * (kBM * (n + 8) + n + (kWarps + 2) * kBM) +
         static_cast<size_t>(kBM) * int8_stride(k);
}

// Load the block's rows, run the first product with its epilogue into
// tile.mid (xn, f32) and leave each row's scale in tile.r_mid.
__device__ __forceinline__ void first_product(
    const Tile& tile, const int8_t* __restrict__ x,
    const int8_t* __restrict__ w_t, const float* __restrict__ s_w,
    const float* __restrict__ b, const float* __restrict__ r_row,
    const float* __restrict__ s_next, int rows, int k, int n, int gelu,
    int row0) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;

  const int chunks = k / 16;  // 16-byte pieces of a row
  for (int i = threadIdx.x; i < kBM * chunks; i += kThreads) {
    const int r = i / chunks;
    const int c = (i - r * chunks) * 16;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows)
      v = *reinterpret_cast<const uint4*>(
          x + static_cast<size_t>(row0 + r) * k + c);
    *reinterpret_cast<uint4*>(tile.xs + r * tile.xs_stride + c) = v;
  }
  for (int i = threadIdx.x; i < n; i += kThreads)
    tile.inv_next[i] = __frcp_rn(s_next[i]);
  if (threadIdx.x < kBM)
    tile.r_in[threadIdx.x] =
        row0 + threadIdx.x < rows ? r_row[row0 + threadIdx.x] : 0.0f;
  __syncthreads();

  float m_lo = 0.0f, m_hi = 0.0f;  // |xn| max of rows gid and gid + 8
  const float r_lo = tile.r_in[gid], r_hi = tile.r_in[gid + 8];
  const int groups = (n + 8 * kNT - 1) / (8 * kNT);
  for (int g = warp; g < groups; g += kWarps) {
    const int n_base = g * 8 * kNT;
    int acc[kNT][4];
    tile_product<kNT>(tile.xs, tile.xs_stride, w_t, k, n, n_base, lane, acc);
#pragma unroll
    for (int t = 0; t < kNT; ++t) {
      const int col = n_base + t * 8 + tig * 2;
      if (col >= n) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = col + (i & 1);
        const bool hi = i >= 2;
        float y = __fmul_rn(__int2float_rn(acc[t][i]), s_w[c]);
        y = __fadd_rn(__fmul_rn(y, hi ? r_hi : r_lo), b[c]);
        if (gelu) {
          const float u = __fmul_rn(1.702f, y);
          y = __fmul_rn(y, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-u))));
        }
        const float xn = __fmul_rn(y, tile.inv_next[c]);
        tile.mid[(gid + (hi ? 8 : 0)) * tile.mid_stride + c] = xn;
        if (hi) {
          m_hi = fmaxf(m_hi, fabsf(xn));
        } else {
          m_lo = fmaxf(m_lo, fabsf(xn));
        }
      }
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, o));
    m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, o));
  }
  if (tig == 0) {
    tile.warp_max[warp * kBM + gid] = m_lo;
    tile.warp_max[warp * kBM + gid + 8] = m_hi;
  }
  __syncthreads();
  if (threadIdx.x < kBM) {
    float m = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      m = fmaxf(m, tile.warp_max[w * kBM + threadIdx.x]);
    tile.r_mid[threadIdx.x] = __fmul_rn(fmaxf(m, 1e-6f), kInv127);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
matmul_requant_kernel(const int8_t* __restrict__ x,
                      const int8_t* __restrict__ w_t,
                      const float* __restrict__ s_w,
                      const float* __restrict__ b,
                      const float* __restrict__ r_row,
                      const float* __restrict__ s_next,
                      int8_t* __restrict__ q, float* __restrict__ r_out,
                      int rows, int k, int n, int gelu) {
  extern __shared__ float4 smem4[];
  const Tile tile = carve(smem4, k, n);
  const int row0 = blockIdx.x * kBM;
  first_product(tile, x, w_t, s_w, b, r_row, s_next, rows, k, n, gelu, row0);

  const int quads = n / 4;
  for (int i = threadIdx.x; i < kBM * quads; i += kThreads) {
    const int r = i / quads;
    const int c = (i - r * quads) * 4;
    if (row0 + r >= rows) break;  // rows ascend with i
    const float inv_r = __frcp_rn(tile.r_mid[r]);
    const float4 v =
        *reinterpret_cast<const float4*>(tile.mid + r * tile.mid_stride + c);
    *reinterpret_cast<uint32_t*>(q + static_cast<size_t>(row0 + r) * n + c) =
        quantize4(v, inv_r);
  }
  if (threadIdx.x < kBM && row0 + threadIdx.x < rows)
    r_out[row0 + threadIdx.x] = tile.r_mid[threadIdx.x];
}

__device__ __forceinline__ void store2(float* p, float z0, float z1, float b0,
                                       float b1) {
  *reinterpret_cast<float2*>(p) =
      make_float2(__fadd_rn(z0, b0), __fadd_rn(z1, b1));
}

// cast z to bf16, then add the bf16 bias in bf16
__device__ __forceinline__ void store2(__nv_bfloat16* p, float z0, float z1,
                                       float b0, float b1) {
  const float y0 = __fadd_rn(__bfloat162float(__float2bfloat16_rn(z0)),
                             __bfloat162float(__float2bfloat16_rn(b0)));
  const float y1 = __fadd_rn(__bfloat162float(__float2bfloat16_rn(z1)),
                             __bfloat162float(__float2bfloat16_rn(b1)));
  __nv_bfloat162 v;
  v.x = __float2bfloat16_rn(y0);
  v.y = __float2bfloat16_rn(y1);
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

template <typename T, int NT2>
__global__ void __launch_bounds__(kThreads)
ffn_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w1_t,
           const float* __restrict__ s_w1, const float* __restrict__ b1,
           const float* __restrict__ r_row, const float* __restrict__ s_mid,
           const int8_t* __restrict__ w2_t, const float* __restrict__ s_w2,
           const float* __restrict__ b2, T* __restrict__ out, int rows, int k,
           int n, int m_out) {
  extern __shared__ float4 smem4[];
  const Tile tile = carve(smem4, k, n);
  const int row0 = blockIdx.x * kBM;
  first_product(tile, x, w1_t, s_w1, b1, r_row, s_mid, rows, k, n, 1, row0);

  // Round the middle to int8 in place.  Row r's int8 bytes end before row
  // r + 1's floats begin, so a row is read by every thread, then written.
  int8_t* g_s = reinterpret_cast<int8_t*>(tile.mid);
  const int g_stride = int8_stride(n);
  const int quads = n / 4;
  for (int r = 0; r < kBM; ++r) {
    float4 v[kMaxQuads];
#pragma unroll
    for (int i = 0; i < kMaxQuads; ++i) {
      const int at = threadIdx.x + i * kThreads;
      if (at < quads)
        v[i] = *reinterpret_cast<const float4*>(
            tile.mid + r * tile.mid_stride + at * 4);
    }
    __syncthreads();
    const float inv_r = __frcp_rn(tile.r_mid[r]);
#pragma unroll
    for (int i = 0; i < kMaxQuads; ++i) {
      const int at = threadIdx.x + i * kThreads;
      if (at < quads)
        *reinterpret_cast<uint32_t*>(g_s + r * g_stride + at * 4) =
            quantize4(v[i], inv_r);
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const float r_lo = tile.r_mid[gid], r_hi = tile.r_mid[gid + 8];
  const int groups = (m_out + 8 * NT2 - 1) / (8 * NT2);
  for (int g = warp; g < groups; g += kWarps) {
    const int n_base = g * 8 * NT2;
    int acc[NT2][4];
    tile_product<NT2>(g_s, g_stride, w2_t, n, m_out, n_base, lane, acc);
#pragma unroll
    for (int t = 0; t < NT2; ++t) {
      const int col = n_base + t * 8 + tig * 2;
      if (col >= m_out) continue;
      const float s0 = s_w2[col], s1 = s_w2[col + 1];
      const float c0 = b2[col], c1 = b2[col + 1];
      if (row0 + gid < rows)
        store2(out + static_cast<size_t>(row0 + gid) * m_out + col,
               __fmul_rn(__fmul_rn(__int2float_rn(acc[t][0]), s0), r_lo),
               __fmul_rn(__fmul_rn(__int2float_rn(acc[t][1]), s1), r_lo), c0,
               c1);
      if (row0 + gid + 8 < rows)
        store2(out + static_cast<size_t>(row0 + gid + 8) * m_out + col,
               __fmul_rn(__fmul_rn(__int2float_rn(acc[t][2]), s0), r_hi),
               __fmul_rn(__fmul_rn(__int2float_rn(acc[t][3]), s1), r_hi), c0,
               c1);
    }
  }
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int NT2>
cudaError_t launch_ffn(const void* x, const void* w1_t, const void* s_w1,
                       const void* b1, const void* r_row, const void* s_mid,
                       const void* w2_t, const void* s_w2, const void* b2,
                       void* out, int rows, int k, int n, int m_out,
                       cudaStream_t stream) {
  const size_t smem = tile_bytes(k, n);
  auto kernel = ffn_kernel<T, NT2>;
  const cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(rows + kBM - 1) / kBM, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w1_t),
      static_cast<const float*>(s_w1), static_cast<const float*>(b1),
      static_cast<const float*>(r_row), static_cast<const float*>(s_mid),
      static_cast<const int8_t*>(w2_t), static_cast<const float*>(s_w2),
      static_cast<const float*>(b2), static_cast<T*>(out), rows, k, n, m_out);
  return cudaGetLastError();
}

// Tiles a warp carries in the second product: of 4, 6 and 8 the one whose
// rounds over the warps cost least (rounds x tiles), the larger on a tie.
int second_tiles(int m_out) {
  int best = 4, best_cost = 1 << 30;
  for (int nt = 4; nt <= 8; nt += 2) {
    const int groups = (m_out + 8 * nt - 1) / (8 * nt);
    const int cost = ((groups + kWarps - 1) / kWarps) * nt;
    if (cost <= best_cost) {
      best = nt;
      best_cost = cost;
    }
  }
  return best;
}

template <typename T>
cudaError_t dispatch_ffn(const void* x, const void* w1_t, const void* s_w1,
                         const void* b1, const void* r_row, const void* s_mid,
                         const void* w2_t, const void* s_w2, const void* b2,
                         void* out, int rows, int k, int n, int m_out,
                         cudaStream_t stream) {
  switch (second_tiles(m_out)) {
    case 4:
      return launch_ffn<T, 4>(x, w1_t, s_w1, b1, r_row, s_mid, w2_t, s_w2, b2,
                              out, rows, k, n, m_out, stream);
    case 6:
      return launch_ffn<T, 6>(x, w1_t, s_w1, b1, r_row, s_mid, w2_t, s_w2, b2,
                              out, rows, k, n, m_out, stream);
    default:
      return launch_ffn<T, 8>(x, w1_t, s_w1, b1, r_row, s_mid, w2_t, s_w2, b2,
                              out, rows, k, n, m_out, stream);
  }
}

// ---- K7 on a tile of R rows split over a thread block cluster -------------
//
// A cluster of C = ceil(N / 512) blocks owns R rows (64 at both towers'
// FFNs).  Block c computes the middle columns [c S, c S + S), S = N / C, for
// all R rows; the blocks swap their row maxima of |xn| through distributed
// shared memory, so each rounds its slice with the row scale of the whole
// row; then the second product's depth is the block's slice, and the
// partial sums for output columns [d P, d P + P), P = M / C, go round the
// cluster as a ring: at step i block c computes the partial for d = c + i
// (mod C) into its own stage buffer, and block d adds the one that block
// d - i staged.  Max and integer sums are exact in any order, so the int8
// middle and the output equal the 16-row kernel's bit for bit.  Each
// block reads its slice of both weights once a tile: the L2 traffic of the
// weights falls by R / 16.

// 16 warps (128 registers a thread) in two halves of 8: half h works on
// rows [h R / 2, h R / 2 + R / 2) of the tile, so a tile has 32 or 64 rows
constexpr int kCWarps = 16;
constexpr int kCThreads = kCWarps * 32;
constexpr int kHalves = 2;
constexpr int kHalfWarps = kCWarps / kHalves;
constexpr int kSliceCols = 512;     // middle columns a block owns, at most
constexpr int kMaxOutSlice = 128;   // output columns a block owns, at most
constexpr int kSmemMax = 232448;    // bytes of shared memory a block can take
constexpr int kTileRows[2] = {64, 32};

int ffn_blocks(int n) { return (n + kSliceCols - 1) / kSliceCols; }

// Shared memory of a block of the cluster kernel at R rows (mirrored by
// ops/int8_mm.py:ffn_shared_bytes): region A holds the f32 middle [R][S + 8],
// later the s32 partials [3][R][P + 8] (scratch, two stages); region B the
// int8 input [R][int8_stride(K)], later the int8 middle [R][int8_stride(S)];
// then the consumer scales [S] and the row statistics (each row's maxima
// from the kHalfWarps warps of its half, its input and middle scales, and
// the block's maxima that its peers read).
size_t ffn_bytes(int k, int n, int m_out, int r) {
  const int c = ffn_blocks(n);
  const size_t s = n / c, p = m_out / c;
  const size_t a = 4 * r * (s + 8) > 12 * r * (p + 8) ? 4 * r * (s + 8)
                                                      : 12 * r * (p + 8);
  const size_t b = static_cast<size_t>(r) *
      (int8_stride(k) > int8_stride(static_cast<int>(s))
           ? int8_stride(k) : int8_stride(static_cast<int>(s)));
  return a + b + 4 * (s + (kHalfWarps + 3) * static_cast<size_t>(r));
}

// Rows a tile: the larger of 64 and 32 that fits (0: neither does).
int ffn_rows(int k, int n, int m_out) {
  for (int r : kTileRows)
    if (ffn_bytes(k, n, m_out, r) <= static_cast<size_t>(kSmemMax)) return r;
  return 0;
}

// 16 bytes of global memory into shared memory without a register, zeros
// where !valid (the source is then not read)
__device__ __forceinline__ void copy16_async(void* dst, const void* src,
                                             bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// the cluster barrier in two halves: what a block does between them
// overlaps the wait for its peers
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// acc[mt][t] (16 x 8, the mma.sync C layout) = a_s[16 mt + 16 rows, depth] x
// w[8 t + 8 rows, depth]^T, NT tiles of 8 columns from `w`, whose rows are
// w_stride bytes apart.  Each B fragment, loaded once from L2, serves the
// kMT row tiles.
template <int kMT, int NT>
__device__ __forceinline__ void rows_product(
    const int8_t* a_s, int a_stride, const int8_t* __restrict__ w,
    int w_stride, int depth, int lane, int (&acc)[kMT][NT][4]) {
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int8_t* a0 = a_s + gid * a_stride + tig * 16;
  const int8_t* bp[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    bp[t] = w + static_cast<size_t>(t * 8 + gid) * w_stride + tig * 16;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][t][i] = 0;
  }
#pragma unroll 2
  for (int k = 0; k < depth; k += 64) {
    uint4 b[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t)
      b[t] = __ldg(reinterpret_cast<const uint4*>(bp[t] + k));
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const uint4 lo =
          *reinterpret_cast<const uint4*>(a0 + mt * 16 * a_stride + k);
      const uint4 hi =
          *reinterpret_cast<const uint4*>(a0 + (mt * 16 + 8) * a_stride + k);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        mma_s8(acc[mt][t], lo.x, hi.x, lo.y, hi.y, b[t].x, b[t].y);
        mma_s8(acc[mt][t], lo.z, hi.z, lo.w, hi.w, b[t].z, b[t].w);
      }
    }
  }
}

// Grid: tiles x C blocks, cluster dims (C, 1, 1) at launch.
template <typename T, int kMT>
__global__ void __launch_bounds__(kCThreads, 1)
ffn_cluster_kernel(const int8_t* __restrict__ x,
                   const int8_t* __restrict__ w1_t,
                   const float* __restrict__ s_w1,
                   const float* __restrict__ b1,
                   const float* __restrict__ r_row,
                   const float* __restrict__ s_mid,
                   const int8_t* __restrict__ w2_t,
                   const float* __restrict__ s_w2,
                   const float* __restrict__ b2, T* __restrict__ out,
                   int rows, int k, int n, int m_out) {
  constexpr int R = 16 * kMT;
  constexpr int kMTH = kMT / kHalves;  // row tiles of a half
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int c = static_cast<int>(cluster.block_rank());
  const int row0 = (blockIdx.x / csize) * R;
  const int s = n / csize;       // middle columns [col0, col0 + s)
  const int p = m_out / csize;   // output columns [c p, c p + p)
  const int col0 = c * s;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int hw = warp % kHalfWarps;               // warp of its half
  const int hrow = (warp / kHalfWarps) * (R / kHalves);  // the half's rows

  extern __shared__ float4 smem4[];
  const int mid_stride = s + 8;
  const int part_stride = p + 8;
  const int region_a = max(R * mid_stride, 3 * R * part_stride);  // words
  float* mid = reinterpret_cast<float*>(smem4);
  int* part = reinterpret_cast<int*>(smem4);  // after the requant
  float* inv_next = mid + region_a;
  float* warp_max = inv_next + s;
  float* r_in = warp_max + kHalfWarps * R;
  float* r_mid = r_in + R;
  float* pmax = r_mid + R;
  int8_t* xs = reinterpret_cast<int8_t*>(pmax + R);
  const int xs_stride = int8_stride(k);
  int8_t* g_s = xs;  // after the first product
  const int g_stride = int8_stride(s);

  // the input tile by asynchronous copies, all in flight at once (rows
  // past the end as zeros), while the scales load
  const int chunks = k / 16;  // 16-byte pieces of a row
  for (int i = threadIdx.x; i < R * chunks; i += kCThreads) {
    const int r = i / chunks;
    const int cc = (i - r * chunks) * 16;
    const bool valid = row0 + r < rows;
    copy16_async(xs + r * xs_stride + cc,
                 x + (valid ? static_cast<size_t>(row0 + r) * k + cc : 0),
                 valid);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#pragma unroll 4
  for (int i = threadIdx.x; i < s; i += kCThreads)
    inv_next[i] = __frcp_rn(s_mid[col0 + i]);
  if (threadIdx.x < R)
    r_in[threadIdx.x] =
        row0 + threadIdx.x < rows ? r_row[row0 + threadIdx.x] : 0.0f;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 1. the first product on the block's middle columns, with the decode,
  // quickGELU and / s_mid of the 16-row kernel, into `mid`
  float mx[kMTH][2];
#pragma unroll
  for (int mt = 0; mt < kMTH; ++mt) mx[mt][0] = mx[mt][1] = 0.0f;
  for (int g = hw; g < s / 32; g += kHalfWarps) {
    const int n_base = g * 32;
    int acc[kMTH][4][4];
    rows_product<kMTH, 4>(xs + hrow * xs_stride, xs_stride,
                          w1_t + static_cast<size_t>(col0 + n_base) * k, k, k,
                          lane, acc);
    // the scales of this thread's 8 columns and 2 kMTH rows, loaded once
    float sw[4][2], bias[4][2], inv[4][2], rin[kMTH][2];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n_base + t * 8 + tig * 2 + e;
        sw[t][e] = s_w1[col0 + col];
        bias[t][e] = b1[col0 + col];
        inv[t][e] = inv_next[col];
      }
#pragma unroll
    for (int mt = 0; mt < kMTH; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) rin[mt][h] = r_in[hrow + mt * 16 + gid + 8 * h];
#pragma unroll
    for (int mt = 0; mt < kMTH; ++mt) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = n_base + t * 8 + tig * 2 + (i & 1);
          const int hi = i >> 1;
          const int row = hrow + mt * 16 + gid + 8 * hi;
          float y = __fmul_rn(__int2float_rn(acc[mt][t][i]), sw[t][i & 1]);
          y = __fadd_rn(__fmul_rn(y, rin[mt][hi]), bias[t][i & 1]);
          const float u = __fmul_rn(1.702f, y);
          // 1 / (1 + e^-u) correctly rounded, as __fdiv_rn(1, .) gives it
          y = __fmul_rn(y, __frcp_rn(__fadd_rn(1.0f, expf(-u))));
          const float xn = __fmul_rn(y, inv[t][i & 1]);
          mid[row * mid_stride + col] = xn;
          mx[mt][hi] = fmaxf(mx[mt][hi], fabsf(xn));
        }
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < kMTH; ++mt) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx[mt][0] = fmaxf(mx[mt][0], __shfl_xor_sync(0xffffffffu, mx[mt][0], o));
      mx[mt][1] = fmaxf(mx[mt][1], __shfl_xor_sync(0xffffffffu, mx[mt][1], o));
    }
    if (tig == 0) {  // the halves' rows do not meet: one slot a warp of a half
      warp_max[hw * R + hrow + mt * 16 + gid] = mx[mt][0];
      warp_max[hw * R + hrow + mt * 16 + gid + 8] = mx[mt][1];
    }
  }
  __syncthreads();
  if (threadIdx.x < R) {
    float m = 0.0f;
#pragma unroll
    for (int w = 0; w < kHalfWarps; ++w)
      m = fmaxf(m, warp_max[w * R + threadIdx.x]);
    pmax[threadIdx.x] = m;
  }
  cluster.sync();  // every block's row maxima are in its pmax
  if (threadIdx.x < R) {
    float part_max[8];
#pragma unroll
    for (int peer = 0; peer < 8; ++peer)
      part_max[peer] = peer < csize
          ? cluster.map_shared_rank(pmax, peer)[threadIdx.x] : 0.0f;
    float m = 0.0f;
#pragma unroll
    for (int peer = 0; peer < 8; ++peer) m = fmaxf(m, part_max[peer]);
    r_mid[threadIdx.x] = __fmul_rn(fmaxf(m, 1e-6f), kInv127);
  }
  __syncthreads();

  // 2. the block's slice of the middle to int8, over the consumed input: a
  // warp a row at a time, the row's reciprocal scale taken once
  for (int r = warp; r < R; r += kCWarps) {
    const float inv_r = __frcp_rn(r_mid[r]);
    for (int cc = lane * 4; cc < s; cc += 128) {
      const float4 v = *reinterpret_cast<const float4*>(mid + r * mid_stride
                                                        + cc);
      *reinterpret_cast<uint32_t*>(g_s + r * g_stride + cc) =
          quantize4(v, inv_r);
    }
  }
  __syncthreads();  // g_s complete; `mid` is free for the partial sums

  // 3. the second product over the block's slice of depth, one output slice
  // d at a time round the ring.  Warp hw of a half takes its rows' column
  // group hw % groups of 32 and, where the depth splits in two halves of a
  // multiple of 64 and the warps suffice, depth half hw / groups; the upper
  // half's sums meet the lower's in `scratch`.  The partial of step i + 1
  // is computed between the two halves of step i's cluster barrier.
  const int groups = p / 32;
  const int ksplit = (s % 128 == 0 && 2 * groups <= kHalfWarps) ? 2 : 1;
  const int depth = s / ksplit;
  const int g2 = hw % groups;
  const int kh = hw / groups;
  const int plane = R * part_stride;
  int* scratch = part;
  const int quads2 = R * p / 4;
  const int qrow = p / 4;  // quads of a row of an output slice
  // this warp's columns and depth of w2_t; output slice d is d p rows on
  const int8_t* w2_warp =
      w2_t + static_cast<size_t>(g2 * 32) * n + col0 + kh * depth;
  const int8_t* g_half = g_s + hrow * g_stride + kh * depth;
  constexpr int kQuads = R * kMaxOutSlice / 4 / kCThreads;  // a thread's, at most
  int sum[kQuads][4];
#pragma unroll
  for (int j = 0; j < kQuads; ++j) sum[j][0] = sum[j][1] = sum[j][2] =
      sum[j][3] = 0;
  int acc[kMTH][4][4];
  if (kh < ksplit)  // step 0: this block's own output slice
    rows_product<kMTH, 4>(g_half, g_stride,
                          w2_warp + static_cast<size_t>(c * p) * n, n, depth,
                          lane, acc);
  for (int i = 0; i < csize; ++i) {
    int* stage = part + (1 + (i & 1)) * plane;
    if (kh == 1) {
#pragma unroll
      for (int mt = 0; mt < kMTH; ++mt)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          int* at = scratch + (hrow + mt * 16 + gid) * part_stride + g2 * 32
                    + t * 8 + tig * 2;
          *reinterpret_cast<int2*>(at) =
              make_int2(acc[mt][t][0], acc[mt][t][1]);
          *reinterpret_cast<int2*>(at + 8 * part_stride) =
              make_int2(acc[mt][t][2], acc[mt][t][3]);
        }
    }
    __syncthreads();  // the upper half's sums are in `scratch`
    if (kh == 0) {
#pragma unroll
      for (int mt = 0; mt < kMTH; ++mt)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int off = (hrow + mt * 16 + gid) * part_stride + g2 * 32
                          + t * 8 + tig * 2;
          int2 lo = make_int2(acc[mt][t][0], acc[mt][t][1]);
          int2 hi = make_int2(acc[mt][t][2], acc[mt][t][3]);
          if (ksplit == 2) {
            const int2 a = *reinterpret_cast<const int2*>(scratch + off);
            const int2 b = *reinterpret_cast<const int2*>(
                scratch + off + 8 * part_stride);
            lo.x += a.x;
            lo.y += a.y;
            hi.x += b.x;
            hi.y += b.y;
          }
          *reinterpret_cast<int2*>(stage + off) = lo;
          *reinterpret_cast<int2*>(stage + off + 8 * part_stride) = hi;
        }
    }
    // every block's partial of step i is staged once all have arrived; a
    // stage is written again two steps on, after every peer has read it
    cluster_arrive();
    if (i + 1 < csize && kh < ksplit)
      rows_product<kMTH, 4>(
          g_half, g_stride,
          w2_warp + static_cast<size_t>(((c + i + 1) % csize) * p) * n, n,
          depth, lane, acc);
    cluster_wait();
    // the partial for this block's columns, staged by block c - i
    const int* src = cluster.map_shared_rank(stage, (c - i + csize) % csize);
#pragma unroll
    for (int j = 0; j < kQuads; ++j) {
      const int q = threadIdx.x + j * kCThreads;
      if (q < quads2) {
        const int r = q / qrow;
        const int4 v = *reinterpret_cast<const int4*>(
            src + r * part_stride + (q - r * qrow) * 4);
        sum[j][0] += v.x;
        sum[j][1] += v.y;
        sum[j][2] += v.z;
        sum[j][3] += v.w;
      }
    }
  }
  cluster.sync();  // the peers are done with this block's shared memory

  // 4. decode and store this block's output columns
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
    const int q = threadIdx.x + j * kCThreads;
    if (q >= quads2) continue;
    const int r = q / qrow;
    if (row0 + r >= rows) continue;
    const int col = c * p + (q - r * qrow) * 4;
    const float rm = r_mid[r];
    T* o = out + static_cast<size_t>(row0 + r) * m_out + col;
    float z[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      z[e] = __fmul_rn(__fmul_rn(__int2float_rn(sum[j][e]), s_w2[col + e]),
                       rm);
    store2(o, z[0], z[1], b2[col], b2[col + 1]);
    store2(o + 2, z[2], z[3], b2[col + 2], b2[col + 3]);
  }
}

template <typename T, int kMT>
cudaError_t launch_cluster(const void* x, const void* w1_t, const void* s_w1,
                           const void* b1, const void* r_row,
                           const void* s_mid, const void* w2_t,
                           const void* s_w2, const void* b2, void* out,
                           int rows, int k, int n, int m_out,
                           cudaStream_t stream) {
  constexpr int R = 16 * kMT;
  const int csize = ffn_blocks(n);
  const size_t smem = ffn_bytes(k, n, m_out, R);
  auto kernel = ffn_cluster_kernel<T, kMT>;
  cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attr;
  config.gridDim = dim3(((rows + R - 1) / R) * csize, 1, 1);
  config.blockDim = dim3(kCThreads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = csize;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &config, kernel, static_cast<const int8_t*>(x),
      static_cast<const int8_t*>(w1_t), static_cast<const float*>(s_w1),
      static_cast<const float*>(b1), static_cast<const float*>(r_row),
      static_cast<const float*>(s_mid), static_cast<const int8_t*>(w2_t),
      static_cast<const float*>(s_w2), static_cast<const float*>(b2),
      static_cast<T*>(out), rows, k, n, m_out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_cluster(const void* x, const void* w1_t,
                             const void* s_w1, const void* b1,
                             const void* r_row, const void* s_mid,
                             const void* w2_t, const void* s_w2,
                             const void* b2, void* out, int rows, int k, int n,
                             int m_out, cudaStream_t stream) {
  switch (ffn_rows(k, n, m_out)) {
    case 64:
      return launch_cluster<T, 4>(x, w1_t, s_w1, b1, r_row, s_mid, w2_t, s_w2,
                                  b2, out, rows, k, n, m_out, stream);
    case 32:
      return launch_cluster<T, 2>(x, w1_t, s_w1, b1, r_row, s_mid, w2_t, s_w2,
                                  b2, out, rows, k, n, m_out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points (bound with ctypes).  K % 64 == 0, N % 64 == 0,
// N <= 4096, M % 8 == 0, the tile within the card's shared memory, x and the
// weights 16-byte aligned: the Python wrapper checks.  Return cudaError_t.
// K8 on the 16-row tile: the shapes ops/int8_mm.py:matmul_plan gives it, and
// the yardstick of int8_mm_sm90.cu's kernel (chip_smoke.py:check_k8).
extern "C" int int8_matmul_requant_rows16(const void* x, const void* w_t,
                                          const void* s_w, const void* b,
                                          const void* r_row,
                                          const void* s_next, void* q,
                                          void* r_out, int rows, int k, int n,
                                          int gelu, void* stream) {
  const size_t smem = tile_bytes(k, n);
  cudaError_t err = allow_shared(matmul_requant_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  matmul_requant_kernel<<<(rows + kBM - 1) / kBM, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w_t),
      static_cast<const float*>(s_w), static_cast<const float*>(b),
      static_cast<const float*>(r_row), static_cast<const float*>(s_next),
      static_cast<int8_t*>(q), static_cast<float*>(r_out), rows, k, n, gelu);
  return static_cast<int>(cudaGetLastError());
}

// The 16-row K7 kernel that the cluster kernel replaced, kept so that the
// two can be timed in one run (tools/int8_variants.py); no path of the port
// calls it.
extern "C" int int8_ffn_rows16(const void* x, const void* w1_t,
                               const void* s_w1, const void* b1,
                               const void* r_row, const void* s_mid,
                               const void* w2_t, const void* s_w2,
                               const void* b2, void* out, int rows, int k,
                               int n, int m_out, int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      out_bf16 ? dispatch_ffn<__nv_bfloat16>(x, w1_t, s_w1, b1, r_row, s_mid,
                                             w2_t, s_w2, b2, out, rows, k, n,
                                             m_out, st)
               : dispatch_ffn<float>(x, w1_t, s_w1, b1, r_row, s_mid, w2_t,
                                     s_w2, b2, out, rows, k, n, m_out, st);
  return static_cast<int>(err);
}

// K7 on the cluster tile.  K % 64 == 0; C = ceil(N / 512) <= 8 blocks, N / C
// a multiple of 64, M / C a multiple of 32 and at most 128; a tile of 16
// rows within the card's shared memory; x and the weights 16-byte aligned:
// the Python wrapper checks (ops/int8_mm.py:ffn_plan).
extern "C" int int8_ffn(const void* x, const void* w1_t, const void* s_w1,
                        const void* b1, const void* r_row, const void* s_mid,
                        const void* w2_t, const void* s_w2, const void* b2,
                        void* out, int rows, int k, int n, int m_out,
                        int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      out_bf16 ? dispatch_cluster<__nv_bfloat16>(
                     x, w1_t, s_w1, b1, r_row, s_mid, w2_t, s_w2, b2, out,
                     rows, k, n, m_out, st)
               : dispatch_cluster<float>(x, w1_t, s_w1, b1, r_row, s_mid,
                                         w2_t, s_w2, b2, out, rows, k, n,
                                         m_out, st);
  return static_cast<int>(err);
}

// The cluster tile int8_ffn takes at (K, N, M): blocks a cluster and rows a
// tile (0 where no tile fits).
extern "C" int int8_ffn_plan(int k, int n, int m_out, int* blocks,
                             int* rows) {
  *blocks = ffn_blocks(n);
  *rows = ffn_rows(k, n, m_out);
  return 0;
}
