// int8_matmul_requant (K8) and int8_ffn (K7): int8 x int8 -> int32 products
// with the decode, quickGELU and per-row requant done on the output tile
// before anything reaches device memory.
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
// 2 rows N (K + M), s8 operations against 1,979 TOP/s), but this first
// version is bound by the weights' traffic from L2: a block owns 16 rows and
// reads every weight once, 32 operations a byte (3.6 GB a call at the ViT's
// c_fc, some 4 TB/s of L2 reads at 0.88 ms).
//
// Design.  The row's abs-max needs all N outputs of the row before one can
// be rounded, and the value rounded must be the f32 value whose max was
// taken.  A row of f32 is up to 12 KB, so a block owns ONE mma.sync row tile
// of 16 rows and keeps its whole f32 middle [16, N] in shared memory (197 KB
// at N = 3072), with the int8 input tile beside it.  The TPU kernel's
// resident [K, N] weight does not fit an SM: the weights stream from L2 (2.4
// MB, or 2 x 1 MB, stay there across blocks) straight into the B fragments.
// 16 warps split the output columns in groups of 32 (the loads of 16 warps
// in flight hide L2's latency where 8 left it bare: 1.43 -> 0.88 ms at the
// ViT's c_fc); a warp walks K in chunks of 64 with one 16-byte load a lane
// for A (shared memory) and one for each of its B tiles (global), then two
// mma.sync.m16n8k32.s8 a tile.  A fragment's 32 k-slots are filled from 16
// contiguous bytes of a 64-byte chunk, the same ones for A and B: the
// integer sum does not care about the order of k.
// K7 then rounds the middle to int8 in place, row after row (the int8 rows
// land on floats already consumed), and runs the second product from shared
// memory the same way, so the [rows, N] middle exists nowhere else.  The
// second product has few columns (M = K), so its tiles a warp are chosen on
// the host to give every warp one group: 4 at M = 512, 6 at M = 768.
// Rows past the end are zero-filled and never written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

// Plain C entry points (bound with ctypes).  K % 64 == 0, N % 64 == 0,
// N <= 4096, M % 8 == 0, the tile within the card's shared memory, x and the
// weights 16-byte aligned: the Python wrapper checks.  Return cudaError_t.
extern "C" int int8_matmul_requant(const void* x, const void* w_t,
                                   const void* s_w, const void* b,
                                   const void* r_row, const void* s_next,
                                   void* q, void* r_out, int rows, int k,
                                   int n, int gelu, void* stream) {
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

extern "C" int int8_ffn(const void* x, const void* w1_t, const void* s_w1,
                        const void* b1, const void* r_row, const void* s_mid,
                        const void* w2_t, const void* s_w2, const void* b2,
                        void* out, int rows, int k, int n, int m_out,
                        int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      out_bf16 ? dispatch_ffn<__nv_bfloat16>(x, w1_t, s_w1, b1, r_row, s_mid,
                                             w2_t, s_w2, b2, out, rows, k, n,
                                             m_out, st)
               : dispatch_ffn<float>(x, w1_t, s_w1, b1, r_row, s_mid, w2_t,
                                     s_w2, b2, out, rows, k, n, m_out, st);
  return static_cast<int>(err);
}
