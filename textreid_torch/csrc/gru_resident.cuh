// The pieces shared by the W-resident GRU kernels: bigru_resident.cu (K1's
// bf16 forward, both directions, pooled), gru_scan_resident.cu (K3's bf16
// forward, one direction, every h_t) and bigru_resident_bwd.cu (K1's bf16
// backward).  The forwards split a direction's H units over a cluster of
// H / 32 blocks, hold a block's [H, 96] bf16 slice of W in registers as
// mma.sync B fragments, split h into hi + lo bf16 planes and send a block's
// new slice of h to every peer with one cp.async.bulk that completes on the
// peer's mbarrier (the design is described in bigru_resident.cu); the
// backward keeps the same slice as fragments of W^T and sends partial sums
// with st.async.  Only device helpers, constants and the host's
// row-group plan are shared here; each kernel keeps its own step loop, so
// that a change made for one cannot cost the other registers.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace textreid_resident {

constexpr int kUnits = 32;     // hidden units a block owns
constexpr int kCols = 3 * kUnits;  // its W columns: r, z, n
constexpr int kThreads = 256;  // 8 warps: 2 column halves x 4 k quarters
constexpr int kHalfCols = kCols / 2;     // 48: 6 n-tiles of 8
constexpr int kNTiles = kHalfCols / 8;   // 6
constexpr int kMaxKTiles = 8;  // k tiles (16 deep) a warp holds: H <= 512
constexpr int kPartStride = kCols + 8;   // f32 row of the partial sums
constexpr int kMaxHidden = 512;
// a block's slice of h: [2 planes: hi, lo][R][kSlice] bf16, its 32 units
// and a pad of 8 (an 80-byte row: ldmatrix's 8 rows on 8 bank groups)
constexpr int kSlice = kUnits + 8;

__host__ __device__ constexpr size_t slice_bytes(int rows) {
  return sizeof(__nv_bfloat16) * 2 * rows * kSlice;
}

// h [2 buffers][C blocks] slices, the partial sums, two mbarriers
__host__ __device__ constexpr size_t resident_smem(int hidden, int rows) {
  return 2 * (hidden / kUnits) * slice_bytes(rows) +
         sizeof(float) * 4 * rows * kPartStride + 16;
}

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a b, m16n8k16, bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// one arrival that also expects `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], "
      "%1;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// `bytes` of this block's shared memory at `src` into block `peer`'s at the
// same offset, completing on `peer`'s mbarrier at `bar`'s offset
__device__ __forceinline__ void copy_to_peer(const void* src, uint32_t bytes,
                                             uint64_t* bar, int peer) {
  uint32_t dst, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(dst) : "r"(smem_addr(src)), "r"(peer));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rbar) : "r"(smem_addr(bar)), "r"(peer));
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "r"(smem_addr(src)), "r"(bytes), "r"(rbar) : "memory");
}

// The address of `p` (this block's shared memory) in block `peer`'s, as a
// shared::cluster address; offsets from it are linear
__device__ __forceinline__ uint32_t peer_addr(const void* p, int peer) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(smem_addr(p)), "r"(peer));
  return out;
}

// 16 bytes from registers into a peer's shared memory (a shared::cluster
// address), completing on the peer's mbarrier at `bar` (ditto)
__device__ __forceinline__ void st_async_v4(uint32_t dst, float4 v,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n"
      :: "r"(dst), "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
         "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}

// N consecutive bf16 of global memory -> floats (N = 2 or 4, aligned)
template <int N>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p,
                                          float (&v)[N]) {
  if constexpr (N == 4) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    v[0] = __low2float(a);
    v[1] = __high2float(a);
    v[2] = __low2float(b);
    v[3] = __high2float(b);
  } else {
    const unsigned raw = __ldg(reinterpret_cast<const unsigned*>(p));
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw);
    v[0] = __low2float(a);
    v[1] = __high2float(a);
  }
}

// N bf16 (N = 2 or 4) into consecutive places as one store
template <int N>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* p,
                                           const __nv_bfloat16 (&v)[N]) {
  if constexpr (N == 4) {
    uint2 raw;
    raw.x = pack_bf16(v[0], v[1]);
    raw.y = pack_bf16(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = raw;
  } else {
    *reinterpret_cast<unsigned*>(p) = pack_bf16(v[0], v[1]);
  }
}

template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[N]) {
  if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  } else {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x;
    v[1] = a.y;
  }
}

template <int N>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

// The row-group plan (mirrored by ops/gru.py:resident_plan): R = 32 or 16
// rows a cluster, whichever takes fewer rounds of R-row steps (waves x R;
// R = 32 on a tie), for items = directions x ceil(B / R), and as many
// clusters as items, at most a wave.  cap32 and cap16: the clusters of 32
// and of 16 rows the card holds at once.
inline void plan_rows(int batch, int directions, int cap32, int cap16,
                      int* rows, int* clusters) {
  const int options[2] = {32, 16};
  int best_cost = 0;
  for (int r : options) {
    const int cap = r == 32 ? cap32 : cap16;
    const int items = directions * ((batch + r - 1) / r);
    const int waves = (items + cap - 1) / cap;
    const int cost = waves * r;
    if (best_cost == 0 || cost < best_cost) {
      best_cost = cost;
      *rows = r;
      *clusters = items < cap ? items : cap;
    }
  }
}

}  // namespace textreid_resident
