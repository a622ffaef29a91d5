// bigru_pooled_fwd, bigru_pooled_fwd_train: K1's forward entry points (the
// fused 1-layer bi-GRU with masked max-over-time pooling; the training
// variant also keeps the state its backward needs).  bf16 inputs run the
// W-resident kernel of this file; f32 inputs run the streamed kernels of
// bigru_pooled.cu and bigru_pooled_bwd.cu, whose 192 KB f32 W slice leaves
// no room for this design.
//
// Replaces: textreid_tpu/ops/gru_pallas.py:bigru_pooled_scan (the Pallas
// kernel _bigru_pooled_kernel, which keeps W_hh resident in VMEM).
// Contract: ops/gru.py, bigru_pooled_scan_plain (pooled output; the
// zero-participation rule is the wrapper's) and
// bigru_pooled_fwd_train_plain (pooled output, hp [2, B, T, H] = h_{t-1},
// gates [2, B, T, 4, H] = r, z, n, h_n in f32, argmax [B, 2H] int32: the
// first t < len at the max, -1 where len = 0).  h, the gates and the
// running max are f32.
//
// What bounds it on the H100: the chain of T dependent steps, each a
// [rows, H] x [H, 3H] product.  The streamed kernels split a row tile's
// units over a cluster of 8 blocks, each of which reads its [H, 3H / 8]
// slice of W from L2 every step: at B=256, 32 row tiles x 2 directions x
// 1.5 MB is ~96 MB of L2 reads a step, ~17 us a step (5.3 ms a call).
//
// Design: W resident, as the TPU kernel keeps it in VMEM.  A direction's
// units are split over a cluster of C = H / 32 blocks (16 at H = 512, a
// non-portable size); block r owns units [32 r, 32 r + 32) of all three
// gates, a [H, 96] bf16 slice of W (96 KB at H = 512) that its 8 warps load
// once into registers as mma.sync B fragments (warp w: columns 48 (w & 1)
// .. +48, k quarter w >> 1; 96 registers a thread).  A cluster takes R = 16
// or 32 rows of one direction (the fewer rounds of R-row steps, waves x R:
// ops/gru.py:resident_plan), and a persistent cluster walks its
// (direction, row group) items.  Each step:
//   1. [R, H] x [H, 96] with mma.sync.m16n8k16 (bf16 in, f32 sums): A is
//      h_{t-1} from shared memory through ldmatrix, split h = hi + lo (both
//      bf16), two products into one f32 accumulator: the plain version's
//      f32 h to ~2^-17, so the saved state stays within 1e-5 of it (one
//      bf16 operand alone: ~1.5e-3).  The four k quarters' partial sums go
//      to shared memory.
//   2. The cell in f32 on the block's 32 units x R rows (a thread owns
//      R / 8 units of one row: its f32 h, max and argmax in registers), with
//      the input gates of the step loaded into registers a step ahead.
//   3. The new h, split into hi and lo, into the block's own slice of the
//      next buffer (h double buffered, each block's slice contiguous), then
//      thread p copies the slice into block p with an asynchronous bulk
//      copy (cp.async.bulk, shared::cta -> shared::cluster) that completes
//      on the peer's mbarrier for that buffer; a block waits on its own
//      mbarrier before the next step's product.  No cluster barrier in the
//      step: a peer can only write a buffer again after every block has
//      sent the step that read it.
// The pooled-only variant stops at the item's longest length (later steps
// do not reach the max); the training variant runs all T steps, since its
// saved state covers them.  Shared memory at H = 512, R = 32: h 2 x 16 x 2
// x 32 x (32 + 8) bf16 (160 KB; the 8-element pad keeps ldmatrix's 8 rows
// on 8 bank groups) and the partial sums 4 x 32 x 104 f32 (53 KB).
//
// Measured (H100 SXM, 700 W, bf16, T = 105, H = 512; tools/gru_variants.py):
// a dependent step 2.93 us at R = 16 (5.22 at R = 32; the streamed kernel:
// 17.3), of which the products 1.25 (their lo half 0.32) and the copies
// 0.77; a first version, with each thread storing its h into all 16 blocks
// and a cluster barrier a step, took 4.05.  The card holds 7 clusters of 16
// blocks, so B = 128 and 256 take 3 and 5 waves of R = 16: 0.95 and 1.52 ms.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

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

// kMT m-tiles of 16 rows a cluster (R = 16 kMT); kTrain: also store hp,
// gates and argmax.  Grid: clusters x C blocks, cluster dims (C, 1, 1) at
// launch; items = 2 directions x row groups, walked with a stride of the
// number of clusters.
template <int kMT, bool kTrain>
__global__ void __launch_bounds__(kThreads, 1)
bigru_resident_kernel(const __nv_bfloat16* __restrict__ xf,
                      const __nv_bfloat16* __restrict__ xb,
                      const __nv_bfloat16* __restrict__ wf,
                      const __nv_bfloat16* __restrict__ wb,
                      const int* __restrict__ lengths,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ hp,
                      float* __restrict__ gates, int* __restrict__ argmax,
                      int batch, int seq, int hidden) {
  constexpr int R = 16 * kMT;
  constexpr int kUPT = R * kUnits / kThreads;  // units a thread's cell owns
  constexpr int kTPR = kUnits / kUPT;          // threads a row
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int cluster_id = blockIdx.x / csize;
  const int n_clusters = gridDim.x / csize;
  const int three_h = 3 * hidden;
  const int unit0 = rank * kUnits;
  constexpr int kSliceElems = 2 * R * kSlice;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [2 buffers][C blocks][2 planes: hi, lo][R][kSlice]
  __nv_bfloat16* hbuf = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* part = reinterpret_cast<float*>(
      smem_raw + 2 * csize * slice_bytes(R));  // [4][R][104]
  // bar[b] completes when every peer's slice of buffer b has landed
  uint64_t* bar = reinterpret_cast<uint64_t*>(part + 4 * R * kPartStride);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nh = warp & 1;   // column half
  const int kq = warp >> 1;  // k quarter
  const int k_tiles = hidden / 16;
  const int kt_per = (k_tiles + 3) / 4;
  const int kt0 = kq * kt_per;
  const int nkt = max(0, min(kt_per, k_tiles - kt0));
  // the cell's (row, units)
  const int crow = tid / kTPR;
  const int cu0 = (tid % kTPR) * kUPT;

  uint32_t bw[kMaxKTiles][kNTiles][2];
  int loaded_dir = -1;
  const int groups = (batch + R - 1) / R;
  const int items = 2 * groups;

  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  uint32_t parity[2] = {0u, 0u};
  cluster.sync();  // every block's barriers are live before peers copy

  for (int item = cluster_id; item < items; item += n_clusters) {
    const int dir = item / groups;
    const int row0 = (item - dir * groups) * R;
    const __nv_bfloat16* __restrict__ x = dir == 0 ? xf : xb;
    if (dir != loaded_dir) {  // this direction's W slice -> B fragments
      const __nv_bfloat16* __restrict__ w = dir == 0 ? wf : wb;
      const int g = lane >> 2, c = lane & 3;
#pragma unroll
      for (int i = 0; i < kMaxKTiles; ++i) {
#pragma unroll
        for (int j = 0; j < kNTiles; ++j) {
          bw[i][j][0] = bw[i][j][1] = 0u;
          if (i < nkt) {
            const int k = (kt0 + i) * 16 + 2 * c;
            const int lc = nh * kHalfCols + 8 * j + g;
            const int col = (lc / kUnits) * hidden + unit0 + lc % kUnits;
            const __nv_bfloat16* wk = w + static_cast<size_t>(k) * three_h
                                      + col;
            bw[i][j][0] = pack_bf16(wk[0], wk[three_h]);
            bw[i][j][1] = pack_bf16(wk[8 * three_h], wk[9 * three_h]);
          }
        }
      }
      loaded_dir = dir;
    }

    // this item's steps: the longest length of its rows (pooled-only), or
    // all of them (training); the same in every block of the cluster
    int t_end = seq;
    if (!kTrain) {
      int longest = 0;
      for (int r = 0; r < R && row0 + r < batch; ++r) {
        longest = max(longest, __ldg(lengths + row0 + r));
      }
      t_end = min(seq, longest);
    }
    const int b = row0 + crow;
    const bool live = b < batch;
    const int len = live ? __ldg(lengths + b) : 0;
    float h[kUPT], mx[kUPT], xr[kUPT], xz[kUPT], xn[kUPT];
    int am[kUPT];
#pragma unroll
    for (int j = 0; j < kUPT; ++j) {
      h[j] = 0.0f;
      mx[j] = -INFINITY;
      am[j] = -1;
      xr[j] = xz[j] = xn[j] = 0.0f;
    }
    const __nv_bfloat16* xrow =
        x + static_cast<size_t>(live ? b : 0) * seq * three_h + unit0 + cu0;
    if (live && t_end > 0) {
      load_bf16<kUPT>(xrow, xr);
      load_bf16<kUPT>(xrow + hidden, xz);
      load_bf16<kUPT>(xrow + 2 * hidden, xn);
    }

    for (int t = 0; t < t_end; ++t) {
      const int cur = (t + 1) & 1;  // h_{t-1}; h_t goes to cur ^ 1
      // 1. the recurrent product of h_{t-1} (zero at t = 0), once every
      // peer's slice of it has landed
      if (t > 0) {
        mbar_wait(&bar[cur], parity[cur]);
        parity[cur] ^= 1u;
      }
      float acc[kMT][kNTiles][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int j = 0; j < kNTiles; ++j) {
          acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] =
              0.0f;
        }
      }
      if (t > 0) {
        const __nv_bfloat16* h_cur =
            hbuf + static_cast<size_t>(cur) * csize * kSliceElems;
        const int arow = lane & 15, acol = (lane >> 4) * 8;
#pragma unroll
        for (int i = 0; i < kMaxKTiles; ++i) {
          if (i < nkt) {
            const int k0 = (kt0 + i) * 16;  // in the slice of k0 / 32
            const __nv_bfloat16* hi = h_cur + (k0 / kUnits) * kSliceElems
                                      + k0 % kUnits + acol;
            const __nv_bfloat16* lo = hi + R * kSlice;
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) {
              uint32_t a_hi[4], a_lo[4];
              const int off = (mt * 16 + arow) * kSlice;
              ldmatrix_x4(a_hi, hi + off);
              ldmatrix_x4(a_lo, lo + off);
#pragma unroll
              for (int j = 0; j < kNTiles; ++j) {
                mma_bf16(acc[mt][j], a_hi, bw[i][j]);
                mma_bf16(acc[mt][j], a_lo, bw[i][j]);
              }
            }
          }
        }
      }
      {
        const int g = lane >> 2, c = lane & 3;
        float* dst = part + static_cast<size_t>(kq) * R * kPartStride;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
          for (int j = 0; j < kNTiles; ++j) {
            const int col = nh * kHalfCols + 8 * j + 2 * c;
            const int r0 = mt * 16 + g;
            *reinterpret_cast<float2*>(dst + r0 * kPartStride + col) =
                make_float2(acc[mt][j][0], acc[mt][j][1]);
            *reinterpret_cast<float2*>(dst + (r0 + 8) * kPartStride + col) =
                make_float2(acc[mt][j][2], acc[mt][j][3]);
          }
        }
      }
      __syncthreads();  // every k quarter's partial sums are in `part`

      // 2. the cell on (crow, cu0 .. cu0 + kUPT)
      float hr[kUPT], hz[kUPT], hn[kUPT];
#pragma unroll
      for (int j = 0; j < kUPT; ++j) hr[j] = hz[j] = hn[j] = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* src = part + (static_cast<size_t>(q) * R + crow)
                                  * kPartStride + cu0;
        float pr[kUPT], pz[kUPT], pn[kUPT];
        load_f32<kUPT>(src, pr);
        load_f32<kUPT>(src + kUnits, pz);
        load_f32<kUPT>(src + 2 * kUnits, pn);
#pragma unroll
        for (int j = 0; j < kUPT; ++j) {
          hr[j] += pr[j];
          hz[j] += pz[j];
          hn[j] += pn[j];
        }
      }
      float rg[kUPT], zg[kUPT], ng[kUPT], hprev[kUPT];
      __nv_bfloat16 h_hi[kUPT], h_lo[kUPT];
#pragma unroll
      for (int j = 0; j < kUPT; ++j) {
        hprev[j] = h[j];
        rg[j] = sigmoid_f32(xr[j] + hr[j]);
        zg[j] = sigmoid_f32(xz[j] + hz[j]);
        ng[j] = tanhf(xn[j] + rg[j] * hn[j]);
        h[j] = (1.0f - zg[j]) * ng[j] + zg[j] * hprev[j];
        if (t < len && h[j] > mx[j]) {  // strictly greater: the first max
          mx[j] = h[j];
          am[j] = t;
        }
        h_hi[j] = __float2bfloat16_rn(h[j]);
        h_lo[j] = __float2bfloat16_rn(h[j] - __bfloat162float(h_hi[j]));
      }
      if (kTrain && live) {
        const size_t step = (static_cast<size_t>(dir) * batch + b) * seq + t;
        store_f32<kUPT>(hp + step * hidden + unit0 + cu0, hprev);
        float* gp = gates + step * 4 * hidden + unit0 + cu0;
        store_f32<kUPT>(gp, rg);
        store_f32<kUPT>(gp + hidden, zg);
        store_f32<kUPT>(gp + 2 * hidden, ng);
        store_f32<kUPT>(gp + 3 * hidden, hn);
      }
      // 3. h_t into this block's slice of the next buffer, then the slice
      // into every peer's with one asynchronous bulk copy each (the last
      // step's h is not needed)
      __nv_bfloat16* mine = hbuf + (static_cast<size_t>(cur ^ 1) * csize
                                    + rank) * kSliceElems;
      store_bf16<kUPT>(mine + crow * kSlice + cu0, h_hi);
      store_bf16<kUPT>(mine + (R + crow) * kSlice + cu0, h_lo);
      __syncthreads();  // the slice is complete; `part` is free again
      if (t + 1 < t_end) {  // thread p < C copies to block p, at once
        if (tid == 0) {
          mbar_arrive_expect(&bar[cur ^ 1], static_cast<uint32_t>(
                                                (csize - 1) * slice_bytes(R)));
        }
        if (tid < csize && tid != rank) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          copy_to_peer(mine, static_cast<uint32_t>(slice_bytes(R)),
                       &bar[cur ^ 1], tid);
        }
      }
      if (live && t + 1 < t_end) {  // the next step's input gates
        const __nv_bfloat16* xg =
            xrow + static_cast<size_t>(t + 1) * three_h;
        load_bf16<kUPT>(xg, xr);
        load_bf16<kUPT>(xg + hidden, xz);
        load_bf16<kUPT>(xg + 2 * hidden, xn);
      }
    }
    // every copy of this item has landed before the next item's (or the
    // end of the kernel, which frees the copies' sources)
    cluster.sync();

    if (live) {
      const size_t o = static_cast<size_t>(b) * 2 * hidden + dir * hidden
                       + unit0 + cu0;
      __nv_bfloat16 pooled[kUPT];
#pragma unroll
      for (int j = 0; j < kUPT; ++j) pooled[j] = __float2bfloat16_rn(mx[j]);
      store_bf16<kUPT>(out + o, pooled);
      if (kTrain) {
#pragma unroll
        for (int j = 0; j < kUPT; ++j) argmax[o + j] = am[j];
      }
    }
  }
}

template <int kMT, bool kTrain>
cudaError_t resident_config(int hidden, cudaLaunchConfig_t* config,
                            cudaLaunchAttribute* attr, const void** fn) {
  auto kernel = bigru_resident_kernel<kMT, kTrain>;
  const size_t smem = resident_smem(hidden, 16 * kMT);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  const int csize = hidden / kUnits;
  config->gridDim = dim3(csize, 1, 1);
  config->blockDim = dim3(kThreads, 1, 1);
  config->dynamicSmemBytes = smem;
  config->stream = nullptr;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = csize;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  config->attrs = attr;
  config->numAttrs = 1;
  *fn = reinterpret_cast<const void*>(kernel);
  return cudaSuccess;
}

// Clusters of R = 16 kMT rows the card holds at once, cached per (H, R).
template <int kMT>
cudaError_t max_clusters(int hidden, int* clusters) {
  static int cached[kMaxHidden / kUnits + 1] = {0};
  int& slot = cached[hidden / kUnits];
  if (slot == 0) {
    cudaLaunchConfig_t config = {};
    cudaLaunchAttribute attr;
    const void* fn = nullptr;
    // the training variant: its registers bound the same one block an SM
    cudaError_t err = resident_config<kMT, true>(hidden, &config, &attr, &fn);
    if (err != cudaSuccess) return err;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, fn, &config);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorInvalidConfiguration;
    slot = n;
  }
  *clusters = slot;
  return cudaSuccess;
}

// The row-group plan (mirrored by ops/gru.py:resident_plan): R = 32 or 16
// rows a cluster, whichever takes fewer rounds of R-row steps (waves x R;
// R = 32 on a tie), and as many clusters as items, at most a wave.
cudaError_t plan(int batch, int hidden, int* rows, int* clusters) {
  const int options[2] = {32, 16};
  int best_cost = 0;
  for (int r : options) {
    int cap = 0;
    const cudaError_t err =
        r == 32 ? max_clusters<2>(hidden, &cap) : max_clusters<1>(hidden, &cap);
    if (err != cudaSuccess) return err;
    const int items = 2 * ((batch + r - 1) / r);
    const int waves = (items + cap - 1) / cap;
    const int cost = waves * r;
    if (best_cost == 0 || cost < best_cost) {
      best_cost = cost;
      *rows = r;
      *clusters = items < cap ? items : cap;
    }
  }
  return cudaSuccess;
}

template <bool kTrain>
cudaError_t launch_resident(const void* xf, const void* xb, const void* wf,
                            const void* wb, const int* lengths, void* out,
                            float* hp, float* gates, int* argmax, int batch,
                            int seq, int hidden, cudaStream_t stream) {
  int rows = 0, clusters = 0;
  cudaError_t err = plan(batch, hidden, &rows, &clusters);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attr;
  const void* fn = nullptr;
  err = rows == 32 ? resident_config<2, kTrain>(hidden, &config, &attr, &fn)
                   : resident_config<1, kTrain>(hidden, &config, &attr, &fn);
  if (err != cudaSuccess) return err;
  config.gridDim = dim3(clusters * (hidden / kUnits), 1, 1);
  config.stream = stream;
  const auto* x0 = static_cast<const __nv_bfloat16*>(xf);
  const auto* x1 = static_cast<const __nv_bfloat16*>(xb);
  const auto* w0 = static_cast<const __nv_bfloat16*>(wf);
  const auto* w1 = static_cast<const __nv_bfloat16*>(wb);
  auto* o = static_cast<__nv_bfloat16*>(out);
  err = rows == 32
            ? cudaLaunchKernelEx(&config, bigru_resident_kernel<2, kTrain>,
                                 x0, x1, w0, w1, lengths, o, hp, gates,
                                 argmax, batch, seq, hidden)
            : cudaLaunchKernelEx(&config, bigru_resident_kernel<1, kTrain>,
                                 x0, x1, w0, w1, lengths, o, hp, gates,
                                 argmax, batch, seq, hidden);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// The streamed kernels' entry points (bigru_pooled.cu, bigru_pooled_bwd.cu)
// for f32 inputs; the pooled-only one's bf16 is kept for comparison
// (tools/gru_variants.py:streamed_forward)
extern "C" int bigru_pooled_fwd_streamed(const void* xf, const void* xb,
                                         const void* wf, const void* wb,
                                         const void* lengths, void* out,
                                         int batch, int seq, int hidden,
                                         int is_bf16, void* stream);
extern "C" int bigru_pooled_fwd_train_streamed(
    const void* xf, const void* xb, const void* wf, const void* wb,
    const void* lengths, void* out, void* hp, void* gates, void* argmax,
    int batch, int seq, int hidden, void* stream);

// Plain C entry points (bound with ctypes).  bf16 needs hidden % 32 == 0
// and hidden <= 512 (H / 32 blocks a cluster, at most 16); f32 takes the
// streamed kernels' range.  The dtype/shape checks are the Python
// wrapper's job.  Each returns cudaError_t.
extern "C" int bigru_pooled_fwd(const void* xf, const void* xb,
                                const void* wf, const void* wb,
                                const void* lengths, void* out, int batch,
                                int seq, int hidden, int is_bf16,
                                void* stream) {
  if (!is_bf16) {
    return bigru_pooled_fwd_streamed(xf, xb, wf, wb, lengths, out, batch,
                                     seq, hidden, 0, stream);
  }
  return static_cast<int>(launch_resident<false>(
      xf, xb, wf, wb, static_cast<const int*>(lengths), out, nullptr,
      nullptr, nullptr, batch, seq, hidden,
      static_cast<cudaStream_t>(stream)));
}

extern "C" int bigru_pooled_fwd_train(const void* xf, const void* xb,
                                      const void* wf, const void* wb,
                                      const void* lengths, void* out,
                                      void* hp, void* gates, void* argmax,
                                      int batch, int seq, int hidden,
                                      int is_bf16, void* stream) {
  if (!is_bf16) {
    return bigru_pooled_fwd_train_streamed(xf, xb, wf, wb, lengths, out, hp,
                                           gates, argmax, batch, seq, hidden,
                                           stream);
  }
  return static_cast<int>(launch_resident<true>(
      xf, xb, wf, wb, static_cast<const int*>(lengths), out,
      static_cast<float*>(hp), static_cast<float*>(gates),
      static_cast<int*>(argmax), batch, seq, hidden,
      static_cast<cudaStream_t>(stream)));
}

// The plan the bf16 launch takes for B rows: rows a cluster (32 or 16)
// and clusters in the grid, and the clusters of each row count the card
// holds at once.
extern "C" int bigru_resident_plan(int batch, int hidden, int* rows,
                                   int* clusters, int* cap32, int* cap16) {
  cudaError_t err = max_clusters<2>(hidden, cap32);
  if (err == cudaSuccess) err = max_clusters<1>(hidden, cap16);
  if (err == cudaSuccess) err = plan(batch, hidden, rows, clusters);
  return static_cast<int>(err);
}
