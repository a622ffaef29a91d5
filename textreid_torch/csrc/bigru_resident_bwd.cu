// bigru_resident_bwd: K1's bf16 backward (the gradient of the fused 1-layer
// bi-GRU with masked max pooling) with W held in registers across a
// cluster.  f32 runs the streamed kernel of bigru_pooled_bwd.cu, whose
// 192 KB f32 W slice leaves no room for this design; that file's bf16
// instantiation stays only for comparison
// (tools/gru_variants.py:streamed_backward).
//
// Replaces: the VJP of textreid_tpu/ops/gru_pallas.py:bigru_pooled_scan's
// custom_vjp (`bwd`, which differentiates _xla_pooled_forward through XLA:
// the JAX package has no backward kernel).  Contract: ops/gru.py,
// bigru_pooled_bwd_plain.  Per direction, row and unit, t = T-1 .. 0:
//   dh   += [t == argmax] g
//   a_z   = dh (h_{t-1} - n) z (1 - z),  a_n = dh (1 - z) (1 - n^2),
//   a_r   = a_n h_n r (1 - r)
//   dx_t  = [a_r, a_z, a_n]  (bf16),  dhg_t = [a_r, a_z, a_n r]  (f32)
//   dh    = dh z + dhg_t W^T
// from the training forward's saved f32 state (bigru_resident.cu: h_{t-1},
// r, z, n, h_n and the argmax); dW = sum_t h_{t-1}^T dhg_t is the
// wrapper's one f32 product over B T rows.
//
// What bounds it on the H100: the chain of T dependent steps, each a
// [rows, 3H] x [3H, H] product, as many operations and W bytes as a forward
// step.  The streamed kernel it replaced (bigru_pooled_bwd.cu) read each
// block's [3H, H / 8] slice of W^T from L2 every step on the FP32 cores,
// all-gathered dhg (each block wrote its 3 x 64 columns into all 8 peers)
// behind a cluster barrier a step, and took 8 rows a cluster, so B = 128
// needed 32 clusters of which the card held 30: 15.81 us a dependent step,
// 4.587 ms a call with dW.
//
// Design: the forward's split and registers, the exchange turned around.
// A direction's units are split over a cluster of C = H / 32 blocks (16 at
// H = 512); block r owns units U_r = [32 r, 32 r + 32), i.e. the dhg
// columns {U_r, H + U_r, 2H + U_r}, and keeps the same [H, 96] bf16 slice
// of W as the forward's block, here as mma.sync.m16n8k16 B fragments of
// W^T (k = its 96 dhg columns, n = the H units that receive dh; warp w
// holds units [64 w, 64 w + 64) over all 96 k: 96 registers a thread),
// loaded once per direction straight from W's [H, 3H] layout (two adjacent
// columns of a row are one 32-bit word), so the wrapper transposes nothing.
// A cluster takes R = 16 or 32 rows of one direction (waves x R, as the
// forward: gru_resident.cuh:plan_rows), and a persistent cluster walks its
// (direction, row group) items.  Each step:
//   1. dh of the block's 32 units x R rows: dh z of the step after plus
//      the C partial sums its peers sent (f32), once they have landed on
//      this block's mbarrier; then the pool gradient and the cell gradient
//      in f32 (a thread owns R / 8 units of one row; the step's saved state
//      was loaded into registers during the step before).  dx and dhg go to
//      global memory; the block's own dhg columns, split bf16 hi + lo as the
//      forward splits h, into a shared [R, 96] A tile.
//   2. The partial dh_p[R, H] = dhg[:, own 96] W[:, own 96]^T on the tensor
//      cores (hi and lo into one f32 accumulator: the f32 dhg to ~2^-17),
//      one m-tile of 16 rows at a time (32 accumulators a thread).
//   3. Reduce-scatter, not all-gather: each warp's [16, 64] block of
//      dh_p belongs to two peers; lane pairs swap halves with one shuffle
//      so that each lane holds 4 adjacent columns of one row, and store it
//      into the peer's receive slot with st.async, which completes on the
//      peer's mbarrier (the block's own share: plain stores).  A block sends
//      R x 2 KB a step (the all-gather: R x 6 KB, into every peer).
// No cluster barrier in the step: a block writes a peer's buffer again
// only two steps later, after it has waited for the peer's partial sums of
// the step between, which the peer sent after reading the buffer (the
// forward's rule, bigru_resident.cu).  Kept from the streamed kernel: the
// loop starts at the row group's longest length and later steps are
// written as zeros; dx in bf16 and dhg in f32 [2, B, T, 3H].  Shared
// memory at H = 512: the receive buffers 2 x 16 x R x 32 f32 (64 KB at R =
// 16, 128 KB at R = 32) and the A tile 2 x R x (96 + 8) bf16 (the pad puts
// ldmatrix's 8 rows on 8 bank groups).  A staged exchange by cp.async.bulk,
// as the forward's, would need a double-buffered send area as large as the
// receive buffers: 256 KB at R = 32.
//
// Measured (H100 SXM, 700 W, bf16, B = 128, T = 105, H = 512; chip_smoke.py
// and tools/gru_variants.py): a dependent step 3.70 us (the streamed
// kernel: 14.94), of which the products ~1.39 (their lo half ~0.53) and the
// exchange with its wait for the slowest peer ~1.82 (the forward's bulk
// copies: 0.74); the kernel alone 1.16 ms in 3 waves of 7 clusters of 16
// rows (the streamed kernel: 3.47 ms), 2.29 ms with the dW product (4.53).

#include "gru_resident.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace textreid_resident;

constexpr int kWarpUnits = 64;                // dh units a warp's product
constexpr int kBwdNTiles = kWarpUnits / 8;    // 8
constexpr int kBwdKTiles = kCols / 16;        // 6: the block's dhg columns
constexpr int kAStride = kCols + 8;           // a row of the A tile, bf16
static_assert(kThreads / 32 * kWarpUnits == kMaxHidden,
              "the warps' units cover the widest H");

// the receive buffers [2][C][R][32] f32, the A tile [2 planes][R][104]
// bf16, two mbarriers (mirrored by ops/gru.py:resident_bwd_smem)
__host__ __device__ constexpr size_t recv_floats(int hidden, int rows) {
  return static_cast<size_t>(hidden / kUnits) * rows * kUnits;
}

__host__ __device__ constexpr size_t resident_bwd_smem(int hidden, int rows) {
  return sizeof(float) * 2 * recv_floats(hidden, rows) +
         sizeof(__nv_bfloat16) * 2 * rows * kAStride + 16;
}

// One step's saved state of a thread's kUPT units: r, z, n, h_n, h_{t-1}.
template <int kUPT>
struct Saved {
  float r[kUPT], z[kUPT], n[kUPT], hn[kUPT], hp[kUPT];
};

// kMT m-tiles of 16 rows a cluster (R = 16 kMT).  Grid: clusters x C
// blocks, cluster dims (C, 1, 1) at launch; items = 2 directions x row
// groups, walked with a stride of the number of clusters.
template <int kMT>
__global__ void __launch_bounds__(kThreads, 1)
bigru_resident_bwd_kernel(const __nv_bfloat16* __restrict__ g,
                          const __nv_bfloat16* __restrict__ wf,
                          const __nv_bfloat16* __restrict__ wb,
                          const int* __restrict__ lengths,
                          const float* __restrict__ hp,
                          const float* __restrict__ gates,
                          const int* __restrict__ argmax,
                          __nv_bfloat16* __restrict__ dxf,
                          __nv_bfloat16* __restrict__ dxb,
                          float* __restrict__ dhg, int batch, int seq,
                          int hidden) {
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
  const int recv_elems = static_cast<int>(recv_floats(hidden, R));

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* recv = reinterpret_cast<float*>(smem_raw);  // [2][C][R][32]
  __nv_bfloat16* atile = reinterpret_cast<__nv_bfloat16*>(
      recv + 2 * recv_elems);  // [2 planes: hi, lo][R][kAStride]
  // bar[q] completes when every peer's partial sums of buffer q have landed
  uint64_t* bar = reinterpret_cast<uint64_t*>(atile + 2 * R * kAStride);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2, c4 = lane & 3;  // mma fragment row, column pair
  const int n0 = warp * kWarpUnits;         // the warp's first dh unit
  // the cell's (row, units)
  const int crow = tid / kTPR;
  const int cu0 = (tid % kTPR) * kUPT;
  // the row and first column a lane stores of each n-tile (after the swap)
  const int srow = gq + 8 * (c4 & 1);
  const int scol = 2 * (c4 & 2);
  // the warp's two peers: their receive buffers and barriers
  uint32_t peer_recv[2], peer_bar[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int peer = min(n0 / kUnits + p, csize - 1);
    peer_recv[p] = peer_addr(recv, peer);
    peer_bar[p] = peer_addr(bar, peer);
  }

  uint32_t bw[kBwdKTiles][kBwdNTiles][2];
  int loaded_dir = -1;
  const int groups = (batch + R - 1) / R;
  const int items = 2 * groups;

  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  uint32_t parity[2] = {0u, 0u};
  cluster.sync();  // every block's barriers are live before peers store

  for (int item = cluster_id; item < items; item += n_clusters) {
    const int dir = item / groups;
    const int row0 = (item - dir * groups) * R;
    __nv_bfloat16* __restrict__ dx = dir == 0 ? dxf : dxb;
    if (dir != loaded_dir) {  // this direction's W slice -> B fragments of
      // W^T: B[k][n] = W[n][gate(k) H + unit0 + k % 32], k, k + 1 adjacent
      const __nv_bfloat16* __restrict__ w = dir == 0 ? wf : wb;
#pragma unroll
      for (int i = 0; i < kBwdKTiles; ++i) {
#pragma unroll
        for (int j = 0; j < kBwdNTiles; ++j) {
          bw[i][j][0] = bw[i][j][1] = 0u;
          const int n = n0 + 8 * j + gq;
          if (n < hidden) {
            const __nv_bfloat16* wk =
                w + static_cast<size_t>(n) * three_h + (i >> 1) * hidden +
                unit0 + (i & 1) * 16 + 2 * c4;
            bw[i][j][0] = __ldg(reinterpret_cast<const unsigned*>(wk));
            bw[i][j][1] = __ldg(reinterpret_cast<const unsigned*>(wk + 8));
          }
        }
      }
      loaded_dir = dir;
    }

    // the row group's longest length: later steps get no pool gradient,
    // so their gradient is zero; the same in every block of the cluster
    int t_top = 0;
    for (int r = 0; r < R && row0 + r < batch; ++r) {
      t_top = max(t_top, min(__ldg(lengths + row0 + r), seq));
    }
    const int b = row0 + crow;
    const bool live = b < batch;
    float gp[kUPT], dhz[kUPT];
    int am[kUPT];
    {
      float gv[kUPT];
#pragma unroll
      for (int j = 0; j < kUPT; ++j) gv[j] = 0.0f;
      const size_t o = static_cast<size_t>(live ? b : 0) * 2 * hidden +
                       dir * hidden + unit0 + cu0;
      if (live) load_bf16<kUPT>(g + o, gv);
#pragma unroll
      for (int j = 0; j < kUPT; ++j) {
        gp[j] = gv[j];
        am[j] = live ? __ldg(argmax + o + j) : -1;
        dhz[j] = 0.0f;
      }
    }
    const size_t row_t0 = static_cast<size_t>(live ? b : 0) * seq;
    const size_t state_t0 = (static_cast<size_t>(dir) * batch +
                             (live ? b : 0)) * seq;
    if (live) {  // the steps past the group's longest length: zeros
      float zf[kUPT];
      __nv_bfloat16 zb[kUPT];
#pragma unroll
      for (int j = 0; j < kUPT; ++j) {
        zf[j] = 0.0f;
        zb[j] = __float2bfloat16_rn(0.0f);
      }
      for (int t = t_top; t < seq; ++t) {
        __nv_bfloat16* d = dx + (row_t0 + t) * three_h + unit0 + cu0;
        float* e = dhg + (state_t0 + t) * three_h + unit0 + cu0;
#pragma unroll
        for (int gate = 0; gate < 3; ++gate) {
          store_bf16<kUPT>(d + gate * hidden, zb);
          store_f32<kUPT>(e + gate * hidden, zf);
        }
      }
    }

    // step t_top - 1's saved state; then each step loads the one before it
    // while its product runs
    Saved<kUPT> next;
    auto load_step = [&](int t) {
      if (live) {
        const size_t at = state_t0 + t;
        const float* gs = gates + at * 4 * hidden + unit0 + cu0;
        load_f32<kUPT>(gs, next.r);
        load_f32<kUPT>(gs + hidden, next.z);
        load_f32<kUPT>(gs + 2 * hidden, next.n);
        load_f32<kUPT>(gs + 3 * hidden, next.hn);
        load_f32<kUPT>(hp + at * hidden + unit0 + cu0, next.hp);
      } else {
#pragma unroll
        for (int j = 0; j < kUPT; ++j) {
          next.r[j] = next.z[j] = next.n[j] = next.hn[j] = next.hp[j] = 0.0f;
        }
      }
    };
    if (t_top > 0) load_step(t_top - 1);

    for (int t = t_top - 1; t >= 0; --t) {
      const Saved<kUPT> s = next;
      if (t > 0) load_step(t - 1);
      // 1. dh of step t: dh z of step t + 1 plus every peer's partial sum
      // of step t + 1's product, once they have landed
      float dh[kUPT];
#pragma unroll
      for (int j = 0; j < kUPT; ++j) dh[j] = dhz[j];
      if (t + 1 < t_top) {
        const int q = (t + 1) & 1;
        mbar_wait(&bar[q], parity[q]);
        parity[q] ^= 1u;
        const float* src = recv + q * recv_elems + crow * kUnits + cu0;
#pragma unroll 4
        for (int p = 0; p < csize; ++p) {
          float part[kUPT];
          load_f32<kUPT>(src + p * R * kUnits, part);
#pragma unroll
          for (int j = 0; j < kUPT; ++j) dh[j] += part[j];
        }
      }
      float a_r[kUPT], a_z[kUPT], a_n[kUPT], a_hn[kUPT];
      __nv_bfloat16 dxv[3][kUPT];
#pragma unroll
      for (int j = 0; j < kUPT; ++j) {
        if (am[j] == t) dh[j] += gp[j];
        a_z[j] = dh[j] * (s.hp[j] - s.n[j]) * s.z[j] * (1.0f - s.z[j]);
        a_n[j] = dh[j] * (1.0f - s.z[j]) * (1.0f - s.n[j] * s.n[j]);
        a_r[j] = a_n[j] * s.hn[j] * s.r[j] * (1.0f - s.r[j]);
        a_hn[j] = a_n[j] * s.r[j];
        dhz[j] = dh[j] * s.z[j];
        dxv[0][j] = __float2bfloat16_rn(a_r[j]);
        dxv[1][j] = __float2bfloat16_rn(a_z[j]);
        dxv[2][j] = __float2bfloat16_rn(a_n[j]);
      }
      if (live) {
        __nv_bfloat16* d = dx + (row_t0 + t) * three_h + unit0 + cu0;
        float* e = dhg + (state_t0 + t) * three_h + unit0 + cu0;
#pragma unroll
        for (int gate = 0; gate < 3; ++gate) {
          store_bf16<kUPT>(d + gate * hidden, dxv[gate]);
        }
        store_f32<kUPT>(e, a_r);
        store_f32<kUPT>(e + hidden, a_z);
        store_f32<kUPT>(e + 2 * hidden, a_hn);
      }
      if (t == 0) break;  // h_{-1} is a constant: no product for it

      // the block's dhg columns, hi and lo, into the A tile
      {
        auto put = [&](int gate, const float (&v)[kUPT]) {
          __nv_bfloat16 hi[kUPT], lo[kUPT];
#pragma unroll
          for (int j = 0; j < kUPT; ++j) {
            hi[j] = __float2bfloat16_rn(v[j]);
            lo[j] = __float2bfloat16_rn(v[j] - __bfloat162float(hi[j]));
          }
          __nv_bfloat16* at = atile + crow * kAStride + gate * kUnits + cu0;
          store_bf16<kUPT>(at, hi);
          store_bf16<kUPT>(at + R * kAStride, lo);
        };
        put(0, a_r);
        put(1, a_z);
        put(2, a_hn);
      }
      __syncthreads();  // the A tile is complete

      // 2-3. dh_p = dhg[:, own] W[:, own]^T, an m-tile at a time, each
      // lane's 4 columns of a row into the receiving peer's slot q
      const int q = t & 1;
      if (tid == 0) {
        mbar_arrive_expect(&bar[q], static_cast<uint32_t>(
            sizeof(float) * (csize - 1) * R * kUnits));
      }
      const int arow = lane & 15, acol = (lane >> 4) * 8;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        float acc[kBwdNTiles][4];
#pragma unroll
        for (int j = 0; j < kBwdNTiles; ++j) {
          acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
        }
        if (n0 < hidden) {
#pragma unroll
          for (int i = 0; i < kBwdKTiles; ++i) {
            uint32_t a_hi[4], a_lo[4];
            const __nv_bfloat16* a =
                atile + (mt * 16 + arow) * kAStride + i * 16 + acol;
            ldmatrix_x4(a_hi, a);
            ldmatrix_x4(a_lo, a + R * kAStride);
#pragma unroll
            for (int j = 0; j < kBwdNTiles; ++j) {
              if (n0 + 8 * j < hidden) {
                mma_bf16(acc[j], a_hi, bw[i][j]);
                mma_bf16(acc[j], a_lo, bw[i][j]);
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kBwdNTiles; ++j) {
          if (n0 + 8 * j >= hidden) continue;  // the same in the whole warp
          // lane pairs swap: the even lane takes row gq's 4 columns, the
          // odd lane row gq + 8's
          const bool odd = c4 & 1;
          const float s0 = __shfl_xor_sync(0xffffffffu,
                                           odd ? acc[j][0] : acc[j][2], 1);
          const float s1 = __shfl_xor_sync(0xffffffffu,
                                           odd ? acc[j][1] : acc[j][3], 1);
          const float4 v = odd ? make_float4(s0, s1, acc[j][2], acc[j][3])
                               : make_float4(acc[j][0], acc[j][1], s0, s1);
          const int p = j / (kBwdNTiles / 2);  // which of the warp's peers
          const int peer = n0 / kUnits + p;
          const int off = q * recv_elems +
                          (rank * R + mt * 16 + srow) * kUnits +
                          8 * (j % (kBwdNTiles / 2)) + scol;
          if (peer == rank) {
            *reinterpret_cast<float4*>(recv + off) = v;
          } else {
            st_async_v4(peer_recv[p] + sizeof(float) * off, v,
                        peer_bar[p] + sizeof(uint64_t) * q);
          }
        }
      }
      __syncthreads();  // this block's own share is in place; the A tile
                        // is free for the next step
    }
    // every store of this item has landed before the next item's (or the
    // end of the kernel)
    cluster.sync();
  }
}

template <int kMT>
cudaError_t bwd_config(int hidden, cudaLaunchConfig_t* config,
                       cudaLaunchAttribute* attr, const void** fn) {
  auto kernel = bigru_resident_bwd_kernel<kMT>;
  const size_t smem = resident_bwd_smem(hidden, 16 * kMT);
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

// Clusters of R = 16 kMT rows the card holds at once, cached per H.
template <int kMT>
cudaError_t bwd_max_clusters(int hidden, int* clusters) {
  static int cached[kMaxHidden / kUnits + 1] = {0};
  int& slot = cached[hidden / kUnits];
  if (slot == 0) {
    cudaLaunchConfig_t config = {};
    cudaLaunchAttribute attr;
    const void* fn = nullptr;
    cudaError_t err = bwd_config<kMT>(hidden, &config, &attr, &fn);
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

cudaError_t bwd_plan(int batch, int hidden, int* rows, int* clusters,
                     int* cap32, int* cap16) {
  cudaError_t err = bwd_max_clusters<2>(hidden, cap32);
  if (err == cudaSuccess) err = bwd_max_clusters<1>(hidden, cap16);
  if (err != cudaSuccess) return err;
  plan_rows(batch, 2, *cap32, *cap16, rows, clusters);
  return cudaSuccess;
}

}  // namespace

// Plain C entry point (bound with ctypes): bf16 only, hidden % 32 == 0 and
// hidden <= 512 (the dtype/shape checks are the Python wrapper's job).  g
// [B, 2H] and w_f, w_b [H, 3H] bf16, lengths, the training forward's hp,
// gates (f32) and argmax -> dxf, dxb [B, T, 3H] bf16 and dhg [2, B, T, 3H]
// f32.  Returns cudaError_t.
extern "C" int bigru_resident_bwd(const void* g, const void* wf,
                                  const void* wb, const void* lengths,
                                  const void* hp, const void* gates,
                                  const void* argmax, void* dxf, void* dxb,
                                  void* dhg, int batch, int seq, int hidden,
                                  void* stream) {
  int rows = 0, clusters = 0, cap32 = 0, cap16 = 0;
  cudaError_t err = bwd_plan(batch, hidden, &rows, &clusters, &cap32, &cap16);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attr;
  const void* fn = nullptr;
  err = rows == 32 ? bwd_config<2>(hidden, &config, &attr, &fn)
                   : bwd_config<1>(hidden, &config, &attr, &fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  config.gridDim = dim3(clusters * (hidden / kUnits), 1, 1);
  config.stream = static_cast<cudaStream_t>(stream);
  const auto* g16 = static_cast<const __nv_bfloat16*>(g);
  const auto* w0 = static_cast<const __nv_bfloat16*>(wf);
  const auto* w1 = static_cast<const __nv_bfloat16*>(wb);
  const auto* lens = static_cast<const int*>(lengths);
  const auto* h = static_cast<const float*>(hp);
  const auto* gs = static_cast<const float*>(gates);
  const auto* am = static_cast<const int*>(argmax);
  auto* d0 = static_cast<__nv_bfloat16*>(dxf);
  auto* d1 = static_cast<__nv_bfloat16*>(dxb);
  auto* e = static_cast<float*>(dhg);
  err = rows == 32
            ? cudaLaunchKernelEx(&config, bigru_resident_bwd_kernel<2>, g16,
                                 w0, w1, lens, h, gs, am, d0, d1, e, batch,
                                 seq, hidden)
            : cudaLaunchKernelEx(&config, bigru_resident_bwd_kernel<1>, g16,
                                 w0, w1, lens, h, gs, am, d0, d1, e, batch,
                                 seq, hidden);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The plan the launch takes for B rows: rows a cluster (32 or 16) and
// clusters in the grid, and the clusters of each row count the card holds
// at once.
extern "C" int bigru_resident_bwd_plan(int batch, int hidden, int* rows,
                                       int* clusters, int* cap32,
                                       int* cap16) {
  return static_cast<int>(
      bwd_plan(batch, hidden, rows, clusters, cap32, cap16));
}

// A block's shared memory at H and R rows a cluster, in bytes (what
// ops/gru.py:resident_bwd_smem mirrors).
extern "C" int bigru_resident_bwd_smem(int hidden, int rows) {
  return static_cast<int>(resident_bwd_smem(hidden, rows));
}
