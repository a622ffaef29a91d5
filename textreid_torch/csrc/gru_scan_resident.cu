// gru_scan_fwd_resident: K3's bf16 forward, the one-direction GRU scan that
// returns every hidden state, on the W-resident design of K1's bf16 forward
// (bigru_resident.cu).  f32, and bf16 with H > 512, run the streamed kernel
// of gru_scan.cu; ops/gru.py:scan_kernel makes that choice.
//
// Replaces: textreid_tpu/ops/gru_pallas.py:gru_scan_pallas (the Pallas
// kernel _gru_scan_kernel, which keeps W_hh resident in VMEM).  Contract
// (ops/gru.py:gru_scan_plain):
//   h_t = cell(x[:, t], h_{t-1}, W),  out[:, t] = h_t,  h_{-1} = h0
// for t = 0..T-1, or T-1..0 when `reverse`; no masking by length, every one
// of the T steps runs.  x [B, T, 3H] (gates r, z, n), W [H, 3H], h0 [B, H],
// out [B, T, H], all bf16 and batch-major.  h, the gates and the carried
// state are f32; only the stored h_t is rounded, once, to bf16.
//
// What bounds it on the H100: the chain of T dependent steps, each a
// [rows, H] x [H, 3H] product.  The streamed kernel (gru_scan.cu) splits an
// 8-row tile's units over a cluster of 8 blocks that read their [H, 3H / 8]
// slice of W from L2 every step (at B=256, 32 tiles x 1.5 MB, ~48 MB of L2 a
// step), store f32 h element by element into all 8 peers and meet at a
// cluster barrier a step: 16.8 us a step, 2.94 ms at B=256.
//
// Design: K1's (the header of bigru_resident.cu has it in full).  H units
// over a cluster of C = H / 32 blocks, each holding its [H, 96] bf16 slice
// of W in registers as mma.sync B fragments, loaded once per launch; R = 16
// or 32 rows a cluster (gru_resident.cuh:plan_rows with one direction); a
// persistent cluster walks its row groups.  Each step: [R, H] x [H, 96] with
// h split hi + lo (two bf16 products into one f32 sum), the cell in f32,
// the new h into the block's slice of the next buffer and from there to
// every peer by one cp.async.bulk that completes on the peer's mbarrier (no
// cluster barrier in the step).  What differs from K1: one direction a
// launch, step s at t = T-1-s when `reverse` is set; h0 loaded into every
// block's copy of h_{-1} (hi plane h0, lo plane 0: h0 is bf16) and into the
// cell's f32 state, so step 0 runs its product too; all T steps; each step
// stores the block's R x 32 units of h_t, rounded to bf16 (the hi plane of
// the split), into out; no max pool.  Shared memory as K1's: at R = 32,
// 160 KB of h slices and 53 KB of partial sums.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W, T = 105, H = 512; chip_smoke.py,
// in turns with the streamed kernel): B=256 0.940 ms (2.915; 16 items of 16
// rows in 3 waves of the card's 7 clusters of 16), B=128 0.549 ms (2.564;
// 4 items of 32 rows in one wave), B=1 0.317 ms (1.504); a dependent step
// 2.84 us (16.94).  185 registers at R = 16, 226 at R = 32, no spill.

#include "gru_resident.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace textreid_resident;

// kMT m-tiles of 16 rows a cluster (R = 16 kMT).  Grid: clusters x C
// blocks, cluster dims (C, 1, 1) at launch; items = row groups, walked with
// a stride of the number of clusters.
template <int kMT>
__global__ void __launch_bounds__(kThreads, 1)
gru_scan_resident_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w,
                         const __nv_bfloat16* __restrict__ h0,
                         __nv_bfloat16* __restrict__ out, int batch, int seq,
                         int hidden, int reverse) {
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

  // the block's W slice -> B fragments, once
  uint32_t bw[kMaxKTiles][kNTiles][2];
  {
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
          const __nv_bfloat16* wk = w + static_cast<size_t>(k) * three_h + col;
          bw[i][j][0] = pack_bf16(wk[0], wk[three_h]);
          bw[i][j][1] = pack_bf16(wk[8 * three_h], wk[9 * three_h]);
        }
      }
    }
  }

  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  uint32_t parity[2] = {0u, 0u};
  cluster.sync();  // every block's barriers are live before peers copy

  const int items = (batch + R - 1) / R;
  const int half_h = hidden / 2;
  for (int item = cluster_id; item < items; item += n_clusters) {
    const int row0 = item * R;
    const int b = row0 + crow;
    const bool live = b < batch;

    // h_{-1} = h0: the whole [R, H] into every slice of buffer 1 (the one
    // step 0 reads), hi = h0 and lo = 0, and the cell's units into f32.
    // The previous item's copies have all landed (its closing cluster
    // barrier), so the buffer is this block's to write.
    for (int i = tid; i < R * half_h; i += kThreads) {
      const int r = i / half_h;
      const int u = (i - r * half_h) * 2;
      uint32_t pair = 0u;
      if (row0 + r < batch) {
        pair = __ldg(reinterpret_cast<const unsigned*>(
            h0 + static_cast<size_t>(row0 + r) * hidden + u));
      }
      __nv_bfloat16* dst = hbuf + (static_cast<size_t>(csize)
                                   + u / kUnits) * kSliceElems
                           + r * kSlice + u % kUnits;
      *reinterpret_cast<uint32_t*>(dst) = pair;
      *reinterpret_cast<uint32_t*>(dst + R * kSlice) = 0u;
    }
    // the peers' bulk copies (async proxy) will overwrite these slices
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    float h[kUPT], xr[kUPT], xz[kUPT], xn[kUPT];
    if (live) {
      load_bf16<kUPT>(h0 + static_cast<size_t>(b) * hidden + unit0 + cu0, h);
    } else {
#pragma unroll
      for (int j = 0; j < kUPT; ++j) h[j] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kUPT; ++j) xr[j] = xz[j] = xn[j] = 0.0f;
    const __nv_bfloat16* xrow =
        x + static_cast<size_t>(live ? b : 0) * seq * three_h + unit0 + cu0;
    __nv_bfloat16* orow =
        out + static_cast<size_t>(live ? b : 0) * seq * hidden + unit0 + cu0;
    if (live) {
      const __nv_bfloat16* xg =
          xrow + static_cast<size_t>(reverse ? seq - 1 : 0) * three_h;
      load_bf16<kUPT>(xg, xr);
      load_bf16<kUPT>(xg + hidden, xz);
      load_bf16<kUPT>(xg + 2 * hidden, xn);
    }
    __syncthreads();  // h_{-1} complete in buffer 1

    for (int s = 0; s < seq; ++s) {
      const int t = reverse ? seq - 1 - s : s;
      const int cur = (s + 1) & 1;  // h_{s-1}; h_s goes to cur ^ 1
      // 1. the recurrent product of h_{s-1}, once every peer's slice of it
      // has landed (h_{-1} was written locally)
      if (s > 0) {
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
      {
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
      __nv_bfloat16 h_hi[kUPT], h_lo[kUPT];
#pragma unroll
      for (int j = 0; j < kUPT; ++j) {
        const float rg = sigmoid_f32(xr[j] + hr[j]);
        const float zg = sigmoid_f32(xz[j] + hz[j]);
        const float ng = tanhf(xn[j] + rg * hn[j]);
        h[j] = (1.0f - zg) * ng + zg * h[j];
        h_hi[j] = __float2bfloat16_rn(h[j]);
        h_lo[j] = __float2bfloat16_rn(h[j] - __bfloat162float(h_hi[j]));
      }
      if (live) {  // h_t rounded once: the hi plane
        store_bf16<kUPT>(orow + static_cast<size_t>(t) * hidden, h_hi);
      }
      // 3. h_s into this block's slice of the next buffer, then the slice
      // into every peer's with one asynchronous bulk copy each (the last
      // step's h is not needed)
      __nv_bfloat16* mine = hbuf + (static_cast<size_t>(cur ^ 1) * csize
                                    + rank) * kSliceElems;
      store_bf16<kUPT>(mine + crow * kSlice + cu0, h_hi);
      store_bf16<kUPT>(mine + (R + crow) * kSlice + cu0, h_lo);
      __syncthreads();  // the slice is complete; `part` is free again
      if (s + 1 < seq) {  // thread p < C copies to block p, at once
        if (tid == 0) {
          mbar_arrive_expect(&bar[cur ^ 1], static_cast<uint32_t>(
                                                (csize - 1) * slice_bytes(R)));
        }
        if (tid < csize && tid != rank) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          copy_to_peer(mine, static_cast<uint32_t>(slice_bytes(R)),
                       &bar[cur ^ 1], tid);
        }
        if (live) {  // the next step's input gates
          const __nv_bfloat16* xg =
              xrow + static_cast<size_t>(reverse ? t - 1 : t + 1) * three_h;
          load_bf16<kUPT>(xg, xr);
          load_bf16<kUPT>(xg + hidden, xz);
          load_bf16<kUPT>(xg + 2 * hidden, xn);
        }
      }
    }
    // every copy of this item has landed before the next item's h0 (or the
    // end of the kernel, which frees the copies' sources)
    cluster.sync();
  }
}

template <int kMT>
cudaError_t scan_config(int hidden, cudaLaunchConfig_t* config,
                        cudaLaunchAttribute* attr, const void** fn) {
  auto kernel = gru_scan_resident_kernel<kMT>;
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
    cudaError_t err = scan_config<kMT>(hidden, &config, &attr, &fn);
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

cudaError_t capacities(int hidden, int* cap32, int* cap16) {
  cudaError_t err = max_clusters<2>(hidden, cap32);
  if (err == cudaSuccess) err = max_clusters<1>(hidden, cap16);
  return err;
}

}  // namespace

// Plain C entry points (bound with ctypes).  bf16 only, hidden % 32 == 0 and
// hidden <= 512 (H / 32 blocks a cluster, at most 16), x and h0 on 16-byte
// boundaries: the Python wrapper checks.  Returns cudaError_t.
extern "C" int gru_scan_fwd_resident(const void* x, const void* w,
                                     const void* h0, void* out, int batch,
                                     int seq, int hidden, int reverse,
                                     void* stream) {
  int cap32 = 0, cap16 = 0, rows = 0, clusters = 0;
  cudaError_t err = capacities(hidden, &cap32, &cap16);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan_rows(batch, 1, cap32, cap16, &rows, &clusters);
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attr;
  const void* fn = nullptr;
  err = rows == 32 ? scan_config<2>(hidden, &config, &attr, &fn)
                   : scan_config<1>(hidden, &config, &attr, &fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  config.gridDim = dim3(clusters * (hidden / kUnits), 1, 1);
  config.stream = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  const auto* hp = static_cast<const __nv_bfloat16*>(h0);
  auto* o = static_cast<__nv_bfloat16*>(out);
  err = rows == 32
            ? cudaLaunchKernelEx(&config, gru_scan_resident_kernel<2>, xp, wp,
                                 hp, o, batch, seq, hidden, reverse)
            : cudaLaunchKernelEx(&config, gru_scan_resident_kernel<1>, xp, wp,
                                 hp, o, batch, seq, hidden, reverse);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The plan gru_scan_fwd_resident takes for B rows: rows a cluster (32 or 16)
// and clusters in the grid, and the clusters of each row count the card
// holds at once.
extern "C" int gru_scan_resident_plan(int batch, int hidden, int* rows,
                                      int* clusters, int* cap32, int* cap16) {
  const cudaError_t err = capacities(hidden, cap32, cap16);
  if (err == cudaSuccess) plan_rows(batch, 1, *cap32, *cap16, rows, clusters);
  return static_cast<int>(err);
}
