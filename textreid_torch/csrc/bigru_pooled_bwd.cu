// bigru_pooled_fwd_train, bigru_pooled_bwd: the training forward of K1
// (bigru_pooled.cu, the fused 1-layer bi-GRU with masked max pooling) and
// its backward.
//
// Replaces: the VJP of textreid_tpu/ops/gru_pallas.py:bigru_pooled_scan's
// custom_vjp (`bwd`, which differentiates _xla_pooled_forward through XLA:
// the JAX package has no backward kernel).  Contract: ops/gru.py,
// bigru_pooled_fwd_train_plain and bigru_pooled_bwd_plain.
//
// Training forward: bigru_pooled.cu's kernel (the same cluster split, the
// same arithmetic) where the owner of (row, unit) also stores, each step,
// h_{t-1} and the gates r, z, n and h_n = (h_{t-1} W)_n in f32
// [2, B, T, 4, H], and keeps the running argmax beside the running max in
// shared memory: the first t < len whose h_t reached the max (it moves only
// on a strictly greater value), -1 where len = 0.  That is 5 f32 stores a
// (row, unit, step) against a dependent step of ~18 us.  It is a copy of
// that kernel in a file of its own, not a template flag on it: built in one
// file with these kernels (as a flag, or as its own text) and a shared
// header grown for them, the pooled-only kernel that serving and eval
// launch took 142 registers instead of 154 and 5.47-5.69 ms instead of
// 5.25-5.29 at B=256, bf16 (H100, tools/gru_variants.py), so
// bigru_pooled.cu and gru_cell.cuh stay as they were.
//
// Backward, per direction, row and unit, t = T-1 .. 0:
//   dh   += [t == argmax] g
//   a_z   = dh (h_{t-1} - n) z (1 - z),  a_n = dh (1 - z) (1 - n^2),
//   a_r   = a_n h_n r (1 - r)
//   dx_t  = [a_r, a_z, a_n]  (input dtype),  dhg_t = [a_r, a_z, a_n r]
//   dh    = dh z + dhg_t W^T
// and dW = sum_t h_{t-1}^T dhg_t, which the wrapper computes as one f32
// product over B T rows from the stored h_{t-1} and dhg (f32 [2, B, T, 3H]).
//
// What bounds it on the H100: as in the forward, the chain of T dependent
// steps, each one [rows, 3H] x [3H, H] product, as many FMAs and W bytes as
// a forward step.  Design: the forward's split, a cluster of 8 blocks per
// 8-row tile, block r owning units U_r; each step a block applies the cell
// gradient to its units, writes its 3 x units columns of dhg into every
// block of the cluster (3x the forward's h exchange), one cluster barrier,
// then the product with W^T [3H, H] (the wrapper's transpose, so the loads
// are k-major and coalesced across units, the forward's access).  k = 3H
// is split over kBwdParts = 4 threads a unit (3.0 ms at B=128; 2 threads a
// unit: 3.5 ms), and each of the 4 applies the cell gradient of 2 of the 8
// rows.  The saved state does not depend on the chain: each thread loads
// step t-1's into registers while step t's product runs.  The loop starts
// at the tile's longest length: later steps have a zero gradient and are
// written as zeros.  Shared memory: dhg double buffered, 2 x 8 x 3H f32 (96
// KB at H=512) and the partial sums, 104 KB a block; 256 threads held to
// 128 registers: two blocks an SM (unbounded, ptxas took 134-140 and the
// card held 15 of B=128's 32 clusters at once; bounded, 30).  H <= 512.

#include "gru_cell.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace textreid_gru;  // kRows, kSplit, recurrent_partial, gru_cell.cuh

// One unit's cell update, as gru_cell.cuh's gru_cell, with the gates.
struct GruGates {
  float r, z, n, h;
};

__device__ __forceinline__ GruGates gru_gates(float x_r, float x_z, float x_n,
                                              float h_r, float h_z, float h_n,
                                              float h_prev) {
  GruGates out;
  out.r = sigmoid(x_r + h_r);
  out.z = sigmoid(x_z + h_z);
  out.n = tanhf(x_n + out.r * h_n);
  out.h = (1.0f - out.z) * out.n + out.z * h_prev;
  return out;
}

// blockDim.x = 2 * units: thread (half, j) sums k in [half H/2, (half+1) H/2)
// for unit u0 + j.
template <typename T>
__global__ void __cluster_dims__(kSplit, 1, 1)
bigru_pooled_train_kernel(const T* __restrict__ xf, const T* __restrict__ xb,
                          const T* __restrict__ wf, const T* __restrict__ wb,
                          const int* __restrict__ lengths, T* __restrict__ out,
                          float* __restrict__ hp, float* __restrict__ gates,
                          int* __restrict__ argmax, int batch, int seq,
                          int hidden) {
  cg::cluster_group cluster = cg::this_cluster();
  const int units = hidden / kSplit;
  extern __shared__ float4 smem4[];
  float* h_buf = reinterpret_cast<float*>(smem4);  // [2][kRows][H]
  float* m_buf = h_buf + 2 * kRows * hidden;       // [kRows][units]
  float* red = m_buf + kRows * units;              // [3][kRows][units]
  int* am_buf = reinterpret_cast<int*>(red + 3 * kRows * units);  // argmax
  __shared__ int len_s[kRows];

  const int dir = blockIdx.y;
  const T* __restrict__ x = dir == 0 ? xf : xb;
  const T* __restrict__ w = dir == 0 ? wf : wb;
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = (blockIdx.x / kSplit) * kRows;
  const int three_h = 3 * hidden;
  const int half = threadIdx.x / units;
  const int j = threadIdx.x - half * units;
  const int u = rank * units + j;  // the hidden unit this thread works on
  const int k_lo = half * (hidden / 2);
  const int k_hi = k_lo + hidden / 2;

  for (int i = threadIdx.x; i < 2 * kRows * hidden; i += blockDim.x) {
    h_buf[i] = 0.0f;
  }
  for (int i = threadIdx.x; i < kRows * units; i += blockDim.x) {
    m_buf[i] = -INFINITY;
    am_buf[i] = -1;
  }
  if (threadIdx.x < kRows) {
    const int b = row0 + threadIdx.x;
    len_s[threadIdx.x] = b < batch ? lengths[b] : 0;
  }
  cluster.sync();  // every block's shared memory is live before peers write

  for (int t = 0; t < seq; ++t) {
    const float* h_cur = h_buf + (t & 1) * kRows * hidden;
    const int nxt = ((t + 1) & 1) * kRows * hidden;
    float acc_r[kRows], acc_z[kRows], acc_n[kRows];
    recurrent_partial(w + u, h_cur, hidden, k_lo, k_hi, acc_r, acc_z, acc_n);
    if (half == 1) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        red[(0 * kRows + r) * units + j] = acc_r[r];
        red[(1 * kRows + r) * units + j] = acc_z[r];
        red[(2 * kRows + r) * units + j] = acc_n[r];
      }
    }
    __syncthreads();  // the upper k half's partial sums are in red
    if (half == 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int b = row0 + r;
        float h_new = 0.0f;
        if (b < batch) {
          const T* xg = x + (static_cast<size_t>(b) * seq + t) * three_h;
          const float hr = acc_r[r] + red[(0 * kRows + r) * units + j];
          const float hz = acc_z[r] + red[(1 * kRows + r) * units + j];
          const float hn = acc_n[r] + red[(2 * kRows + r) * units + j];
          const float h_prev = h_cur[r * hidden + u];
          const GruGates gt =
              gru_gates(to_float(xg[u]), to_float(xg[hidden + u]),
                        to_float(xg[2 * hidden + u]), hr, hz, hn, h_prev);
          h_new = gt.h;
          const size_t at = (static_cast<size_t>(dir) * batch + b) * seq + t;
          hp[at * hidden + u] = h_prev;
          float* gp = gates + at * 4 * hidden + u;
          gp[0] = gt.r;
          gp[hidden] = gt.z;
          gp[2 * hidden] = gt.n;
          gp[3 * hidden] = hn;
          // the first step at the max: it moves on a strictly greater value
          if (t < len_s[r] && h_new > m_buf[r * units + j]) {
            m_buf[r * units + j] = h_new;
            am_buf[r * units + j] = t;
          }
        }
        for (int peer = 0; peer < kSplit; ++peer) {
          float* dst = cluster.map_shared_rank(h_buf, peer);
          dst[nxt + r * hidden + u] = h_new;
        }
      }
    }
    cluster.sync();  // h_nxt complete in every block before the next step
  }

  if (half == 0) {
    for (int r = 0; r < kRows; ++r) {
      const int b = row0 + r;
      if (b < batch) {
        const size_t at = static_cast<size_t>(b) * 2 * hidden + dir * hidden + u;
        store(out + at, m_buf[r * units + j]);
        argmax[at] = am_buf[r * units + j];
      }
    }
  }
}

template <typename T>
cudaError_t launch_train(const void* xf, const void* xb, const void* wf,
                         const void* wb, const int* lengths, void* out,
                         float* hp, float* gates, int* argmax, int batch,
                         int seq, int hidden, cudaStream_t stream) {
  const int units = hidden / kSplit;
  const size_t smem =
      sizeof(float) * (2 * kRows * hidden + 5 * kRows * units);
  auto kernel = bigru_pooled_train_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(((batch + kRows - 1) / kRows) * kSplit, 2);
  kernel<<<grid, 2 * units, smem, stream>>>(
      static_cast<const T*>(xf), static_cast<const T*>(xb),
      static_cast<const T*>(wf), static_cast<const T*>(wb), lengths,
      static_cast<T*>(out), hp, gates, argmax, batch, seq, hidden);
  return cudaGetLastError();
}

// -- the backward --------------------------------------------------------------

constexpr int kBwdParts = 4;                // threads a unit
constexpr int kOwn = kRows / kBwdParts;     // rows whose cell gradient a
                                            // thread applies
constexpr int kBwdMaxHidden = 512;
// blocks of H / 2 threads, two an SM (see the header)
constexpr int kBwdThreads = kBwdParts * kBwdMaxHidden / kSplit;
static_assert(kRows % kBwdParts == 0, "rows split evenly over the parts");

// Partial sums of one unit's dh for kRows rows over a k range of the
// backward's product, the forward's recurrent_partial (gru_cell.cuh) over one
// column of W^T instead of three of W:
//   acc[r] = sum_{k in [k_lo, k_hi)} dhg[r][k] * W^T[k][u]
// `wtcol` points at W^T[0][u] (row stride H), `dhg` at [kRows][3H] floats
// in shared memory; k_lo and k_hi are multiples of 4.
template <typename T>
__device__ __forceinline__ void dhg_partial(const T* __restrict__ wtcol,
                                            const float* __restrict__ dhg,
                                            int hidden, int k_lo, int k_hi,
                                            float (&acc)[kRows]) {
  const int three_h = 3 * hidden;
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  // 4 iterations' W loads in flight, as in the forward
#pragma unroll 4
  for (int k = k_lo; k < k_hi; k += 4) {
    float wv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      wv[q] = to_float(wtcol[static_cast<size_t>(k + q) * hidden]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 v =
          *reinterpret_cast<const float4*>(dhg + r * three_h + k);
      acc[r] = fmaf(v.x, wv[0], acc[r]);
      acc[r] = fmaf(v.y, wv[1], acc[r]);
      acc[r] = fmaf(v.z, wv[2], acc[r]);
      acc[r] = fmaf(v.w, wv[3], acc[r]);
    }
  }
}

// Saved state of one (row, unit, step): r, z, n, h_n, h_{t-1}.
struct Saved {
  float r, z, n, hn, hp;
};

__device__ __forceinline__ Saved load_saved(const float* __restrict__ hp,
                                            const float* __restrict__ gates,
                                            size_t at, int hidden, int u) {
  const float* gp = gates + at * 4 * hidden + u;
  return {gp[0], gp[hidden], gp[2 * hidden], gp[3 * hidden],
          hp[at * hidden + u]};
}

// blockDim.x = kBwdParts * units: thread (part, j) sums k in
// [part 3H / kBwdParts, (part + 1) 3H / kBwdParts) of dhg W^T for unit
// u0 + j and all kRows rows, and applies the cell gradient of rows part,
// part + kBwdParts, ...
template <typename T>
__global__ void __cluster_dims__(kSplit, 1, 1)
__launch_bounds__(kBwdThreads, 2)
bigru_pooled_bwd_kernel(const T* __restrict__ g, const T* __restrict__ wtf,
                        const T* __restrict__ wtb,
                        const int* __restrict__ lengths,
                        const float* __restrict__ hp,
                        const float* __restrict__ gates,
                        const int* __restrict__ argmax, T* __restrict__ dxf,
                        T* __restrict__ dxb, float* __restrict__ dhg,
                        int batch, int seq, int hidden) {
  cg::cluster_group cluster = cg::this_cluster();
  const int units = hidden / kSplit;
  const int three_h = 3 * hidden;
  extern __shared__ float4 smem4[];
  float* v_buf = reinterpret_cast<float*>(smem4);  // [2][kRows][3H]: dhg_t
  float* red = v_buf + 2 * kRows * three_h;        // [kBwdParts][kRows][units]
  __shared__ int t_top_s;

  const int dir = blockIdx.y;
  const T* __restrict__ wt = dir == 0 ? wtf : wtb;
  T* __restrict__ dx = dir == 0 ? dxf : dxb;
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = (blockIdx.x / kSplit) * kRows;
  const int part = threadIdx.x / units;
  const int j = threadIdx.x - part * units;
  const int u = rank * units + j;  // the hidden unit this thread works on
  const int k_lo = part * (three_h / kBwdParts);
  const int k_hi = k_lo + three_h / kBwdParts;

  // The tile's longest length: no pool gradient enters at a later step, so
  // every later step's gradient is zero.  The same in every block of the
  // cluster, so all of them pass the same number of barriers.
  if (threadIdx.x == 0) {
    int top = 0;
    for (int r = 0; r < kRows; ++r) {
      const int b = row0 + r;
      if (b < batch) top = max(top, min(lengths[b], seq));
    }
    t_top_s = top;
  }
  __syncthreads();
  const int t_top = t_top_s;

  float gpool[kOwn], dh[kOwn];
  int am[kOwn];
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    const int b = row0 + part + i * kBwdParts;
    const bool valid = b < batch;
    const size_t at = static_cast<size_t>(b) * 2 * hidden + dir * hidden + u;
    gpool[i] = valid ? to_float(g[at]) : 0.0f;
    am[i] = valid ? argmax[at] : -1;
    dh[i] = 0.0f;
    if (valid) {
      for (int t = t_top; t < seq; ++t) {
        const size_t bt = static_cast<size_t>(b) * seq + t;
        T* d = dx + bt * three_h + u;
        store(d, 0.0f);
        store(d + hidden, 0.0f);
        store(d + 2 * hidden, 0.0f);
        float* e = dhg + (static_cast<size_t>(dir) * batch * seq + bt) *
                             three_h + u;
        e[0] = e[hidden] = e[2 * hidden] = 0.0f;
      }
    }
  }
  cluster.sync();  // every block's shared memory is live before peers write

  // step t_top - 1's saved states; then each step loads the next one's
  // before its product, which does not depend on them
  Saved next[kOwn];
  auto load_step = [&](int t) {
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      const int b = row0 + part + i * kBwdParts;
      next[i] = b < batch
                    ? load_saved(hp, gates,
                                 (static_cast<size_t>(dir) * batch + b) * seq +
                                     t, hidden, u)
                    : Saved{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    }
  };
  if (t_top > 0) load_step(t_top - 1);

  for (int t = t_top - 1; t >= 0; --t) {
    Saved cur[kOwn];
#pragma unroll
    for (int i = 0; i < kOwn; ++i) cur[i] = next[i];
    if (t > 0) load_step(t - 1);
    float* v_cur = v_buf + (t & 1) * kRows * three_h;
    float dhz[kOwn];
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      const int r = part + i * kBwdParts;
      const int b = row0 + r;
      const Saved& s = cur[i];
      if (am[i] == t) dh[i] += gpool[i];
      const float a_z = dh[i] * (s.hp - s.n) * s.z * (1.0f - s.z);
      const float a_n = dh[i] * (1.0f - s.z) * (1.0f - s.n * s.n);
      const float a_r = a_n * s.hn * s.r * (1.0f - s.r);
      const float a_hn = a_n * s.r;
      dhz[i] = dh[i] * s.z;
      if (b < batch) {
        const size_t bt = static_cast<size_t>(b) * seq + t;
        T* d = dx + bt * three_h + u;
        store(d, a_r);
        store(d + hidden, a_z);
        store(d + 2 * hidden, a_n);
        float* e = dhg + (static_cast<size_t>(dir) * batch * seq + bt) *
                             three_h + u;
        e[0] = a_r;
        e[hidden] = a_z;
        e[2 * hidden] = a_hn;
      }
      if (t > 0) {
        for (int peer = 0; peer < kSplit; ++peer) {
          float* dst = cluster.map_shared_rank(v_cur, peer) + r * three_h + u;
          dst[0] = a_r;
          dst[hidden] = a_z;
          dst[2 * hidden] = a_hn;
        }
      }
    }
    if (t == 0) break;  // h_{-1} is a constant: no product for it
    cluster.sync();     // dhg_t of every unit in every block

    float acc[kRows];
    dhg_partial(wt + u, v_cur, hidden, k_lo, k_hi, acc);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      red[(part * kRows + r) * units + j] = acc[r];
    }
    __syncthreads();  // every part's partial sums are in red
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      const int r = part + i * kBwdParts;
      float sum = dhz[i];
#pragma unroll
      for (int p = 0; p < kBwdParts; ++p) {
        sum += red[(p * kRows + r) * units + j];
      }
      dh[i] = sum;
    }
  }
}

size_t bwd_smem(int hidden) {
  return sizeof(float) *
         (2 * kRows * 3 * hidden + kBwdParts * kRows * (hidden / kSplit));
}

template <typename T>
cudaError_t launch_bwd(const void* g, const void* wtf, const void* wtb,
                       const int* lengths, const float* hp,
                       const float* gates, const int* argmax, void* dxf,
                       void* dxb, float* dhg, int batch, int seq, int hidden,
                       cudaStream_t stream) {
  const size_t smem = bwd_smem(hidden);
  auto kernel = bigru_pooled_bwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(((batch + kRows - 1) / kRows) * kSplit, 2);
  kernel<<<grid, kBwdParts * (hidden / kSplit), smem, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(wtf),
      static_cast<const T*>(wtb), lengths, hp, gates, argmax,
      static_cast<T*>(dxf), static_cast<T*>(dxb), dhg, batch, seq, hidden);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  hidden % 32 == 0 and hidden
// <= 512; the dtype/shape checks are the Python wrapper's job.  Each
// returns cudaError_t.

// The f32 training forward: the pooled output, and hp [2, B, T, H], gates
// [2, B, T, 4, H] (f32) and argmax [B, 2H] (int32) for bigru_pooled_bwd.
// Called by bigru_resident.cu's bigru_pooled_fwd_train for f32 inputs (bf16
// runs the W-resident kernel there).
extern "C" int bigru_pooled_fwd_train_streamed(
    const void* xf, const void* xb, const void* wf, const void* wb,
    const void* lengths, void* out, void* hp, void* gates, void* argmax,
    int batch, int seq, int hidden, void* stream) {
  return static_cast<int>(launch_train<float>(
      xf, xb, wf, wb, static_cast<const int*>(lengths), out,
      static_cast<float*>(hp), static_cast<float*>(gates),
      static_cast<int*>(argmax), batch, seq, hidden,
      static_cast<cudaStream_t>(stream)));
}

// The backward: g [B, 2H] and wt_f, wt_b = W^T [3H, H] in the input dtype,
// lengths, the training forward's hp, gates and argmax -> dxf, dxb
// [B, T, 3H] in the input dtype and dhg [2, B, T, 3H] f32 (dW = hp^T dhg
// is the wrapper's product).
extern "C" int bigru_pooled_bwd(const void* g, const void* wtf,
                                const void* wtb, const void* lengths,
                                const void* hp, const void* gates,
                                const void* argmax, void* dxf, void* dxb,
                                void* dhg, int batch, int seq, int hidden,
                                int is_bf16, void* stream) {
  const int* lens = static_cast<const int*>(lengths);
  const float* hpf = static_cast<const float*>(hp);
  const float* gf = static_cast<const float*>(gates);
  const int* am = static_cast<const int*>(argmax);
  float* dh = static_cast<float*>(dhg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_bwd<__nv_bfloat16>(g, wtf, wtb, lens, hpf, gf, am,
                                          dxf, dxb, dh, batch, seq, hidden, s)
              : launch_bwd<float>(g, wtf, wtb, lens, hpf, gf, am, dxf, dxb,
                                  dh, batch, seq, hidden, s);
  return static_cast<int>(err);
}

// How many clusters of the backward the card holds at once (the
// occupancy calculator's cudaOccupancyMaxActiveClusters) for B rows: a
// grid of more clusters than this runs in more than one wave.
extern "C" int bigru_pooled_bwd_clusters(int batch, int hidden, int is_bf16,
                                         int* clusters) {
  const size_t smem = bwd_smem(hidden);
  const void* kernel =
      is_bf16 ? reinterpret_cast<const void*>(
                    bigru_pooled_bwd_kernel<__nv_bfloat16>)
              : reinterpret_cast<const void*>(bigru_pooled_bwd_kernel<float>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(((batch + kRows - 1) / kRows) * kSplit, 2);
  config.blockDim = dim3(kBwdParts * (hidden / kSplit));
  config.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kSplit;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(clusters, kernel, &config));
}

