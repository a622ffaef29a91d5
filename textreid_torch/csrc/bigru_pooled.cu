// bigru_pooled_fwd: fused 1-layer bidirectional GRU with masked
// max-over-time pooling, forward only.
//
// Replaces: textreid_tpu/ops/gru_pallas.py:bigru_pooled_scan (Pallas kernel
// _bigru_pooled_kernel via _bigru_pooled_pallas).  It computes what
// _xla_pooled_forward computes WITHOUT the zero-participation rule, which
// the Python wrapper (textreid_torch/ops/gru.py) applies afterwards:
//   out[b, d*H:(d+1)*H] = max_{t < len_b} h_t^d[b]      (d = fwd, bwd)
//   r = sigmoid(x_r + h W_r), z = sigmoid(x_z + h W_z),
//   n = tanh(x_n + r * (h W_n)),  h' = (1 - z) n + z h,  h_0 = 0
// Inputs: xf, xb [B, T, 3H] (xb already reversed per sample), w_f, w_b
// [H, 3H], lengths [B] int32; f32 or bf16.  Compute and h are f32
// throughout; the output [B, 2H] is cast to the input dtype.
//
// What bounds it on the H100: the recurrence is sequential in t, so each
// step is a [rows, H] x [H, 3H] product that cannot start before the last
// one ended, and at serving batch sizes (64, 256) that product is small:
// the time goes to the latency of one step, not to bytes or flops.  A
// direction's W_hh is 3 MB in f32 (1.5 MB bf16): it does not fit a
// block's 227 KB of shared memory, as the TPU kernel's resident VMEM copy
// did, so it streams from L2 every step.  The first design, one block per
// 8-row tile, took 7.8-8.1 ms a call at every B from 64 to 256 (H100 SXM,
// 700 W): one SM carried each step's whole product.
//
// Design: rows of the batch are independent, and a row tile's hidden units
// are split over a thread block cluster of kSplit = 8 blocks, which
// exchange h through distributed shared memory with one cluster barrier
// per step (no grid-wide synchronisation).  Grid = (ceil(B / 8) * 8, 2
// directions), one persistent launch.  Block r of a cluster owns hidden
// units [r H / 8, (r + 1) H / 8) for its 8 rows.  Two threads share a
// unit, each summing half of the k range of the r, z and n columns (u,
// H+u, 2H+u) for all 8 rows, so W loads are coalesced across the warp and
// h is read from shared memory as float4 broadcasts.  After the cell
// update the owner writes its slice of h_new into every block of the
// cluster; h (double buffered) and the running max stay in shared memory
// in f32.  Only the pooled [8, 2H] leaves the cluster.  Measured (bf16):
// 3.5 ms at B=64 and 7.6 ms at B=256, where the 64 clusters no longer fit
// the card at once; unrolling the k loop 4 times to keep more W loads in
// flight gives 3.0 and 6.5 ms (and moves the wave boundary below B=192,
// which serving never runs: it calls B=64 and B=256).  Fewer, fatter
// clusters (16 rows) were slower at every B.

#include "gru_cell.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace textreid_gru;  // kRows, kSplit, the cell (gru_cell.cuh)

// blockDim.x = 2 * units: thread (half, j) sums k in [half H/2, (half+1) H/2)
// for unit u0 + j.
template <typename T>
__global__ void __cluster_dims__(kSplit, 1, 1)
bigru_pooled_kernel(const T* __restrict__ xf, const T* __restrict__ xb,
                    const T* __restrict__ wf, const T* __restrict__ wb,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int batch, int seq, int hidden) {
  cg::cluster_group cluster = cg::this_cluster();
  const int units = hidden / kSplit;
  extern __shared__ float4 smem4[];
  float* h_buf = reinterpret_cast<float*>(smem4);  // [2][kRows][H]
  float* m_buf = h_buf + 2 * kRows * hidden;       // [kRows][units]
  float* red = m_buf + kRows * units;              // [3][kRows][units]
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
          h_new = gru_cell(to_float(xg[u]), to_float(xg[hidden + u]),
                           to_float(xg[2 * hidden + u]), hr, hz, hn,
                           h_cur[r * hidden + u]);
          if (t < len_s[r]) {
            m_buf[r * units + j] = fmaxf(m_buf[r * units + j], h_new);
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
        store(out + static_cast<size_t>(b) * 2 * hidden + dir * hidden + u,
              m_buf[r * units + j]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* xf, const void* xb, const void* wf,
                   const void* wb, const int* lengths, void* out, int batch,
                   int seq, int hidden, cudaStream_t stream) {
  const int units = hidden / kSplit;
  const size_t smem =
      sizeof(float) * (2 * kRows * hidden + 4 * kRows * units);
  auto kernel = bigru_pooled_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(((batch + kRows - 1) / kRows) * kSplit, 2);
  kernel<<<grid, 2 * units, smem, stream>>>(
      static_cast<const T*>(xf), static_cast<const T*>(xb),
      static_cast<const T*>(wf), static_cast<const T*>(wb), lengths,
      static_cast<T*>(out), batch, seq, hidden);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, called by bigru_resident.cu's bigru_pooled_fwd for
// f32 inputs (bf16 there runs the W-resident kernel; this one's bf16 is
// kept for comparison: tools/gru_variants.py, chip_smoke.py).  hidden % 32
// == 0 (each of the kSplit blocks owns a multiple of 4 units, each k half
// is a multiple of 4), hidden <= 2048, and the dtype/shape checks are the
// Python wrapper's job.  Returns cudaError_t.
extern "C" int bigru_pooled_fwd_streamed(const void* xf, const void* xb,
                                const void* wf, const void* wb,
                                const void* lengths, void* out, int batch,
                                int seq, int hidden, int is_bf16,
                                void* stream) {
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(xf, xb, wf, wb, lens, out, batch, seq,
                                      hidden, s)
              : launch<float>(xf, xb, wf, wb, lens, out, batch, seq, hidden,
                              s);
  return static_cast<int>(err);
}

// Message for a cudaError_t returned by any entry point of this library.
extern "C" const char* textreid_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
