// gru_scan_fwd: one-direction GRU scan that returns every hidden state.
//
// Replaces: textreid_tpu/ops/gru_pallas.py:gru_scan_pallas (Pallas kernel
// _gru_scan_kernel, reached through gru_scan_auto), the scan of every layer
// but the last of a multi-layer bi-GRU.  Contract (models.gru.gru_scan):
//   h_t = cell(x[:, t], h_{t-1}, W),  out[:, t] = h_t,  h_{-1} = h0
// for t = 0..T-1, or T-1..0 when `reverse`; the cell is gru_cell.cuh's.  No
// masking by length: every one of the T steps runs, as in the reference.
// Inputs: x [B, T, 3H] batch-major (gate order r, z, n), W [H, 3H],
// h0 [B, H]; f32 or bf16.  Output [B, T, H] in the input dtype; h and the
// gates are f32 throughout and only the stored h_t is rounded.  The layout
// is batch-major on both sides, so the two transposes that gru_scan_auto
// makes around the TPU kernel are not needed.
//
// What bounds it on the H100: the chain of T dependent steps.  A step is a
// [rows, H] x [H, 3H] product that cannot start before the last one ended,
// so the time is T times one step's latency, far above what the bytes
// (x read once, out written once) or the FMAs need.
//
// Design: bigru_pooled.cu's, with one direction and a store of h_t each
// step.  A tile of 8 batch rows is owned by a thread block cluster of 8
// blocks; block r owns H / 8 hidden units and, after each cell update,
// writes its slice of h_t into every block's shared memory (distributed
// shared memory, one cluster barrier per step) and into `out`.  h is double
// buffered in shared memory in f32; W streams from L2 every step.  The
// grid is ceil(B / 8) clusters: 16 at B=128, which one wave of the card
// holds, 32 at B=256, which it does not.

#include "gru_cell.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace textreid_gru;  // kRows, kSplit, the cell (gru_cell.cuh)

// blockDim.x = 2 * units: thread (half, j) sums k in [half H/2, (half+1) H/2)
// for unit u0 + j.
template <typename T>
__global__ void __cluster_dims__(kSplit, 1, 1)
gru_scan_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ h0, T* __restrict__ out, int batch,
                int seq, int hidden, int reverse) {
  cg::cluster_group cluster = cg::this_cluster();
  const int units = hidden / kSplit;
  extern __shared__ float4 smem4[];
  float* h_buf = reinterpret_cast<float*>(smem4);  // [2][kRows][H]
  float* red = h_buf + 2 * kRows * hidden;         // [3][kRows][units]

  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = (blockIdx.x / kSplit) * kRows;
  const int three_h = 3 * hidden;
  const int half = threadIdx.x / units;
  const int j = threadIdx.x - half * units;
  const int u = rank * units + j;  // the hidden unit this thread works on
  const int k_lo = half * (hidden / 2);
  const int k_hi = k_lo + hidden / 2;

  for (int i = threadIdx.x; i < kRows * hidden; i += blockDim.x) {
    const int b = row0 + i / hidden;
    h_buf[i] = b < batch
                   ? to_float(h0[static_cast<size_t>(b) * hidden + i % hidden])
                   : 0.0f;
    h_buf[kRows * hidden + i] = 0.0f;
  }
  cluster.sync();  // every block's shared memory is live before peers write

  for (int s = 0; s < seq; ++s) {
    const int t = reverse ? seq - 1 - s : s;
    const float* h_cur = h_buf + (s & 1) * kRows * hidden;
    const int nxt = ((s + 1) & 1) * kRows * hidden;
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
          const size_t at = static_cast<size_t>(b) * seq + t;
          const T* xg = x + at * three_h;
          const float hr = acc_r[r] + red[(0 * kRows + r) * units + j];
          const float hz = acc_z[r] + red[(1 * kRows + r) * units + j];
          const float hn = acc_n[r] + red[(2 * kRows + r) * units + j];
          h_new = gru_cell(to_float(xg[u]), to_float(xg[hidden + u]),
                           to_float(xg[2 * hidden + u]), hr, hz, hn,
                           h_cur[r * hidden + u]);
          store(out + at * hidden + u, h_new);
        }
        for (int peer = 0; peer < kSplit; ++peer) {
          float* dst = cluster.map_shared_rank(h_buf, peer);
          dst[nxt + r * hidden + u] = h_new;
        }
      }
    }
    cluster.sync();  // h_nxt complete in every block before the next step
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* h0, void* out,
                   int batch, int seq, int hidden, int reverse,
                   cudaStream_t stream) {
  const int units = hidden / kSplit;
  const size_t smem =
      sizeof(float) * (2 * kRows * hidden + 3 * kRows * units);
  auto kernel = gru_scan_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(((batch + kRows - 1) / kRows) * kSplit);
  kernel<<<grid, 2 * units, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(h0), static_cast<T*>(out), batch, seq, hidden,
      reverse);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  hidden % 32 == 0 (each of the
// kSplit blocks owns a multiple of 4 units, each k half is a multiple of
// 4), hidden <= 2048, and the dtype/shape checks are the Python wrapper's
// job.  Returns cudaError_t.
extern "C" int gru_scan_fwd(const void* x, const void* w, const void* h0,
                            void* out, int batch, int seq, int hidden,
                            int reverse, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, w, h0, out, batch, seq, hidden,
                                      reverse, s)
              : launch<float>(x, w, h0, out, batch, seq, hidden, reverse, s);
  return static_cast<int>(err);
}
