// The GRU cell shared by bigru_pooled.cu (the fused bi-GRU with pooling) and
// gru_scan.cu (the one-direction scan that keeps every hidden state).
//
// Counterpart of textreid_tpu/ops/gru_pallas.py:_gru_cell:
//   hg = h W            (f32 accumulation)
//   r = sigmoid(x_r + hg_r), z = sigmoid(x_z + hg_z),
//   n = tanh(x_n + r * hg_n),  h' = (1 - z) n + z h
// Both kernels keep h and every gate in f32 whatever the input dtype and
// round only what they store, so their plain PyTorch versions
// (textreid_torch/ops/gru.py) compute in f32 and cast the result.
//
// Work split (both kernels): a tile of kRows batch rows is owned by a thread
// block cluster of kSplit blocks; block `rank` owns hidden units
// [rank H / kSplit, (rank + 1) H / kSplit).  Two threads share a unit, each
// summing half of the k range of the unit's r, z and n columns of W for all
// kRows rows (recurrent_partial); the owner adds the halves and applies the
// cell (gru_cell).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace textreid_gru {

constexpr int kRows = 8;   // batch rows per cluster
constexpr int kSplit = 8;  // blocks per cluster; each owns H / kSplit units

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Partial recurrent products of one hidden unit for kRows rows:
//   acc_g[r] = sum_{k in [k_lo, k_hi)} h_cur[r][k] * W[k][g H + u]
// `wcol` points at W[0][u] (row stride 3 H), `h_cur` at [kRows][H] floats in
// shared memory.  k_lo and k_hi are multiples of 4.
template <typename T>
__device__ __forceinline__ void recurrent_partial(
    const T* __restrict__ wcol, const float* __restrict__ h_cur, int hidden,
    int k_lo, int k_hi, float (&acc_r)[kRows], float (&acc_z)[kRows],
    float (&acc_n)[kRows]) {
  const int three_h = 3 * hidden;
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc_r[r] = acc_z[r] = acc_n[r] = 0.0f;
  // 4 iterations' W loads in flight: the loop waits on L2, not on FMAs
#pragma unroll 4
  for (int k = k_lo; k < k_hi; k += 4) {
    float wr[4], wz[4], wn[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const T* wrow = wcol + static_cast<size_t>(k + q) * three_h;
      wr[q] = to_float(wrow[0]);
      wz[q] = to_float(wrow[hidden]);
      wn[q] = to_float(wrow[2 * hidden]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 hv =
          *reinterpret_cast<const float4*>(h_cur + r * hidden + k);
      acc_r[r] = fmaf(hv.x, wr[0], acc_r[r]);
      acc_r[r] = fmaf(hv.y, wr[1], acc_r[r]);
      acc_r[r] = fmaf(hv.z, wr[2], acc_r[r]);
      acc_r[r] = fmaf(hv.w, wr[3], acc_r[r]);
      acc_z[r] = fmaf(hv.x, wz[0], acc_z[r]);
      acc_z[r] = fmaf(hv.y, wz[1], acc_z[r]);
      acc_z[r] = fmaf(hv.z, wz[2], acc_z[r]);
      acc_z[r] = fmaf(hv.w, wz[3], acc_z[r]);
      acc_n[r] = fmaf(hv.x, wn[0], acc_n[r]);
      acc_n[r] = fmaf(hv.y, wn[1], acc_n[r]);
      acc_n[r] = fmaf(hv.z, wn[2], acc_n[r]);
      acc_n[r] = fmaf(hv.w, wn[3], acc_n[r]);
    }
  }
}

// One unit's cell update from its input gates (x_*), its recurrent products
// (h_*) and its previous state.
__device__ __forceinline__ float gru_cell(float x_r, float x_z, float x_n,
                                          float h_r, float h_z, float h_n,
                                          float h_prev) {
  const float rg = sigmoid(x_r + h_r);
  const float zg = sigmoid(x_z + h_z);
  const float ng = tanhf(x_n + rg * h_n);
  return (1.0f - zg) * ng + zg * h_prev;
}

}  // namespace textreid_gru
