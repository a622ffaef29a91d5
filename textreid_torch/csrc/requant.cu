// fused_requant: (LayerNorm without affine | quickGELU | identity), scaling by
// the reciprocal per-channel scale, per-row abs-max, rounding to int8.
//
// Replaces: textreid_tpu/ops/quant_pallas.py:fused_requant (Pallas kernel
// _requant_kernel).  Contract (ops/requant.py:requant_plain), all in f32:
//   x  = f32(x);  ln: (x - mean) * rsqrt(mean((x - mean)^2) + eps)
//                 gelu: x * (1 / (1 + exp(-1.702 x)))
//   xn = x * (1 / s[c])
//   r  = max(max_c |xn|, 1e-6) * (1 / 127)
//   v  = xn * (1 / r);  v += (v >= 0 ? 0.5 : -0.5);  clip to +-127; truncate
// Inputs: x [rows, C] f32 or bf16, s [C] f32.  Outputs: q [rows, C] int8,
// r [rows] f32.  The products and sums of the contract are spelled with
// __fmul_rn / __fadd_rn so that no a*b+c is contracted into an FMA.
//
// What bounds it on the H100: bytes.  A row is read once (2 or 4 bytes an
// element) and written once as int8; the arithmetic is a few operations an
// element.  The composition in eager PyTorch reads and writes the row some
// eight times.
//
// Design: one warp owns a row.  The row is staged in shared memory as f32
// (the statistics need two passes over it and the rounding a third), the
// reductions are warp shuffles, and nothing is synchronised across warps.
// A block holds 8 warps and the reciprocal scales (computed once a block);
// blocks stride over the rows.  Each lane loads 4 consecutive channels (16
// bytes of f32) and stores them as one packed 32-bit word.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kOpLn = 1;
constexpr int kOpGelu = 2;
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                     __high2float(hi));
}

// round half away from zero by +-0.5 and truncation, clipped to +-127
__device__ __forceinline__ uint32_t quantize(float xn, float inv_r) {
  float v = __fmul_rn(xn, inv_r);
  v = __fadd_rn(v, v >= 0.0f ? 0.5f : -0.5f);
  v = fminf(fmaxf(v, -127.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<int>(v)) & 0xffu;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
requant_kernel(const T* __restrict__ x, const float* __restrict__ s,
               int8_t* __restrict__ q, float* __restrict__ r_out, int rows,
               int c, int op, float eps) {
  extern __shared__ float4 smem4[];
  float* inv_s = reinterpret_cast<float*>(smem4);  // [C]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* buf = inv_s + c + warp * c;  // this warp's row, f32

  for (int i = threadIdx.x; i < c; i += blockDim.x)
    inv_s[i] = __frcp_rn(s[i]);
  __syncthreads();

  const float count = static_cast<float>(c);
  for (int row = blockIdx.x * kWarps + warp; row < rows;
       row += gridDim.x * kWarps) {
    const T* xr = x + static_cast<size_t>(row) * c;
    float sum = 0.0f;
    for (int j = lane * 4; j < c; j += 128) {
      const float4 v = load4(xr + j);
      *reinterpret_cast<float4*>(buf + j) = v;
      sum += (v.x + v.y) + (v.z + v.w);
    }
    float mean = 0.0f, rstd = 1.0f;
    if (op == kOpLn) {
      mean = __fdiv_rn(warp_sum(sum), count);
      float sq = 0.0f;
      for (int j = lane * 4; j < c; j += 128) {
        const float4 v = *reinterpret_cast<const float4*>(buf + j);
        const float d0 = v.x - mean, d1 = v.y - mean, d2 = v.z - mean,
                    d3 = v.w - mean;
        sq = __fadd_rn(sq, __fadd_rn(__fadd_rn(__fmul_rn(d0, d0),
                                               __fmul_rn(d1, d1)),
                                     __fadd_rn(__fmul_rn(d2, d2),
                                               __fmul_rn(d3, d3))));
      }
      const float var = __fdiv_rn(warp_sum(sq), count);
      rstd = rsqrtf(__fadd_rn(var, eps));
    }
    float amax = 0.0f;
    for (int j = lane * 4; j < c; j += 128) {
      float4 v = *reinterpret_cast<const float4*>(buf + j);
      float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float y = e[i];
        if (op == kOpLn) {
          y = __fmul_rn(y - mean, rstd);
        } else if (op == kOpGelu) {
          const float t = __fmul_rn(1.702f, y);
          y = __fmul_rn(y, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-t))));
        }
        e[i] = __fmul_rn(y, inv_s[j + i]);
        amax = fmaxf(amax, fabsf(e[i]));
      }
      *reinterpret_cast<float4*>(buf + j) =
          make_float4(e[0], e[1], e[2], e[3]);
    }
    amax = warp_max(amax);
    const float r = __fmul_rn(fmaxf(amax, 1e-6f), kInv127);
    const float inv_r = __frcp_rn(r);
    int8_t* qr = q + static_cast<size_t>(row) * c;
    for (int j = lane * 4; j < c; j += 128) {
      const float4 v = *reinterpret_cast<const float4*>(buf + j);
      const uint32_t packed = quantize(v.x, inv_r) |
                              (quantize(v.y, inv_r) << 8) |
                              (quantize(v.z, inv_r) << 16) |
                              (quantize(v.w, inv_r) << 24);
      *reinterpret_cast<uint32_t*>(qr + j) = packed;
    }
    if (lane == 0) r_out[row] = r;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* s, void* q, void* r, int rows,
                   int c, int op, float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (1 + kWarps) * c;
  auto kernel = requant_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 132 * 8) blocks = 132 * 8;  // resident blocks stride on
  kernel<<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(s),
      static_cast<int8_t*>(q), static_cast<float*>(r), rows, c, op, eps);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  C % 4 == 0, C <= 4096, x and q
// 16-byte aligned; op 0 none, 1 ln, 2 gelu; the dtype and shape checks are
// the Python wrapper's job.  Returns cudaError_t.
extern "C" int fused_requant(const void* x, const void* s, void* q, void* r,
                             int rows, int c, int op, float eps, int is_bf16,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, s, q, r, rows, c, op, eps, st)
              : launch<float>(x, s, q, r, rows, c, op, eps, st);
  return static_cast<int>(err);
}
