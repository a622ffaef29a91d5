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
// Design: one warp owns a row, and for C <= 1024 (every LayerNorm and
// identity site of both towers: C = 512, 768) the row stays in registers,
// C / 32 values a lane (rows_kernel).  A lane loads 16 bytes at a time (8
// bf16 or 4 f32 channels; a warp's load covers 512 contiguous bytes) and
// always owns the same channels, so it takes their reciprocal scales once
// per launch.  The mean, the variance, the abs-max and the rounding run
// from registers with warp shuffles only; the next row's loads are issued
// before the current row's reductions, so each warp keeps two rows in
// flight; a lane stores each 8 (bf16) or 4 (f32) channels as one packed
// int8 word.  The grid is as many blocks as the card holds at once (the
// occupancy API), striding over the rows: no ragged last wave.  Wider rows
// (the quickGELU sites at C = 2048, 3072), and bf16 rows of C % 8 != 0, run
// the staged design (staged_kernel): the row in shared memory as f32, four
// passes over it (sum, variance, scale and abs-max, rounding), 4 channels a
// lane, 8 warps a block with the block's reciprocal scales; it is the
// kernel of every C before the register design.  The choice is made by C
// in `launch` below.  `python -m textreid_torch.tools.int8_variants
// --variants k9` times the register design in turns with the staged
// design at every C (a text patch of this file) and, with `--against`,
// with another checkout's requant.cu.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; tools/int8_variants.py --variants
// k9, ln, bf16, in turns with the staged design, launches queued behind a
// device sleep so that the host's time to issue them is not counted):
// [24,704, 768] 0.0277 ms warm (staged 0.0311), 0.0317 ms with L2 flushed
// before each launch (0.0347), against a bound of 0.0170; [25,600, 512]
// 0.0195 warm (0.0202), 0.0246 flushed (0.0243), bound 0.0118.  Through
// the wrapper as the host issues the launches, 0.035-0.052 ms: the
// wrapper's host time, not the kernel, sets that reading.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRegisterC = 1024;  // widest row held in registers
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
staged_kernel(const T* __restrict__ x, const float* __restrict__ s,
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
cudaError_t launch_staged(const void* x, const void* s, void* q, void* r,
                          int rows, int c, int op, float eps,
                          cudaStream_t stream) {
  const size_t smem = sizeof(float) * (1 + kWarps) * c;
  auto kernel = staged_kernel<T>;
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

template <typename T>
__device__ __forceinline__ void load16(const T* p, uint4& raw) {
  raw = __ldg(reinterpret_cast<const uint4*>(p));
}

// 16 bytes of a row (8 bf16 or 4 f32 channels) as floats
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& raw, float* v) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
      v[2 * i] = __low2float(h);
      v[2 * i + 1] = __high2float(h);
    }
  } else {
    v[0] = __uint_as_float(raw.x);
    v[1] = __uint_as_float(raw.y);
    v[2] = __uint_as_float(raw.z);
    v[3] = __uint_as_float(raw.w);
  }
}

// kLoads 16-byte pieces a lane hold a row of up to 32 kLoads kVec channels
// (kVec = 8 bf16 or 4 f32): piece j of lane l is channels (32 j + l) kVec
// on.  Pieces past C are neither loaded nor stored.
template <typename T, int kLoads>
__global__ void __launch_bounds__(kWarps * 32)
rows_kernel(const T* __restrict__ x, const float* __restrict__ s,
            int8_t* __restrict__ q, float* __restrict__ r_out, int rows,
            int c, int op, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  bool live[kLoads];
  float inv_s[kLoads][kVec];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int ch = (32 * j + lane) * kVec;
    live[j] = ch < c;
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      inv_s[j][e] = live[j] ? __frcp_rn(s[ch + e]) : 0.0f;
  }
  const int stride = gridDim.x * kWarps;
  int row = blockIdx.x * kWarps + warp;
  uint4 raw[kLoads];
  if (row < rows) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j)
      if (live[j])
        load16(x + static_cast<size_t>(row) * c + (32 * j + lane) * kVec,
               raw[j]);
  }
  const float count = static_cast<float>(c);
  for (; row < rows; row += stride) {
    float v[kLoads][kVec];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      if (live[j]) {
        unpack16<T>(raw[j], v[j]);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) v[j][e] = 0.0f;
      }
    }
    const int next = row + stride;  // its loads fly during this row's work
    if (next < rows) {
#pragma unroll
      for (int j = 0; j < kLoads; ++j)
        if (live[j])
          load16(x + static_cast<size_t>(next) * c + (32 * j + lane) * kVec,
                 raw[j]);
    }
    float mean = 0.0f, rstd = 1.0f;
    if (op == kOpLn) {
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kLoads; ++j)
#pragma unroll
        for (int e = 0; e < kVec; e += 4)
          sum += (v[j][e] + v[j][e + 1]) + (v[j][e + 2] + v[j][e + 3]);
      mean = __fdiv_rn(warp_sum(sum), count);
      float sq = 0.0f;
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        if (!live[j]) continue;
#pragma unroll
        for (int e = 0; e < kVec; e += 4) {
          const float d0 = v[j][e] - mean, d1 = v[j][e + 1] - mean,
                      d2 = v[j][e + 2] - mean, d3 = v[j][e + 3] - mean;
          sq = __fadd_rn(sq, __fadd_rn(__fadd_rn(__fmul_rn(d0, d0),
                                                 __fmul_rn(d1, d1)),
                                       __fadd_rn(__fmul_rn(d2, d2),
                                                 __fmul_rn(d3, d3))));
        }
      }
      const float var = __fdiv_rn(warp_sum(sq), count);
      rstd = rsqrtf(__fadd_rn(var, eps));
    }
    float amax = 0.0f;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        float y = v[j][e];
        if (op == kOpLn) {
          y = __fmul_rn(y - mean, rstd);
        } else if (op == kOpGelu) {
          const float t = __fmul_rn(1.702f, y);
          y = __fmul_rn(y, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-t))));
        }
        v[j][e] = __fmul_rn(y, inv_s[j][e]);  // 0 past C: inv_s is 0
        amax = fmaxf(amax, fabsf(v[j][e]));
      }
    }
    amax = warp_max(amax);
    const float r = __fmul_rn(fmaxf(amax, 1e-6f), kInv127);
    const float inv_r = __frcp_rn(r);
    int8_t* qr = q + static_cast<size_t>(row) * c;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      if (!live[j]) continue;
      uint32_t word[kVec / 4];
#pragma unroll
      for (int i = 0; i < kVec / 4; ++i)
        word[i] = quantize(v[j][4 * i], inv_r) |
                  (quantize(v[j][4 * i + 1], inv_r) << 8) |
                  (quantize(v[j][4 * i + 2], inv_r) << 16) |
                  (quantize(v[j][4 * i + 3], inv_r) << 24);
      int8_t* dst = qr + (32 * j + lane) * kVec;
      if constexpr (kVec == 8) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(word[0], word[1]);
      } else {
        *reinterpret_cast<uint32_t*>(dst) = word[0];
      }
    }
    if (lane == 0) r_out[row] = r;
  }
}

// Blocks of rows_kernel<T, kLoads> the card holds at once, cached.
template <typename T, int kLoads>
cudaError_t resident_blocks(int* blocks) {
  static int cached = 0;
  if (cached == 0) {
    int per_sm = 0, sms = 0, dev = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rows_kernel<T, kLoads>, kWarps * 32, 0);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    cached = per_sm * sms;
  }
  *blocks = cached;
  return cudaSuccess;
}

template <typename T, int kLoads>
cudaError_t launch_rows(const void* x, const void* s, void* q, void* r,
                        int rows, int c, int op, float eps,
                        cudaStream_t stream) {
  int blocks = 0;
  const cudaError_t err = resident_blocks<T, kLoads>(&blocks);
  if (err != cudaSuccess) return err;
  const int needed = (rows + kWarps - 1) / kWarps;
  rows_kernel<T, kLoads><<<needed < blocks ? needed : blocks, kWarps * 32, 0,
                           stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(s),
      static_cast<int8_t*>(q), static_cast<float*>(r), rows, c, op, eps);
  return cudaGetLastError();
}

// The design by C: registers up to kRegisterC (whole 16-byte pieces), the
// staged kernel past it.
template <typename T>
cudaError_t launch(const void* x, const void* s, void* q, void* r, int rows,
                   int c, int op, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int loads = (c / kVec + 31) / 32;  // 16-byte pieces a lane
  if (c > kRegisterC || c % kVec)
    return launch_staged<T>(x, s, q, r, rows, c, op, eps, stream);
  switch (loads) {
    case 1:
      return launch_rows<T, 1>(x, s, q, r, rows, c, op, eps, stream);
    case 2:
      return launch_rows<T, 2>(x, s, q, r, rows, c, op, eps, stream);
    case 3:
      return launch_rows<T, 3>(x, s, q, r, rows, c, op, eps, stream);
    case 4:
      return launch_rows<T, 4>(x, s, q, r, rows, c, op, eps, stream);
    default:  // f32: 5 to 8 pieces
      return launch_rows<T, kRegisterC / 32 / kVec>(x, s, q, r, rows, c, op,
                                                    eps, stream);
  }
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
